"""The matmul FFT engine of xrft_tpu_torch (ops/matmul_fft.py: the stacked
engine first, then the pair engine's four-step recursion, Bluestein and the
packed rfft/irfft) against numpy and against xrft_tpu's matmul engine on the
CPU, case for case as ``tests/test_matmul_fft.py``.

The same seeded numpy input goes through ``xrft_tpu.ops.matmul_fft`` (x64,
as ``conftest.py`` sets it up) and the port on CPU tensors, where K2's
four-step levels run its plain version.  Tolerances, of max|ref|: 1e-11 in
complex128 (1e-12 for the short inverses, as the JAX tests) and 2e-6 in
complex64 against numpy float64.  The port against xrft_tpu: 1e-11 and
2e-6.
"""

import numpy as np
import numpy.testing as npt
import pytest

torch = pytest.importorskip("torch")

import xrft_tpu
from xrft_tpu.config import config as ref_config
from xrft_tpu.config import fft_engine
from xrft_tpu.ops import matmul_fft as ref_mm
from xrft_tpu_torch.config import fft_impl
from xrft_tpu_torch.ops import fft_core, fft_fourstep, matmul_fft, stacked_fft
from xrft_tpu_torch.ops.matmul_fft import fft_last, matmul_fft_nd

from torch_parity import assert_same, pair

import xrft_tpu_torch as xt

SIZES = [1, 2, 3, 4, 8, 12, 16, 30, 64, 97, 100, 128, 127, 210, 256, 512,
         513, 1000, 1024, 2048, 4096, 5003]


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


def _close(got, ref, atol):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    ref = np.asarray(ref)
    scale = max(np.abs(ref).max(), 1.0)
    npt.assert_allclose(got / scale, ref / scale, atol=atol)


def _agree(got, x, *args, atol, fn="matmul_fft_nd"):
    """The port's ``got`` against xrft_tpu's ``fn`` on the same input."""
    ref = np.asarray(getattr(ref_mm, fn)(np.asarray(x), *args))
    _close(got, ref, atol)


@pytest.mark.parametrize("n", SIZES)
def test_fft_last_matches_numpy_c128(n):
    rng = np.random.RandomState(n)
    x = rng.randn(n) + 1j * rng.randn(n)
    got = fft_last(_t(x))
    assert got.dtype == torch.complex128
    _close(got, np.fft.fft(x), 1e-11)
    _agree(got, x, atol=1e-11, fn="fft_last")


@pytest.mark.parametrize("n", [8, 100, 128, 512, 1024, 4096])
def test_fft_last_c64_accuracy(n):
    rng = np.random.RandomState(n)
    x = (rng.randn(n) + 1j * rng.randn(n)).astype(np.complex64)
    got = fft_last(_t(x))
    assert got.dtype == torch.complex64
    ref = np.fft.fft(x.astype(np.complex128))
    npt.assert_allclose(got.numpy() / np.abs(ref).max(),
                        ref / np.abs(ref).max(), atol=2e-6)
    _agree(got, x, atol=2e-6, fn="fft_last")


@pytest.mark.parametrize("n", [16, 24, 100, 127, 128])
def test_ifft_roundtrip(n):
    rng = np.random.RandomState(n)
    x = rng.randn(5, n) + 1j * rng.randn(5, n)
    f = matmul_fft_nd(_t(x), [-1], "fft")
    back = matmul_fft_nd(f, [-1], "ifft")
    npt.assert_allclose(back.numpy(), x, atol=1e-10)
    _agree(f, x, [-1], "fft", atol=1e-11)


@pytest.mark.parametrize("n", [16, 30, 100, 128, 257])
def test_rfft_matches_numpy(n):
    rng = np.random.RandomState(n)
    x = rng.randn(3, n)
    got = matmul_fft_nd(_t(x), [-1], "rfft")
    ref = np.fft.rfft(x, axis=-1)
    scale = np.abs(ref).max()
    npt.assert_allclose(got.numpy() / scale, ref / scale, atol=1e-11)
    _agree(got, x, [-1], "rfft", atol=1e-11)


@pytest.mark.parametrize("n", [16, 30, 100, 128])
def test_irfft_roundtrip_even(n):
    n = n if n % 2 == 0 else n + 1
    rng = np.random.RandomState(n)
    x = rng.randn(3, n)
    f = matmul_fft_nd(_t(x), [-1], "rfft")
    back = matmul_fft_nd(f, [-1], "irfft")
    assert back.dtype == torch.float64
    npt.assert_allclose(back.numpy(), x, atol=1e-10)
    _agree(back, f.numpy(), [-1], "irfft", atol=1e-11)


@pytest.mark.parametrize("shape,axes", [((5, 16), [1]), ((4, 8, 12), [1, 2]),
                                        ((2, 6, 10), [2]), ((7, 2), [1]),
                                        ((1, 129), [1]),
                                        ((2, 3, 4, 6), [1, 2, 3])])
def test_irfft_nonhermitian_matches_numpy(shape, axes):
    """pocketfft's c2r on input that is not Hermitian: the imaginary parts
    of the DC and Nyquist columns are ignored, the interior taken as given
    (the port's "kernel" route keeps .real of a full transform instead)."""
    rng = np.random.RandomState(sum(shape))
    X = rng.randn(*shape) + 1j * rng.randn(*shape)
    got = matmul_fft_nd(_t(X), axes, "irfft")
    ref = np.fft.irfftn(X, axes=axes)
    scale = max(np.abs(ref).max(), 1e-30)
    npt.assert_allclose(got.numpy() / scale, ref / scale, atol=1e-11)
    _agree(got, X, axes, "irfft", atol=1e-11)


def test_fftn_2d_matches_numpy():
    rng = np.random.RandomState(0)
    x = rng.randn(32, 48) + 1j * rng.randn(32, 48)
    got = matmul_fft_nd(_t(x), [0, 1], "fft")
    _close(got, np.fft.fftn(x), 1e-11)
    _agree(got, x, [0, 1], "fft", atol=1e-11)


def test_fftn_3d_subset_axes():
    rng = np.random.RandomState(1)
    x = rng.randn(4, 16, 24) + 1j * rng.randn(4, 16, 24)
    got = matmul_fft_nd(_t(x), [1, 2], "fft")
    _close(got, np.fft.fftn(x, axes=[1, 2]), 1e-11)
    _agree(got, x, [1, 2], "fft", atol=1e-11)


def test_rfftn_2d_matches_numpy():
    rng = np.random.RandomState(2)
    x = rng.randn(24, 32)
    got = matmul_fft_nd(_t(x), [0, 1], "rfft")
    _close(got, np.fft.rfftn(x), 1e-11)
    _agree(got, x, [0, 1], "rfft", atol=1e-11)


def test_irfftn_2d_roundtrip():
    rng = np.random.RandomState(3)
    x = rng.randn(24, 32)
    f = matmul_fft_nd(_t(x), [0, 1], "rfft")
    back = matmul_fft_nd(f, [0, 1], "irfft")
    npt.assert_allclose(back.numpy(), x, atol=1e-10)
    _agree(back, f.numpy(), [0, 1], "irfft", atol=1e-11)


def test_dispatcher_engines_agree():
    rng = np.random.RandomState(4)
    x = rng.randn(16, 64) + 1j * rng.randn(16, 64)
    with fft_impl("torch"):
        a = fft_core.fftn(_t(x), [0, 1]).numpy()
    with fft_impl("matmul"):
        b = fft_core.fftn(_t(x), [0, 1]).numpy()
    npt.assert_allclose(a, b, atol=1e-10 * np.abs(a).max())
    with fft_engine("matmul"):
        ref = np.asarray(xrft_tpu.ops.fft_core.fftn(x, [0, 1]))
    npt.assert_allclose(b, ref, atol=1e-11 * np.abs(ref).max())


@pytest.mark.parametrize("n", [16, 30, 100, 128, 4096, 97, 27])
def test_absorbed_shifts_match_numpy(n):
    """pre (ifftshift) / post (fftshift) flags match numpy's composition
    for even (absorbed) and odd (explicit roll) sizes."""
    rng = np.random.RandomState(n)
    x = rng.randn(3, n) + 1j * rng.randn(3, n)
    scale = np.abs(np.fft.fft(x, axis=-1)).max()
    cases = [
        (dict(pre_shift=True, post_shift=True), np.fft.fftshift(
            np.fft.fft(np.fft.ifftshift(x, axes=-1), axis=-1), axes=-1)),
        (dict(pre_shift=True), np.fft.fft(np.fft.ifftshift(x, axes=-1),
                                          axis=-1)),
        (dict(post_shift=True), np.fft.fftshift(np.fft.fft(x, axis=-1),
                                                axes=-1)),
    ]
    for kw, ref in cases:
        got = fft_last(_t(x), -1, **kw).numpy()
        npt.assert_allclose(got / scale, ref / scale, atol=1e-11)
        want = np.asarray(ref_mm.fft_last(np.asarray(x), -1, **kw))
        npt.assert_allclose(got / scale, want / scale, atol=1e-11)


@pytest.mark.parametrize("n", [16, 27, 100])
def test_ifft_absorbed_shift_kinds(n):
    """ifft with an absorbed input ifftshift and both output kinds."""
    rng = np.random.RandomState(n)
    x = rng.randn(3, n) + 1j * rng.randn(3, n)
    ref = np.fft.fftshift(
        np.fft.ifft(np.fft.ifftshift(x, axes=-1), axis=-1), axes=-1)
    got = matmul_fft_nd(_t(x), [-1], "ifft", pre_shift_axes=[-1],
                        post_shift_axes=[-1], post_kind="fftshift")
    scale = np.abs(ref).max()
    npt.assert_allclose(got.numpy() / scale, ref / scale, atol=1e-12)
    ref = np.fft.ifftshift(np.fft.ifft(x, axis=-1), axes=-1)
    got = matmul_fft_nd(_t(x), [-1], "ifft", post_shift_axes=[-1],
                        post_kind="ifftshift")
    npt.assert_allclose(got.numpy() / scale, ref / scale, atol=1e-12)
    want = np.asarray(ref_mm.matmul_fft_nd(np.asarray(x), [-1], "ifft",
                                           post_shift_axes=[-1],
                                           post_kind="ifftshift"))
    npt.assert_allclose(got.numpy() / scale, want / scale, atol=1e-12)


# ---------------------------------------------------------------------------
# Beyond the JAX file: K2's step, the stacked route, the slice's calls
# ---------------------------------------------------------------------------


def _spy_k2(monkeypatch):
    """Count the plain-K2 calls the port's engine makes on the CPU."""
    calls = []
    plain = fft_fourstep.fft_last_plain

    def spy(x, sign=-1):
        calls.append(tuple(x.shape))
        return plain(x, sign)
    monkeypatch.setattr(fft_fourstep, "fft_last_plain", spy)
    return calls


@pytest.mark.parametrize("complex_in", [False, True])
def test_k2_step_against_pallas_interpret(monkeypatch, complex_in):
    """n = 512, float32 rows: xrft_tpu's pair engine with
    ``pallas_fft = "always"`` runs its Pallas K2 in interpret mode, the port
    K2's plain version (the kernel's tables and digit order)."""
    rng = np.random.RandomState(512)
    x = rng.randn(16, 512).astype(np.float32)
    if complex_in:
        x = (x + 1j * rng.randn(16, 512)).astype(np.complex64)
    calls = _spy_k2(monkeypatch)
    got = fft_last(_t(x), +1 if complex_in else -1)
    assert calls == [(16, 512)]
    old = ref_config.pallas_fft
    ref_config.pallas_fft = "always"
    try:
        want = np.asarray(ref_mm.fft_last(np.asarray(x),
                                          +1 if complex_in else -1))
    finally:
        ref_config.pallas_fft = old
    assert got.dtype == torch.complex64
    _close(got, want, 2e-6)
    ref = np.fft.fft(x.astype(np.complex128), axis=-1)
    if complex_in:
        ref = np.fft.ifft(x.astype(np.complex128), axis=-1) * 512
    _close(got, ref, 2e-6)


def test_k2_step_skips_shifted_levels_and_float64(monkeypatch):
    """A shifted level stays in the einsum recursion (its shift is absorbed
    or rolled there), and float64 never reaches K2."""
    calls = _spy_k2(monkeypatch)
    x = np.random.RandomState(5).randn(4, 1024)
    fft_last(_t(x), -1, True, True)
    fft_last(_t(x))
    assert calls == []
    fft_last(_t(x.astype(np.float32)), -1, True, True)
    # 1024 = 128 x 8: both shifts absorbed at the outer level; 8 is direct
    assert calls == []
    fft_last(_t(x.astype(np.float32)))
    assert calls == [(4, 1024)]


@pytest.mark.parametrize("kind,shape,axes,pre,post", [
    ("fft", (6, 64, 48), [1, 2], (1, 2), (1, 2)),
    ("ifft", (6, 64, 48), [1, 2], (), (1,)),
    ("rfft", (6, 64, 48), [1, 2], (), ()),
    ("fft", (3, 256), [1], (), ()),
])
@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_stacked_requests_keep_their_route(kind, shape, axes, pre, post,
                                           dtype):
    """A request the stacked engine plans gives, through ``fft_core`` under
    "matmul" and through :func:`matmul_fft_nd`, the same tensor bit for bit
    as :func:`stacked_fft.fft_nd_stacked` called directly."""
    rng = np.random.RandomState(7)
    x = rng.randn(*shape).astype(dtype)
    if kind != "rfft":
        x = x + 1j * rng.randn(*shape).astype(dtype)
    x = _t(x)
    assert stacked_fft.stacked_supported(x, axes, kind, pre, post)
    want = stacked_fft.fft_nd_stacked(x, axes, kind, pre, post)
    got = matmul_fft_nd(x, axes, kind, pre, post)
    fn = {"fft": fft_core.fftn, "ifft": fft_core.ifftn,
          "rfft": fft_core.rfftn}[kind]
    with fft_impl("matmul"):
        via_core = fn(x, axes, pre_shift_axes=pre, post_shift_axes=post)
    assert torch.equal(got, want) and torch.equal(via_core, want)


def test_direct_stacked_call_still_raises():
    x = torch.randn(2, 131, dtype=torch.float64)
    assert not stacked_fft.stacked_supported(x, [1], "fft", (), ())
    with pytest.raises(NotImplementedError, match="prime factor above"):
        stacked_fft.fft_nd_stacked(x, [1], "fft")
    with pytest.raises(NotImplementedError, match="irfft"):
        stacked_fft.fft_nd_stacked(x.to(torch.complex128), [1], "irfft")


# ---------------------------------------------------------------------------
# The slice's calls at a small size, against xrft_tpu under "matmul"
# ---------------------------------------------------------------------------

GRID = (2, 13 * 157, 96)   # lat = 2041 = 13 x 157, as GLORYS12's grid


def _grid_pair(dtype=np.float32):
    rng = np.random.RandomState(41)
    _, nlat, nlon = GRID
    return pair(rng.randn(*GRID).astype(dtype), ["time", "lat", "lon"],
                {"lat": np.linspace(-80.0, 90.0, nlat),
                 "lon": np.arange(nlon) * (1.0 / 12)})


def test_slice_psd_of_a_glorys_grid(monkeypatch):
    """Leg B: the windowed, detrended PSD over (lat, lon): no plan for 157,
    so the pair engine runs it: the packed rfft along lon (48 points,
    direct), then lat 2041 = 157 x 13 on K2."""
    ref, da = _grid_pair()
    calls = _spy_k2(monkeypatch)
    kw = dict(dim=["lat", "lon"], window="hann", detrend="linear")
    with fft_impl("matmul"):
        got = xt.power_spectrum(da, **kw)
    assert calls == [(2, 49, 2041)]
    with fft_engine("matmul"):
        want = xrft_tpu.power_spectrum(ref, **kw)
    assert_same(got, want, 2e-6)


def test_slice_fft_of_a_glorys_grid(monkeypatch):
    """Leg C: ``fft`` with xrft's default shifts: lat 2041 = 13 x 157 takes
    explicit rolls (13 and 157 are odd) and Bluestein at 157 (m = 512, K2
    twice); lon 96 absorbs both shifts."""
    ref, da = _grid_pair()
    calls = _spy_k2(monkeypatch)
    with fft_impl("matmul"):
        got = xt.fft(da, dim=["lat", "lon"])
    assert calls == [(2, 96, 13, 512), (2, 96, 13, 512)]
    with fft_engine("matmul"):
        want = xrft_tpu.fft(ref, dim=["lat", "lon"])
    assert_same(got, want, 2e-6)


@pytest.mark.parametrize("order", ["shifted", "natural"])
def test_slice_inverse_flagship(order):
    """Leg A at (2, 64, 33): ifft with real_dim, the stacked inverse along
    freq_y then the packed half-length inverse; against xrft_tpu under
    "matmul" and against the port's cuFFT route."""
    rng = np.random.RandomState(33)
    F = np.fft.rfftn(rng.randn(2, 64, 64), axes=(1, 2)).astype(np.complex64)
    fy = np.fft.fftfreq(64, 0.5)
    if order == "shifted":
        F, fy = np.fft.fftshift(F, axes=1), np.fft.fftshift(fy)
    ref, da = pair(F, ["time", "freq_y", "freq_x"],
                   {"freq_y": fy, "freq_x": np.fft.rfftfreq(64, 0.5)})
    kw = dict(dim=["freq_y", "freq_x"], real_dim="freq_x", shift=False,
              lag=None, true_phase=False, true_amplitude=False)
    with fft_impl("matmul"):
        got = xt.ifft(da, **kw)
    with fft_engine("matmul"):
        want = xrft_tpu.ifft(ref, **kw)
    assert got.data.dtype == torch.float32
    assert_same(got, want, 2e-6)
    with fft_impl("torch"):
        cufft = xt.ifft(da, **kw)
    assert np.abs(got.values - cufft.values).max() <= \
        2e-6 * np.abs(cufft.values).max()


def test_engine_constants_are_cached_per_device():
    """The host constants are built once and the device copies kept per
    (constant, part, dtype, device)."""
    a = matmul_fft._const(matmul_fft._twiddle_np, (13, 157, -1), None,
                          torch.float32, torch.device("cpu"))
    b = matmul_fft._const(matmul_fft._twiddle_np, (13, 157, -1), None,
                          torch.float32, torch.device("cpu"))
    assert a is b and a.dtype == torch.complex64 and a.shape == (13, 157)
    assert stacked_fft._dft_matrix_np is matmul_fft._dft_matrix_np
    assert stacked_fft._twiddle_np is matmul_fft._twiddle_np


@pytest.mark.parametrize("post_kind", ["fftshift", "ifftshift"])
@pytest.mark.parametrize("shape", [(3, 7, 9), (3, 6, 11), (2, 254, 17)])
def test_irfft_output_shifts(shape, post_kind):
    """irfft with output shifts on every axis: the real axis's shift is an
    m/2 roll of the packed transform when n % 4 == 0 (n = 16) and an
    explicit one otherwise (n = 20, 32); 254 plans as (2, 127), whose odd
    outer radix cannot absorb the shift, so the pair engine rolls it."""
    rng = np.random.RandomState(shape[1])
    X = rng.randn(*shape) + 1j * rng.randn(*shape)
    axes = [1, 2]
    got = matmul_fft_nd(_t(X), axes, "irfft", pre_shift_axes=[1],
                        post_shift_axes=axes, post_kind=post_kind)
    shift = np.fft.fftshift if post_kind == "fftshift" else np.fft.ifftshift
    ref = shift(np.fft.irfftn(np.fft.ifftshift(X, axes=1), axes=axes),
                axes=axes)
    _close(got, ref, 1e-11)
    want = ref_mm.matmul_fft_nd(np.asarray(X), axes, "irfft", [1], axes,
                                post_kind)
    _close(got, want, 1e-11)
