"""The float64 precision path of the port (xrft_tpu_torch/highprec.py):
``engine="hp"`` through fft, ifft, power_spectrum, cross_spectrum,
cross_phase and isotropic_power_spectrum, and fft64/ifft64, held against
xrft_tpu's native hp path (x64 on this CPU, as tests/conftest.py sets it)
and against float64 numpy oracles, under both fft_impl values: "torch"
(torch.fft in complex128) and "kernel" (the K4 recursion's plain version on
the CPU).  The cases mirror tests/test_hp_native.py and
tests/test_hp_pipeline.py.

Tolerance: 1e-12 relative to the max of the reference, for every
comparison; both sides compute in float64.
"""

import warnings

import numpy as np
import numpy.testing as npt
import pytest
import scipy.signal as sps

torch = pytest.importorskip("torch")

import xrft_tpu
import xrft_tpu_torch as xt
from xrft_tpu_torch.config import fft_impl
from xrft_tpu_torch.interop import from_reference

TOL = 1e-12
IMPLS = ["torch", "kernel"]


def _da(N=64, seed=0, dx=0.5, shape=None, dtype=np.float32, name=None):
    rng = np.random.RandomState(seed)
    shape = shape or (N, N)
    dims = ("y", "x") if len(shape) == 2 else ("time", "y", "x")
    coords = {"y": np.arange(shape[-2]) * dx, "x": np.arange(shape[-1]) * dx}
    return xrft_tpu.LabeledArray(rng.randn(*shape).astype(dtype), dims=dims,
                                 coords=coords, name=name)


def _rel(got, ref):
    ref = np.asarray(ref)
    return np.abs(np.asarray(got) - ref).max() / np.abs(ref).max()


def _assert_matches(got, ref, tol=TOL):
    """Port result against an xrft_tpu result: dims, name, coords with
    attrs, dtype and values; the reference also carried across through
    interop.from_reference."""
    assert got.dims == ref.dims
    assert got.name == ref.name
    assert set(got.coords) == set(ref.coords)
    for c in ref.coords:
        npt.assert_array_equal(got.coords[c].values, ref.coords[c].values)
        assert got.coords[c].attrs.keys() == ref.coords[c].attrs.keys()
        for k, v in ref.coords[c].attrs.items():
            npt.assert_array_equal(got.coords[c].attrs[k], v)
    r = np.asarray(ref.values)
    assert got.values.dtype == r.dtype
    assert _rel(got.values, r) <= tol
    carried = from_reference(ref, device="cpu")
    assert carried.dtype == got.dtype and carried.dims == got.dims
    assert _rel(got.data, carried.data) <= tol


def _run(fn, *args, **kw):
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        out = fn(*args, **kw)
    return out, [(w.category, str(w.message)) for w in caught]


def _both(impl, name, *arrays, **kw):
    """xrft_tpu.<name> and xrft_tpu_torch.<name> on the same inputs, with
    their warnings, which must agree."""
    ref, ref_warn = _run(getattr(xrft_tpu, name), *arrays, **kw)
    with fft_impl(impl):
        got, got_warn = _run(getattr(xt, name),
                             *[from_reference(a, device="cpu") for a in arrays], **kw)
    assert got_warn == ref_warn
    return got, ref


def _psd_oracle(v, N, dx):
    """bench.py's closed form: linear detrend, hann window, density PSD."""
    i = np.arange(N) - (N - 1) / 2
    vm = v - v.mean()
    a1 = (vm * i[:, None]).sum() / ((i**2).sum() * N)
    a2 = (vm * i[None, :]).sum() / ((i**2).sum() * N)
    vd = vm - a1 * i[:, None] - a2 * i[None, :]
    w = sps.windows.hann(N, sym=False)
    F = np.fft.fftshift(np.fft.fftn(vd * (w[:, None] * w[None, :]))) * dx**2
    return np.abs(F) ** 2 * (1.0 / (N * dx)) ** 2


@pytest.mark.parametrize("impl", IMPLS)
def test_psd_windowed_detrended(impl):
    N, dx = 64, 0.5
    da = _da(N)
    got, ref = _both(impl, "power_spectrum", da, dim=["y", "x"],
                     window="hann", detrend="linear", engine="hp")
    assert got.dtype == torch.float64
    _assert_matches(got, ref)
    assert _rel(got.values, _psd_oracle(da.values.astype(np.float64), N,
                                        dx)) < TOL


@pytest.mark.parametrize("impl", IMPLS)
@pytest.mark.parametrize("kw", [
    dict(scaling="density"), dict(scaling="spectrum"),
    dict(scaling="false_density"),
    dict(window="hann", window_correction=True),
    dict(window="hann", window_correction=True, scaling="spectrum"),
    dict(detrend="constant", true_amplitude=False),
    dict(real_dim="x", window="hann"),
    dict(real_dim="y", detrend="linear"),
    dict(dim="x", shift=False),
    dict(dim=None),
])
def test_psd_variants(impl, kw):
    """The three scalings, window_correction, true_amplitude left to the
    caller, real_dim on either axis, one dim, all dims; a (3, 48, 40)
    stack, an odd-sized (45, 33) field."""
    kw = dict(dict(dim=["y", "x"]), **kw)
    for da in (_da(shape=(3, 48, 40), seed=1), _da(shape=(45, 33), seed=2,
                                                   dtype=np.float64)):
        if kw["dim"] is None and da.values.ndim == 3:
            continue
        got, ref = _both(impl, "power_spectrum", da, engine="hp", **kw)
        _assert_matches(got, ref)


@pytest.mark.parametrize("impl", IMPLS)
def test_psd_rejects_like_reference(impl):
    da = _da(16)
    for fn, arr in ((xrft_tpu.power_spectrum, da),
                    (xt.power_spectrum, from_reference(da, device="cpu"))):
        with fft_impl(impl):
            with pytest.raises(ValueError, match="window_correction"):
                fn(arr, dim=["y", "x"], window_correction=True, engine="hp")
            with pytest.raises(ValueError, match="Unknown"):
                fn(arr, dim=["y", "x"], scaling="nope", engine="hp")


@pytest.mark.parametrize("impl", IMPLS)
@pytest.mark.parametrize("kw", [
    dict(dim=["y", "x"], window="hann", window_correction=True),
    dict(dim=["y"], real_dim="y"),
    dict(dim=["y", "x"], true_phase=False, scaling="spectrum"),
    dict(dim=["y", "x"], detrend="linear"),
])
def test_cross_spectrum_and_phase(impl, kw):
    N, dx = 48, 0.25
    da1, da2 = _da(N, seed=7, dx=dx, name="a"), _da(N, seed=8, dx=dx,
                                                    name="b")
    got, ref = _both(impl, "cross_spectrum", da1, da2, engine="hp", **kw)
    assert got.dtype == torch.complex128 and got.name == "a_b"
    _assert_matches(got, ref)
    # the phase is ill-conditioned where |cs| ~ 0, and +pi == -pi on the
    # branch cut: compare the wrapped difference where |cs| is significant
    # (1e-12 relative in cs is at most 1e-9 rad there)
    cs = ref.values
    got, ref = _both(impl, "cross_phase", da1, da2, engine="hp", **kw)
    assert got.dims == ref.dims and got.name == ref.name == "a_b_phase"
    mask = np.abs(cs) > 1e-3 * np.abs(cs).max()
    dphi = np.angle(np.exp(1j * (got.values - ref.values)))
    assert np.abs(dphi[mask]).max() < 1e-9


@pytest.mark.parametrize("impl", IMPLS)
def test_cross_spectrum_matches_numpy(impl):
    """test_hp_native.py's oracle: windowed, window-corrected, true phase."""
    N, dx = 48, 0.25
    da1, da2 = _da(N, seed=7, dx=dx), _da(N, seed=8, dx=dx)
    with fft_impl(impl):
        cs = xt.cross_spectrum(from_reference(da1, device="cpu"), from_reference(da2, device="cpu"),
                               dim=["y", "x"], engine="hp", window="hann",
                               window_correction=True)
    w = sps.windows.hann(N, sym=False)
    w2 = w[:, None] * w[None, :]
    lag = [da1.coords[d].values[N // 2] for d in ("y", "x")]
    fs = np.fft.fftshift(np.fft.fftfreq(N, dx))

    def F(v):
        out = np.fft.fftshift(np.fft.fftn(
            np.fft.ifftshift(np.asarray(v, np.float64) * w2))) * dx**2
        return out * np.exp(-2j * np.pi * (fs[:, None] * lag[0]
                                           + fs[None, :] * lag[1]))

    ref = F(da1.values) * np.conj(F(da2.values))
    ref = ref / np.mean(w2**2) * (1.0 / (N * dx)) ** 2
    assert _rel(cs.values, ref) < TOL


@pytest.mark.parametrize("impl", IMPLS)
@pytest.mark.parametrize("kw", [
    dict(dim="x"),
    dict(dim=["y", "x"], real_dim="x"),
    dict(dim=["y", "x"], real_dim="y", true_phase=False,
         true_amplitude=False),
    dict(dim=["y", "x"], shift=False, detrend="linear", window="hann"),
])
def test_fft_hp(impl, kw):
    da = _da(shape=(48, 40), seed=3)
    da = da.assign_coords(y=da.coords["y"].values[::-1] - 4.0)
    got, ref = _both(impl, "fft", da, engine="hp", **kw)
    assert got.dtype == torch.complex128
    _assert_matches(got, ref)


@pytest.mark.parametrize("impl", IMPLS)
def test_rfft_hp_vs_numpy(impl):
    """test_hp_native.py: the one-sided hp transform with the true_phase
    ifftshift and lag phase, against np.fft.rfftn in float64."""
    N, dx = 64, 0.5
    da = _da(N, seed=3, dx=dx)
    with fft_impl(impl):
        ft = xt.fft(from_reference(da, device="cpu"), dim=["y", "x"], real_dim="x",
                    engine="hp")
    v = np.asarray(da.values, np.float64)
    lag_y, lag_x = da.coords["y"].values[N // 2], da.coords["x"].values[N // 2]
    F = np.fft.rfftn(np.fft.ifftshift(v)) * dx * dx
    fy, fx = np.fft.fftfreq(N, dx), np.fft.rfftfreq(N, dx)
    F = F * np.exp(-2j * np.pi * (fy[:, None] * lag_y + fx[None, :] * lag_x))
    npt.assert_allclose(ft.values, F, rtol=0, atol=TOL * np.abs(F).max())


@pytest.mark.parametrize("impl", IMPLS)
@pytest.mark.parametrize("real", [False, True])
def test_fft_ifft_hp_roundtrip(impl, real):
    """fft then ifft, both engine="hp", gives the float32 field back at
    float64 grade (bench.py's hp roundtrip, test_hp_native.py)."""
    N = 96
    rng = np.random.RandomState(1)
    da = xrft_tpu.LabeledArray(rng.randn(3, N).astype(np.float32),
                               dims=("b", "t"),
                               coords={"t": np.arange(N) * 0.25})
    kw = dict(dim="t", real_dim="t") if real else dict(dim="t")
    with fft_impl(impl):
        ft = xt.fft(from_reference(da, device="cpu"), engine="hp", **kw)
    ref_ft = xrft_tpu.fft(da, engine="hp", **kw)
    _assert_matches(ft, ref_ft)
    ikw = dict(dim="freq_t", engine="hp",
               lag=float(da.coords["t"].values[N // 2]))
    if real:
        ikw["real_dim"] = "freq_t"
    with fft_impl(impl):
        back, warn = _run(xt.ifft, ft, **ikw)
    ref_back = xrft_tpu.ifft(ref_ft, **ikw)
    assert warn == []
    assert back.dtype == (torch.float64 if real else torch.complex128)
    _assert_matches(back, ref_back)
    npt.assert_allclose(back.values.real, da.values.astype(np.float64),
                        rtol=0, atol=1e-13)


@pytest.mark.parametrize("shape", [(8, 16), (6, 10)])
@pytest.mark.parametrize("tp,sh", [(False, False), (True, False),
                                   (False, True), (True, True)])
def test_ifft_hp_real_dim_flag_combos(shape, tp, sh):
    """test_hp_pipeline.py's flag combinations, under both fft_impl values,
    against xrft_tpu's hp and float64 paths."""
    Ny, Nx = shape
    v = np.random.RandomState(5).randn(Ny, Nx)
    daft = xrft_tpu.LabeledArray(
        np.fft.rfftn(v), dims=("freq_y", "freq_x"),
        coords={"freq_y": np.fft.fftfreq(Ny, 1.0),
                "freq_x": np.fft.rfftfreq(Nx, 1.0)})
    kw = dict(dim=["freq_y", "freq_x"], real_dim="freq_x", true_phase=tp,
              shift=sh, true_amplitude=False, lag=[0.0, 0.0])
    plain = np.asarray(xrft_tpu.ifft(daft, **kw).values) \
        if tp else None
    for impl in IMPLS:
        got, ref = _both(impl, "ifft", daft, engine="hp", **kw)
        assert got.dtype == torch.float64
        _assert_matches(got, ref)
        if plain is not None:
            npt.assert_allclose(got.values, plain, rtol=0, atol=1e-12)


@pytest.mark.parametrize("impl", IMPLS)
@pytest.mark.parametrize("lag", [None, [0.0, 0.0], [None, 1.5]])
@pytest.mark.parametrize("true_phase", [True, False])
def test_ifft_hp_lags_warnings_and_spacing(impl, lag, true_phase):
    """ifft_hp warns about lag=None only where a phase with a non-zero lag
    is applied, copies each frequency coordinate's spacing attr to its
    output coordinate, and keeps the name; all as xrft_tpu."""
    da = _da(shape=(48, 40), seed=4, name="eta")
    F = xrft_tpu.fft(da, dim=["y", "x"], engine="hp")
    for src in (F, F.assign_coords(
            freq_y=F.coords["freq_y"].copy(attrs={"spacing": 0.04}),
            freq_x=F.coords["freq_x"].copy(attrs={}))):
        got, ref = _both(impl, "ifft", src, dim=["freq_y", "freq_x"],
                         engine="hp", lag=lag, true_phase=true_phase)
        _assert_matches(got, ref)
        assert got.name == "eta"


@pytest.mark.parametrize("impl", IMPLS)
def test_fft64_parity_parseval_and_roundtrip(impl):
    """test_df64_fft.py: numpy parity, amplitude-true Parseval, the
    roundtrip, and 2-D complex input."""
    rng = np.random.RandomState(4)
    Nx, dx = 120, 0.37
    x = dx * (np.arange(Nx) - 17)
    sig = rng.randn(Nx).astype(np.float32)
    da = xrft_tpu.LabeledArray(sig, dims=["x"], coords={"x": x}, name="s")
    F, ref = _both(impl, "fft64", da, dim="x")
    assert F.dtype == torch.complex128
    _assert_matches(F, ref)
    lag = x[Nx // 2]
    f = np.fft.fftfreq(Nx, dx)
    want = np.fft.fftshift(np.fft.fft(np.fft.ifftshift(sig.astype(np.float64)))
                           * np.exp(-2j * np.pi * f * lag) * dx)
    npt.assert_allclose(F.values, want, rtol=1e-12, atol=1e-12)
    npt.assert_allclose(
        (np.abs(F.values) ** 2).sum() * F.coords["freq_x"].attrs["spacing"],
        (sig.astype(np.float64) ** 2).sum() * dx, rtol=1e-12)

    back, ref_back = _both(impl, "ifft64", ref, lag=lag)
    assert back.dtype == torch.complex128
    _assert_matches(back, ref_back)
    npt.assert_allclose(back.values.real, sig, rtol=0, atol=1e-12)
    npt.assert_allclose(back.coords["x"].values, x, rtol=0, atol=1e-10)

    z = rng.randn(24, 32) + 1j * rng.randn(24, 32)
    dz = xrft_tpu.LabeledArray(z, dims=["y", "x"],
                               coords={"y": np.arange(24.0),
                                       "x": np.arange(32.0)})
    Fz, ref_z = _both(impl, "fft64", dz, true_phase=False,
                      true_amplitude=False, shift=False)
    _assert_matches(Fz, ref_z)
    npt.assert_allclose(Fz.values, np.fft.fftn(z), rtol=1e-12, atol=1e-12)


@pytest.mark.parametrize("impl", IMPLS)
@pytest.mark.parametrize("order", ["natural", "permuted"])
def test_ifft64_sorts_before_the_centering_check(impl, order):
    rng = np.random.RandomState(6)
    n = 40
    f = np.fft.fftfreq(n, 0.5)
    perm = np.arange(n) if order == "natural" else rng.permutation(n)
    daft = xrft_tpu.LabeledArray(
        rng.randn(3, n) + 1j * rng.randn(3, n), dims=("b", "freq_x"),
        coords={"freq_x": (("freq_x",), f[perm], {"direct_lag": 2.0})})
    for kw in (dict(), dict(shift=False, true_phase=False, lag=1.0)):
        got, ref = _both(impl, "ifft64", daft, dim="freq_x", **kw)
        _assert_matches(got, ref)
    off = daft.assign_coords(freq_x=(("freq_x",), f[perm] + 0.01))
    for fn, arr in ((xrft_tpu.ifft64, off), (xt.ifft64, from_reference(off, device="cpu"))):
        with pytest.raises(ValueError, match="not centered"):
            fn(arr, dim="freq_x")


@pytest.mark.parametrize("impl", IMPLS)
def test_isotropic_hp_conservation(impl):
    """test_hp_pipeline.py: the isotropic hp PSD's bin sums conserve the
    hp PSD's total at float64 grade; the port's float64 binned sum agrees
    with xrft_tpu's compensated one."""
    da = _da(shape=(2, 64, 64), seed=7, dx=1.0)
    ps, _ = _both(impl, "power_spectrum", da, dim=["y", "x"], engine="hp")
    for truncate in (False, True):
        iso, ref = _both(impl, "isotropic_power_spectrum", da,
                         dim=["y", "x"], truncate=truncate, engine="hp",
                         window="hann", detrend="linear")
        assert iso.dtype == torch.float64
        _assert_matches(iso, ref)
    iso, _ = _both(impl, "isotropic_power_spectrum", da, dim=["y", "x"],
                   truncate=False, engine="hp")
    tot_ps = ps.data.sum(dim=(1, 2))
    tot_iso = iso.data.sum(dim=1)
    assert ((tot_iso - tot_ps).abs() / tot_ps).max().item() < 1e-12


def test_hp_segments_and_other_engines_raise():
    da = from_reference(_da(16), device="cpu")
    # hp segments are ported: without declared chunks they refuse as
    # xrft_tpu does, and an overlap needs chunks_to_segments
    for pkg, arr in ((xt, da), (xrft_tpu, _da(16))):
        with pytest.raises(ValueError, match="requires declared chunks"):
            pkg.power_spectrum(arr, dim="x", engine="hp",
                               chunks_to_segments=True)
        with pytest.raises(ValueError, match="requires declared chunks"):
            pkg.fft(arr, dim="x", engine="hp", chunks_to_segments=True)
        with pytest.raises(ValueError, match="requires chunks_to_segments"):
            pkg.fft(arr, dim="x", engine="hp", segment_overlap=2)
    with pytest.raises(ValueError, match="requires declared chunks"):
        xt.ifft(xt.fft(da, dim="x"), dim="freq_x", engine="hp", lag=0.0,
                chunks_to_segments=True)
    # the other engine names run, with xrft_tpu's values (float32 data:
    # 2e-6 of the largest value); an unknown one raises
    for engine in ("xla", "matmul"):
        for name in ("power_spectrum", "fft"):
            want = getattr(xrft_tpu, name)(_da(16), dim="x",
                                           engine=engine).values
            got = getattr(xt, name)(da, dim="x", engine=engine).values
            assert np.abs(got - want).max() <= 2e-6 * np.abs(want).max()
    with pytest.raises(ValueError, match="Unknown fft engine"):
        xt.fft(da, dim="x", engine="bogus")
