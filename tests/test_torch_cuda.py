"""The CUDA kernels of xrft_tpu_torch against their plain versions, on the
card.  Every test here needs an NVIDIA GPU and skips without one (marker
``cuda``).  The file imports neither JAX nor xrft_tpu, so it runs where only
torch is installed, without the JAX-configuring conftest:

    python -m pytest --noconftest -p no:cacheprovider -m cuda -q tests/test_torch_cuda.py
"""

import importlib
import warnings

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from xrft_tpu_torch import (LabeledArray, convolve, czt, dct, dctn, fft,
                            fftconvolve, fht, hilbert, idct, ifft,
                            isotropic_cross_spectrum,
                            isotropic_power_spectrum, oaconvolve, pad,
                            power_spectrum, resample, resample_poly, welch,
                            zoom_fft)
from xrft_tpu_torch.config import (binned_sum_impl, fft_impl, full_fp32,
                                   level0_impl, psd_mirror_impl)
from xrft_tpu_torch.ops import (binning, dft64, dot, fft_core, fft_fourstep,
                                mirror, prologue)

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _rel(a, b):
    return ((a - b).abs().max() / b.abs().max()).item()


@pytest.mark.parametrize("dtype", [torch.complex64, torch.complex128])
@pytest.mark.parametrize("shape,nx", [
    ((2, 7, 5), 9), ((1, 6, 6), 10), ((1, 6, 8), 10), ((3, 64, 40), 78),
    ((2, 1, 3), 1), ((3, 2, 3), 2), ((3, 3, 4), 3), ((2, 4, 4), 3),
    ((3, 5, 4), 2),
    ((2, 3, 4099), 8193),   # several column chunks a row, odd NX
])
@pytest.mark.parametrize("shift", [True, False])
def test_mirror_kernel_matches_plain(cuda, shape, nx, shift, dtype):
    """K1 bit for bit against its plain version: any NY and NX, odd or
    even, MH beyond NX//2 + 1, odd NY with B > 1, rows whose 16-byte
    alignment alternates (odd MH, odd NX)."""
    g = torch.Generator(device=cuda).manual_seed(nx)
    F = torch.randn(shape, generator=g, device=cuda, dtype=dtype)
    before = mirror.mirror_psd.launches
    got = mirror.mirror_psd(F, nx, shift, 0.37)
    assert mirror.mirror_psd.launches == before + 1
    ref = mirror.mirror_psd_plain(F, nx, shift, 0.37)
    torch.cuda.synchronize()
    assert got.dtype == ref.dtype and got.shape == ref.shape
    assert torch.equal(got, ref)


@pytest.mark.parametrize("sign", [-1, 1])
@pytest.mark.parametrize("cplx", [False, True])
@pytest.mark.parametrize("n,rows", [(256, 8), (1000, 8), (1004, 8),
                                    (4096, 64), (65536, 2)])
def test_fourstep_kernel_matches_plain_and_cufft(cuda, n, rows, cplx, sign):
    """K2 in one launch (n <= 8192; 1004 = 251 x 4 takes the direct prime
    stage) and in two passes (65536), against its plain version and cuFFT
    in complex128; two runs are bit for bit the same."""
    g = torch.Generator(device=cuda).manual_seed(n)
    x = torch.randn((rows, n), generator=g, device=cuda,
                    dtype=torch.complex64 if cplx else torch.float32)
    before = fft_fourstep.fft_last.launches
    got = fft_fourstep.fft_last(x, sign)
    again = fft_fourstep.fft_last(x, sign)
    assert fft_fourstep.fft_last.launches == before + 2
    plain = fft_fourstep.fft_last_plain(x, sign)
    x64 = x.to(torch.complex128)
    ref = torch.fft.fft(x64) if sign == -1 else torch.fft.ifft(x64) * n
    torch.cuda.synchronize()
    assert torch.equal(got, again)
    assert _rel(got, plain) <= 2e-6
    assert _rel(got.to(torch.complex128), ref) <= 2e-6


def test_fourstep_kernel_every_plan_shape(cuda):
    """K2 on every length in [256, 1200) that its contract takes (every
    register radix, direct stages of primes up to 251, staged and direct
    loads) and on two-pass lengths with n1 != n2, real and complex, against
    cuFFT in complex128 at 2e-6 of max, both signs."""
    lengths = [n for n in range(256, 1200)
               if fft_fourstep._balanced_factors(n) is not None]
    lengths += [8192, 9000, 12288, 13000, 16384]
    g = torch.Generator(device=cuda).manual_seed(5)
    for n in lengths:
        for dtype in (torch.complex64, torch.float32):
            x = torch.randn((3, n), generator=g, device=cuda, dtype=dtype)
            x64 = x.to(torch.complex128)
            for sign in (-1, 1):
                got = fft_fourstep.fft_last(x, sign)
                ref = torch.fft.fft(x64) if sign == -1 \
                    else torch.fft.ifft(x64) * n
                assert _rel(got.to(torch.complex128), ref) <= 2e-6, \
                    (n, dtype, sign)


def test_fourstep_plain_keeps_the_callers_tf32_setting(cuda):
    """The plain K2 runs its products at full float32 grade without
    touching the process-wide TF32 flag."""
    old = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        x = torch.randn((8, 256), device=cuda)
        got = fft_fourstep.fft_last_plain(x)
        torch.cuda.synchronize()
        assert torch.backends.cuda.matmul.allow_tf32 is True
        ref = torch.fft.fft(x.to(torch.complex128))
        assert _rel(got.to(torch.complex128), ref) <= 2e-6
    finally:
        torch.backends.cuda.matmul.allow_tf32 = old


def test_kernels_reject_strided_input(cuda):
    x = torch.zeros((256, 512), device=cuda)
    with pytest.raises(ValueError, match="contiguous"):
        fft_fourstep.fft_last(x[:, ::2])
    F = torch.zeros((4, 16, 9), device=cuda, dtype=torch.complex64)
    with pytest.raises(ValueError, match="contiguous"):
        mirror.mirror_psd(F.transpose(0, 1), 16, True, 1.0)
    plan = binning.BinPlan(np.arange(16) % 3, 3)
    with pytest.raises(ValueError, match="contiguous"):
        binning.binned_sum(torch.zeros((16, 4), device=cuda).T, plan)
    z = torch.zeros((64, 32), device=cuda, dtype=torch.complex128)
    with pytest.raises(ValueError, match="contiguous"):
        dft64.dft_last(z[:, ::2])
    with pytest.raises(ValueError, match="complex128 only"):
        dft64.dft_last(z.to(torch.complex64))
    p = prologue.plan((256, 512), (256, 256), (0, 1), True, {0: 0, 1: 0})
    with pytest.raises(ValueError, match="contiguous"):
        prologue.detrend_window(x[:, ::2], p)


@pytest.mark.parametrize("sign", [-1, 1])
@pytest.mark.parametrize("n,rows", [(16, 4099), (96, 513), (120, 257),
                                    (250, 64), (251, 300), (256, 1000),
                                    (1000, 64), (2048, 32), (4096, 48)])
def test_dft64_kernel_matches_plain_and_cufft(cuda, n, rows, sign):
    """K4 alone (n <= 256) against its plain version at 1e-13 of max, and
    the recursion against cuFFT in complex128 at 1e-12; two runs are bit
    for bit the same."""
    g = torch.Generator(device=cuda).manual_seed(n)
    x = torch.randn((rows, n), generator=g, device=cuda,
                    dtype=torch.complex128)
    before = dft64.dft_last.launches
    got = dft64.fft_last(x, sign)
    again = dft64.fft_last(x, sign)
    stages = 1 if n <= 256 else 2
    assert dft64.dft_last.launches == before + 2 * stages
    ref = torch.fft.fft(x) if sign == -1 else torch.fft.ifft(x) * n
    torch.cuda.synchronize()
    assert got.dtype == torch.complex128 and got.is_contiguous()
    assert torch.equal(got, again)
    assert _rel(got, ref) <= 1e-12
    if n <= 256:
        assert _rel(got, dft64.dft_last_plain(x, sign)) <= 1e-13


def test_dft64_kernel_every_length(cuda):
    """K4 on every length of its contract, 1 to 256, both signs, against
    its plain version at 1e-13 and cuFFT at 1e-12 of max; repeats are bit
    for bit the same."""
    g = torch.Generator(device=cuda).manual_seed(6)
    for n in range(1, dft64.KERNEL_MAX + 1):
        x = torch.randn((37, n), generator=g, device=cuda,
                        dtype=torch.complex128)
        for sign in (-1, 1):
            got = dft64.dft_last(x, sign)
            ref = torch.fft.fft(x) if sign == -1 else torch.fft.ifft(x) * n
            assert torch.equal(got, dft64.dft_last(x, sign)), (n, sign)
            assert _rel(got, ref) <= 1e-12, (n, sign)
            assert _rel(got, dft64.dft_last_plain(x, sign)) <= 1e-13, (n, sign)


@pytest.mark.parametrize("impl", ["torch", "kernel"])
def test_hp_psd_and_ifft_through_kernels(cuda, impl):
    """The hp PSD takes K4 (both axes, 256 each) under fft_impl="kernel";
    the float32 ifft of a half spectrum takes K2 with sign +1."""
    g = torch.Generator(device=cuda).manual_seed(1)
    x = torch.randn((4, 256, 256), generator=g, device=cuda)
    coords = {"y": np.arange(256) * 0.5, "x": np.arange(256) * 0.5}
    da = LabeledArray(x, ("time", "y", "x"), coords)
    kw = dict(dim=["y", "x"], window="hann", detrend="linear")
    k2, k4 = fft_fourstep.fft_last.launches, dft64.dft_last.launches
    with fft_impl(impl):
        hp = power_spectrum(da, engine="hp", **kw)
        F = fft(da, dim=["y", "x"], real_dim="x", shift=False)
        back = ifft(F, dim=["freq_y", "freq_x"], real_dim="freq_x",
                    lag=[64.0, 64.0])
    kernel = impl == "kernel"
    assert dft64.dft_last.launches == k4 + (2 if kernel else 0)
    assert fft_fourstep.fft_last.launches == k2 + (4 if kernel else 0)
    with fft_impl("torch"):
        ref = power_spectrum(LabeledArray(x.double(), ("time", "y", "x"),
                                          coords), engine="hp", **kw)
    torch.cuda.synchronize()
    assert hp.data.is_cuda and hp.dtype == torch.float64
    assert _rel(hp.data, ref.data) <= 1e-12
    assert back.data.is_cuda and back.dtype == torch.float32
    assert _rel(back.data.double(), x.double()) <= 2e-6


def _radial_codes(n, nbins, dx=0.5):
    k = np.fft.fftshift(np.fft.fftfreq(n, dx))
    return binning.cut_codes(np.sqrt(k[:, None] ** 2 + k[None, :] ** 2),
                             nbins)


def _odd_codes():
    """1001 x 999 radial codes into 250 bins, with a few forced to -1."""
    k0 = np.fft.fftshift(np.fft.fftfreq(1001, 0.3))
    k1 = np.fft.fftshift(np.fft.fftfreq(999, 0.3))
    codes, nbins = binning.cut_codes(
        np.sqrt(k0[:, None] ** 2 + k1[None, :] ** 2), 250)
    codes[::97] = -1
    return codes, nbins


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64,
                                   torch.complex64, torch.complex128])
@pytest.mark.parametrize("case", ["odd", "random", "full"])
def test_binned_sum_kernel_matches_float64_and_repeats(cuda, case, dtype):
    if case == "odd":
        (codes, nbins), batch = _odd_codes(), (3,)
    elif case == "random":
        rng = np.random.RandomState(0)
        codes, nbins, batch = rng.randint(-1, 37, 5001), 37, (2, 3)
    else:
        (codes, nbins), batch = _radial_codes(4096, 1024), (8,)
    plan = binning.BinPlan(codes, nbins)
    g = torch.Generator(device=cuda).manual_seed(nbins)
    x = torch.randn(batch + (codes.size,), generator=g, device=cuda,
                    dtype=dtype)
    before = binning.binned_sum.launches
    got = binning.binned_sum(x, plan)
    again = binning.binned_sum(x, plan)
    assert binning.binned_sum.launches == before + 2
    wide = torch.complex128 if dtype.is_complex else torch.float64
    ref = binning.binned_sum_plain(x.to(wide), plan)
    torch.cuda.synchronize()
    assert got.dtype == dtype and got.shape == batch + (nbins,)
    assert torch.equal(got, again)                       # deterministic
    tol = 2e-6 if dtype in (torch.float32, torch.complex64) else 1e-12
    assert _rel(got.to(wide), ref) <= tol


@pytest.mark.parametrize("impl", ["kernel", "plain"])
def test_isotropic_path_through_kernels(cuda, impl):
    g = torch.Generator(device=cuda).manual_seed(0)
    x = torch.randn((4, 256, 256), generator=g, device=cuda)
    coords = {"y": np.arange(256) * 0.5, "x": np.arange(256) * 0.5}
    kw = dict(dim=["y", "x"], window="hann", detrend="linear", truncate=True)
    da = LabeledArray(x, ("time", "y", "x"), coords)
    before = binning.binned_sum.launches
    with binned_sum_impl(impl):
        got = isotropic_power_spectrum(da, **kw)
        cross = isotropic_cross_spectrum(da, da, **kw)
    assert binning.binned_sum.launches == before + (2 if impl == "kernel"
                                                    else 0)
    with binned_sum_impl("plain"), psd_mirror_impl("plain"):
        ref = isotropic_power_spectrum(
            LabeledArray(x.double(), ("time", "y", "x"), coords), **kw)
    torch.cuda.synchronize()
    assert got.data.is_cuda and got.dims == ref.dims == ("time", "freq_r")
    np.testing.assert_array_equal(got.coords["freq_r"].values,
                                  ref.coords["freq_r"].values)
    assert _rel(got.data.double(), ref.data) <= 2e-6
    assert _rel(cross.data.real.double(), ref.data) <= 2e-6


@pytest.mark.parametrize("impl", ["torch", "kernel"])
def test_main_path_through_kernels(cuda, impl):
    g = torch.Generator(device=cuda).manual_seed(0)
    x = torch.randn((4, 256, 256), generator=g, device=cuda)
    coords = {"y": np.arange(256) * 0.5, "x": np.arange(256) * 0.5}
    kw = dict(dim=["y", "x"], window="hann", detrend="linear")
    k1, k2 = mirror.mirror_psd.launches, fft_fourstep.fft_last.launches
    with fft_impl(impl):
        got = power_spectrum(LabeledArray(x, ("time", "y", "x"), coords), **kw)
    assert mirror.mirror_psd.launches == k1 + 1
    assert fft_fourstep.fft_last.launches == k2 + (2 if impl == "kernel" else 0)
    with psd_mirror_impl("plain"):
        ref = power_spectrum(
            LabeledArray(x.double(), ("time", "y", "x"), coords), **kw)
    torch.cuda.synchronize()
    assert got.data.is_cuda and got.dims == ref.dims
    assert _rel(got.data.double(), ref.data) <= 2e-6


@pytest.mark.parametrize("m,k,shape", [
    (64, 32, (32, 40000)),          # the engine's unpacked level-0 shape
    (256, 128, (128, 8192)),        # the packed A/B shape
    (64, 32, (300, 32, 32)),        # a digit axis in the middle, strided
    (48, 24, (24, 1001)),           # ragged rows, columns and K
    (10, 7, (3, 7, 13)),            # Q not a multiple of 4: scalar copies
    (256, 128, (128, 8195)),        # the packed shape at a ragged N
    (256, 128, (5, 128, 13)),       # packed, strided, Q not a multiple of 4
    (130, 96, (96, 1000)),          # two M chunks and three K chunks, ragged
])
def test_dot_kernels_match_plain(cuda, m, k, shape):
    """K5a and K5c (3xTF32, K5c with W resident and X by TMA or cp.async)
    each against their plain torch.matmul at 1e-6 of max, each repeat
    bit-identical; K5b (M = 2K only) against its plain version."""
    g = torch.Generator(device=cuda).manual_seed(m * k)
    w = torch.randn((m, k), generator=g, device=cuda)
    x = torch.randn(shape, generator=g, device=cuda)
    counts = (dot.dot.launches, dot.dot_dma.launches)
    got = dot.dot(w, x)
    again = dot.dot(w, x)
    dma = dot.dot_dma(w, x)
    dma_again = dot.dot_dma(w, x)
    assert (dot.dot.launches, dot.dot_dma.launches) == \
        (counts[0] + 2, counts[1] + 2)
    ref = dot.dot_plain(w, x)
    torch.cuda.synchronize()
    assert got.shape == ref.shape
    assert torch.equal(got, again) and torch.equal(dma, dma_again)
    assert _rel(got, ref) <= 1e-6 and _rel(dma, ref) <= 1e-6
    if m == 2 * k:
        before = dot.dot_fold.launches
        fold = dot.dot_fold(w, x)
        assert dot.dot_fold.launches == before + 1
        assert _rel(fold, dot.dot_fold_plain(w, x)) <= 1e-6
    else:
        with pytest.raises(ValueError, match="M == 2K"):
            dot.dot_fold(w, x)


def test_dot_dma_against_dot_at_the_packed_shape(cuda):
    """K5c (W resident in a group of four CTAs, X by TMA) and K5a run the
    same 3xTF32 arithmetic: at the packed shape both lie within 1e-6 of max
    of torch.matmul, and their largest difference is logged."""
    g = torch.Generator(device=cuda).manual_seed(9)
    w = dot.pack_block_diag(torch.randn((64, 32), generator=g, device=cuda),
                            4)
    x = torch.randn((128, 1 << 16), generator=g, device=cuda)
    assert dot.dma_tensor_map(x)["rank"] == 2
    a, c = dot.dot(w, x), dot.dot_dma(w, x)
    ref = dot.dot_plain(w, x)
    torch.cuda.synchronize()
    diff = (a - c).abs().max().item()
    print(f"K5a vs K5c at (256,128)@(128,65536): max abs diff {diff:.3e}, "
          f"rel {diff / ref.abs().max().item():.3e}")
    assert _rel(a, ref) <= 1e-6 and _rel(c, ref) <= 1e-6
    assert _rel(c, a) <= 1e-6
    assert torch.equal(c, dot.dot_dma(w, x))


@pytest.mark.parametrize("impl", ["unpacked", "packed"])
def test_matmul_route_through_k5a(cuda, impl):
    """The PSD and Welch under fft_impl="matmul" launch K5a once per call
    and agree with cuFFT's float64 route to 2e-6 of max."""
    g = torch.Generator(device=cuda).manual_seed(2)
    x = torch.randn((4, 256, 1024), generator=g, device=cuda)
    coords = {"y": np.arange(256) * 0.5, "x": np.arange(1024) * 0.5}
    da = LabeledArray(x, ("time", "y", "x"), coords)
    kw = dict(dim=["y", "x"], window="hann", detrend="linear")
    before = dot.dot.launches
    with fft_impl("matmul"), level0_impl(impl):
        got = power_spectrum(da, **kw)
        w = welch(da, dim="x", seglen=256)
    assert dot.dot.launches == before + 2
    ref = power_spectrum(da.copy(data=x.double()), **kw)
    ref_w = welch(da.copy(data=x.double()), dim="x", seglen=256)
    torch.cuda.synchronize()
    assert got.data.is_cuda and got.dims == ref.dims
    assert _rel(got.data.double(), ref.data) <= 2e-6
    assert _rel(w.data.double(), ref_w.data) <= 2e-6


def test_matmul_pair_engine_through_k2(cuda):
    """Under fft_impl="matmul" the pair engine runs what the stacked engine
    cannot plan: a Bluestein length (n = 157 on 64 rows) launches K2 twice
    (its two 512-point transforms) and is within 2e-6 of max of the same
    call on the CPU; irfftn of (4, 96, 315) takes the stacked inverse along
    96, then the packed half-length inverse at 314 = 2 x 157 on K2, within
    2e-6 of max of cuFFT's."""
    g = torch.Generator(device=cuda).manual_seed(157)
    x = torch.randn((64, 157), generator=g, device=cuda,
                    dtype=torch.complex64)
    X = torch.fft.rfftn(torch.randn((4, 96, 628), generator=g, device=cuda),
                        dim=(1, 2))
    with fft_impl("matmul"):
        before = fft_fourstep.fft_last.launches
        got = fft_core.fftn(x, [1])
        torch.cuda.synchronize()
        assert fft_fourstep.fft_last.launches == before + 2
        on_cpu = fft_core.fftn(x.cpu(), [1])
        before = fft_fourstep.fft_last.launches
        back = fft_core.irfftn(X, [1, 2])
        torch.cuda.synchronize()
        assert fft_fourstep.fft_last.launches == before + 1
    assert got.is_cuda and _rel(got.cpu(), on_cpu) <= 2e-6
    assert back.shape == (4, 96, 628) and back.dtype == torch.float32
    assert _rel(back, torch.fft.irfftn(X, dim=(1, 2))) <= 2e-6


@pytest.mark.parametrize("mode,kw", [
    ("constant", {}), ("constant", dict(constant_values=dict(t=(1.0, 2.0)))),
    ("edge", {}), ("reflect", {}), ("symmetric", {}), ("wrap", {}),
    ("reflect", dict(reflect_type="odd")),
    ("symmetric", dict(reflect_type="odd")),
    ("linear_ramp", {}), ("linear_ramp", dict(end_values=dict(t=(1.0, 2.0)))),
    ("maximum", dict(stat_length=5)), ("minimum", {}),
    ("median", dict(stat_length=dict(t=(4, 9)))), ("mean", {}),
])
def test_pad_on_the_card_matches_numpy(cuda, mode, kw):
    """pad runs every mode on the card and stays there.  It repeats
    numpy.pad's own steps, so it equals numpy bit for bit, except the mean,
    whose sum the card takes in another order (2e-6 of max in float32)."""
    g = torch.Generator(device=cuda).manual_seed(3)
    x = torch.randn((3, 40), generator=g, device=cuda)
    da = LabeledArray(x, ("time", "t"), {"t": np.arange(40) * 0.5})
    got = pad(da, dict(t=(7, 45)), mode=mode, **kw)
    np_kw = {k: (((0, 0), v["t"]) if isinstance(v, dict) else v)
             for k, v in kw.items()}
    want = np.pad(x.cpu().numpy(), ((0, 0), (7, 45)), mode=mode, **np_kw)
    assert got.data.is_cuda
    if mode == "mean":
        np.testing.assert_allclose(got.data.cpu().numpy(), want, rtol=0,
                                   atol=2e-6 * np.abs(want).max())
    else:
        np.testing.assert_array_equal(got.data.cpu().numpy(), want)


def test_direct_convolution_at_float32_grade(cuda):
    """cuDNN runs float32 convolutions in TF32 by default (about 1e-3
    relative); the direct route runs inside full_fp32, so it agrees with
    the float64 FFT route at float32 grade, and leaves the caller's TF32
    setting as it found it."""
    g = torch.Generator(device=cuda).manual_seed(4)
    x = torch.randn((2, 512, 512), generator=g, device=cuda)
    k = torch.randn((31, 31), generator=g, device=cuda)
    conv = torch.backends.cudnn.conv
    old, conv.fp32_precision = conv.fp32_precision, "tf32"
    try:
        da = LabeledArray(x, ("z", "y", "x"))
        dk = LabeledArray(k, ("y", "x"))
        for mode in ("full", "same", "valid"):
            got = convolve(da, dk, mode=mode, method="direct")
            ref = fftconvolve(da.copy(data=x.double()),
                              dk.copy(data=k.double()), mode=mode)
            torch.cuda.synchronize()
            assert got.data.is_cuda and got.dtype == torch.float32
            assert _rel(got.data.double(), ref.data) <= 2e-6, mode
        assert conv.fp32_precision == "tf32"
    finally:
        conv.fp32_precision = old


@pytest.mark.parametrize("dtype", [torch.int16, torch.int32, torch.int64,
                                   torch.uint8, torch.bool])
def test_direct_convolution_of_integer_data(cuda, dtype):
    """cuDNN has no integer convolution: integer and bool operands take the
    direct route in float64 and return in their dtype, equal to the same
    call on the CPU (numpy's direct convolution: integers wrapped, bool as
    "any product")."""
    g = torch.Generator().manual_seed(5)
    x = torch.randint(0, 120, (3, 700), generator=g).to(dtype)
    k = torch.randint(0, 120, (9,), generator=g).to(dtype)
    got, want = (convolve(LabeledArray(x.to(dev), ("z", "x")),
                          LabeledArray(k.to(dev), ("x",)), method="direct")
                 for dev in (cuda, "cpu"))
    torch.cuda.synchronize()
    assert got.data.is_cuda and got.dtype == dtype
    assert torch.equal(got.data.cpu(), want.data)


@pytest.mark.parametrize("impl", ["torch", "kernel", "matmul"])
def test_float16_namesakes_are_their_float32_calls(cuda, impl):
    """float16 data compute in float32 from the first operation: dct, idct
    (whose DCT-III path transforms a complex input), DCT-I, czt,
    resample_poly and the direct convolution of float16 data are the
    float32 calls on the same values, bit for bit, with the same K2
    launches."""
    g = torch.Generator(device=cuda).manual_seed(15)
    h = torch.randn((4, 64, 512), generator=g, device=cuda).half()
    da = LabeledArray(h, ("z", "y", "x"), {"x": np.arange(512) * 0.5})
    taps = LabeledArray(h[0, 0, :9].contiguous(), ("x",))
    calls = [
        lambda d, t: dct(d, dim="x"),
        lambda d, t: idct(d, dim="x", norm="ortho"),
        lambda d, t: dct(d, dim="x", type=1),
        lambda d, t: czt(d, dim="x", m=300),
        lambda d, t: resample_poly(d, 3, 2, dim="x"),
        lambda d, t: convolve(d, t, dims="x", method="direct"),
    ]
    for fn in calls:
        before = fft_fourstep.fft_last.launches
        with fft_impl(impl):
            got = fn(da, taps)
            n16 = fft_fourstep.fft_last.launches - before
            want = fn(da.copy(data=h.float()),
                      taps.copy(data=taps.data.float()))
        n32 = fft_fourstep.fft_last.launches - before - n16
        torch.cuda.synchronize()
        assert got.dtype in (torch.float32, torch.complex64)
        assert got.dtype == want.dtype and torch.equal(got.data, want.data)
        assert n16 == n32


@pytest.mark.parametrize("legacy", [None, True, False])
def test_full_fp32_keeps_the_callers_cudnn_setting(cuda, legacy):
    """A caller's cuDNN TF32 setting, legacy flag or new API, is as it was
    after a direct convolution on the card."""
    cudnn = torch.backends.cudnn
    saved = (cudnn.fp32_precision, cudnn.conv.fp32_precision,
             cudnn.rnn.fp32_precision)
    try:
        if legacy is not None:
            cudnn.allow_tf32 = legacy
        before = (cudnn.conv.fp32_precision, cudnn.rnn.fp32_precision)
        allow = cudnn.allow_tf32
        x = torch.randn((4, 64, 64), device=cuda)
        convolve(LabeledArray(x, ("z", "y", "x")),
                 LabeledArray(x[0, :5, :5], ("y", "x")), method="direct")
        with full_fp32():
            assert cudnn.conv.fp32_precision == "ieee"
        torch.cuda.synchronize()
        assert (cudnn.conv.fp32_precision,
                cudnn.rnn.fp32_precision) == before
        assert cudnn.allow_tf32 == allow
    finally:
        (cudnn.fp32_precision, cudnn.conv.fp32_precision,
         cudnn.rnn.fp32_precision) = saved


@pytest.mark.parametrize("impl", ["torch", "kernel"])
def test_namesakes_through_kernels(cuda, impl):
    """The scipy-namesake families take K2 (float32) and the K4 recursion
    (float64) under fft_impl="kernel" and none under "torch", and agree
    with the float64 cuFFT route: 2e-6 of max in float32, 1e-12 in
    float64."""
    g = torch.Generator(device=cuda).manual_seed(7)
    x = torch.randn((4, 256, 512), generator=g, device=cuda)
    r = np.logspace(-3, 2, 512)
    da = LabeledArray(x, ("z", "y", "x"), {"x": np.arange(512) * 0.5})
    da64 = da.copy(data=x.double())
    kern = LabeledArray(x[0, :9, :9].contiguous(), ("y", "x"))
    taps = LabeledArray(x[0, 0, :33].contiguous(), ("x",))

    def as_dtype(k, d):
        return k.copy(data=k.data.to(d.dtype))

    calls = [
        lambda d: dct(d, dim="x", type=1),
        lambda d: dctn(d, dim=["y", "x"], norm="ortho"),
        lambda d: hilbert(d, dim="x"),
        lambda d: fftconvolve(d, as_dtype(kern, d), mode="same"),
        lambda d: oaconvolve(d, as_dtype(taps, d), dims="x", mode="same"),
        lambda d: zoom_fft(d, [0.1, 0.5], dim="x"),
        lambda d: resample(d, 300, dim="x"),
        lambda d: fht(d.assign_coords(x=r), mu=0.5, dim="x"),
    ]
    for fn in calls:
        k2, k4 = fft_fourstep.fft_last.launches, dft64.dft_last.launches
        with fft_impl(impl):
            got32 = fn(da)
            got64 = fn(da64)
        n2 = fft_fourstep.fft_last.launches - k2
        n4 = dft64.dft_last.launches - k4
        ref = fn(da64)
        torch.cuda.synchronize()
        assert (n2 > 0 and n4 > 0) == (impl == "kernel")
        assert (n2 == 0 and n4 == 0) == (impl == "torch")
        assert got32.data.is_cuda and got64.data.is_cuda
        assert _rel(got32.data.to(ref.dtype), ref.data) <= 2e-6
        assert _rel(got64.data, ref.data) <= 1e-12


@pytest.mark.parametrize("impl", ["torch", "kernel"])
def test_one_rank_nccl_sharded_psd(cuda, impl):
    """The sharded path on one card: a one-rank NCCL group, a DeviceMesh
    over it, the pencil chain's all_to_all through NCCL, and K6, K1 (and K2
    under "kernel") on the local block, K6's moments summed through NCCL;
    equal to the unsharded PSD, sharded over the batch as planned."""
    import torch.distributed as dist
    from torch.distributed.tensor import Shard

    from xrft_tpu_torch.parallel import make_mesh, sharded_power_spectrum

    if dist.is_initialized():
        pytest.skip("a process group is already initialized")
    dist.init_process_group("nccl", store=dist.HashStore(), rank=0,
                            world_size=1, device_id=torch.device("cuda", 0))
    try:
        mesh = make_mesh({"fp": 1})
        g = torch.Generator(device=cuda).manual_seed(25)
        da = LabeledArray(torch.randn((4, 256, 256), generator=g,
                                      device=cuda),
                          ("b", "y", "x"),
                          coords={"y": np.arange(256) * 0.5,
                                  "x": np.arange(256) * 0.5})
        kw = dict(dim=["y", "x"], window="hann", detrend="linear")
        with fft_impl(impl):
            ref = power_spectrum(da, **kw)
            k1, k2 = mirror.mirror_psd.launches, fft_fourstep.fft_last.launches
            k6 = prologue.detrend_window.launches
            got = sharded_power_spectrum(da, mesh, {"y": "fp"}, **kw)
            torch.cuda.synchronize()
        assert mirror.mirror_psd.launches == k1 + 1
        assert prologue.detrend_window.launches == k6 + 3
        assert (fft_fourstep.fft_last.launches - k2 >= 2) == (impl == "kernel")
        assert tuple(got.data.placements) == (Shard(0),)
        assert got.data.to_local().shape == (4, 256, 256)
        assert _rel(got.data.to_local(), ref.data) <= 2e-6
    finally:
        dist.destroy_process_group()


def test_one_rank_nccl_sharded_psd3d(cuda):
    """The dns-2048 cell's call at a small size on one card: a 3-D PSD over
    (z, y, x) with z sharded over a one-rank NCCL group; K6 takes the
    slab's prologue over its three axes (three launches, its four moments
    summed through NCCL), and the result equals the unsharded PSD."""
    import torch.distributed as dist

    from xrft_tpu_torch.parallel import make_mesh, sharded_power_spectrum

    if dist.is_initialized():
        pytest.skip("a process group is already initialized")
    dist.init_process_group("nccl", store=dist.HashStore(), rank=0,
                            world_size=1, device_id=torch.device("cuda", 0))
    try:
        mesh = make_mesh({"fp": 1})
        g = torch.Generator(device=cuda).manual_seed(27)
        x = 290 + 2 * torch.randn((1, 64, 96, 128), generator=g, device=cuda)
        da = LabeledArray(x, ("component", "z", "y", "x"),
                          coords={d: np.arange(n) * 1.0 for d, n in
                                  zip("zyx", x.shape[1:])})
        kw = dict(dim=["z", "y", "x"], window="hann", detrend="linear")
        ref = power_spectrum(da, **kw)
        k6 = prologue.detrend_window.launches
        got = sharded_power_spectrum(da, mesh, {"z": "fp"}, **kw)
        torch.cuda.synchronize()
        assert prologue.detrend_window.launches == k6 + 3
        assert got.data.to_local().shape == ref.data.shape
        assert _rel(got.data.to_local(), ref.data) <= 2e-6
    finally:
        dist.destroy_process_group()


@pytest.mark.parametrize("mirror_impl", ["kernel", "plain"])
def test_one_rank_nccl_sharded_2d_roundtrip(cuda, mirror_impl):
    """A 2-D field with y sharded on a one-rank NCCL group: the chain takes
    a roundtrip step and y stays sharded.  K1 mirrors the local block (the
    one rank holds all of y), the plain expansion gathers along y with an
    NCCL all_to_all, and K3 bins the block; each equal to the unsharded
    call."""
    import torch.distributed as dist
    from torch.distributed.tensor import Replicate, Shard

    from xrft_tpu_torch.parallel import (make_mesh, sharded_power_spectrum,
                                         sharded_isotropic_power_spectrum)

    if dist.is_initialized():
        pytest.skip("a process group is already initialized")
    dist.init_process_group("nccl", store=dist.HashStore(), rank=0,
                            world_size=1, device_id=torch.device("cuda", 0))
    try:
        mesh = make_mesh({"fp": 1})
        g = torch.Generator(device=cuda).manual_seed(26)
        da = LabeledArray(torch.randn((256, 256), generator=g, device=cuda),
                          ("y", "x"), coords={"y": np.arange(256) * 0.5,
                                              "x": np.arange(256) * 0.5})
        kw = dict(dim=["y", "x"], window="hann", detrend="linear")
        with fft_impl("kernel"), psd_mirror_impl(mirror_impl):
            ref = power_spectrum(da, **kw)
            k1 = mirror.mirror_psd.launches
            got = sharded_power_spectrum(da, mesh, {"y": "fp"}, **kw)
            torch.cuda.synchronize()
            assert mirror.mirror_psd.launches - k1 == \
                (1 if mirror_impl == "kernel" else 0)
            iso_ref = isotropic_power_spectrum(da, **kw)
            k3 = binning.binned_sum.launches
            iso = sharded_isotropic_power_spectrum(da, mesh, {"y": "fp"},
                                                   **kw)
            torch.cuda.synchronize()
        assert binning.binned_sum.launches == k3 + 1
        assert tuple(got.data.placements) == (Shard(0),)
        assert tuple(iso.data.placements) == (Replicate(),)
        assert _rel(got.data.to_local(), ref.data) <= 2e-6
        assert _rel(iso.data.to_local(), iso_ref.data) <= 2e-6
    finally:
        dist.destroy_process_group()


@pytest.mark.parametrize("kind", ["constant", "linear"])
@pytest.mark.parametrize("field", ["counts", "sst"])
def test_detrend_far_from_zero_mean_on_the_card(cuda, field, kind):
    """The detrend of 8 x 1024^2 fields far from zero mean on the card
    (12-bit counts, whose float32 residual sums the card's reductions bias,
    and SST in kelvin), within 2e-6 of max |residual| of the same call on
    the float64 values."""
    from xrft_tpu_torch import detrend

    g = torch.Generator(device=cuda).manual_seed(28)
    if field == "counts":
        x = torch.randint(0, 4096, (8, 1024, 1024), generator=g,
                          device=cuda).float()
    else:
        x = 290 + 2 * torch.randn((8, 1024, 1024), generator=g, device=cuda)
    dims = ("time", "y", "x")
    got = detrend(LabeledArray(x, dims), ["y", "x"], kind).data
    ref = detrend(LabeledArray(x.double(), dims), ["y", "x"], kind).data
    assert got.dtype == torch.float32
    assert _rel(got, ref) <= 2e-6


def _k6_field(cuda, data, shape, seed):
    """N(0, 1), SST in kelvin (290 + 2 N(0, 1)) or 12-bit counts, in
    float64 on the card."""
    g = torch.Generator(device=cuda).manual_seed(seed)
    if data == "counts":
        return torch.randint(0, 4096, shape, generator=g,
                             device=cuda).double()
    x = torch.randn(shape, generator=g, device=cuda, dtype=torch.float64)
    return 290 + 2 * x if data == "sst" else x


# shape, detrend dims: the flagship's and GLORYS12's rows, an odd ragged
# row, a detrend over the trailing axis alone, and few long rows, which K6
# cuts into chunks of 8192 (128 and 65 a row); over three axes (z, y, x)
# in two orders, with rows cut into three chunks (the fields stage's group
# a warp) and two (a block, striding over a row's chunks), and with 2^16
# rows a field (a cluster)
K6_CASES = {"4096": ((2, 4096, 4096), ["y", "x"]),
            "2041x4320": ((2, 2041, 4320), ["y", "x"]),
            "257x1001": ((3, 257, 1001), ["y", "x"]),
            "rows-1001": ((3, 257, 1001), "x"),
            "long-rows": ((2, 4, 1 << 20), "x"),
            "long-2d": ((1, 3, (1 << 19) + 7), ["y", "x"]),
            "3d": ((2, 48, 256, 384), ["z", "y", "x"]),
            "3d-xzy": ((2, 48, 256, 384), ["x", "z", "y"]),
            "3d-long": ((1, 3, 5, 20011), ["z", "y", "x"]),
            "3d-chunked": ((2, 8, 64, 16001), ["z", "y", "x"]),
            "3d-cluster": ((1, 64, 1024, 96), ["z", "y", "x"])}


@pytest.mark.parametrize("window", ["hann", "tukey", None])
@pytest.mark.parametrize("kind", ["constant", "linear"])
@pytest.mark.parametrize("data", ["normal", "sst", "counts"])
@pytest.mark.parametrize("case", sorted(K6_CASES))
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_k6_matches_plain(cuda, dtype, case, data, kind, window):
    """K6 against its plain version (``detrend_and_window_plain``): within
    2^-22 (float32) or 1e-13 (float64) of the plain output's largest
    |value|, the plain output's dtype, dims, coordinates, name and attrs;
    two calls bit for bit the same, three launches each."""
    det = importlib.import_module("xrft_tpu_torch.detrend")
    shape, dims = K6_CASES[case]
    x = _k6_field(cuda, data, shape, 18).to(dtype)
    names = ("time", "z", "y", "x") if len(shape) == 4 \
        else ("time", "y", "x")
    da = LabeledArray(x, names,
                      coords={d: np.arange(n) * 0.5
                              for d, n in zip(names[1:], shape[1:])},
                      name="sst", attrs={"units": "K"})
    before = prologue.detrend_window.launches
    got = det.detrend_and_window(da, dims, kind, window)
    again = det.detrend_and_window(da, dims, kind, window)
    assert prologue.detrend_window.launches == before + 6
    ref = det.detrend_and_window_plain(da, dims, kind, window)
    torch.cuda.synchronize()
    assert torch.equal(got.data, again.data)
    assert got.dtype == ref.dtype == dtype and got.dims == ref.dims
    assert got.name == ref.name and got.attrs == ref.attrs
    assert set(got.coords) == set(ref.coords)
    for c in ref.coords:
        np.testing.assert_array_equal(got.coords[c].values,
                                      ref.coords[c].values)
    lim = 2.0 ** -22 if dtype == torch.float32 else 1e-13
    err = (got.data - ref.data).abs().max().item()
    assert err <= lim * ref.data.abs().max().item()


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_k6_on_a_block_off_its_alignment(cuda, dtype):
    """A stack one value past a 16-byte boundary: K6 reads and writes it
    value by value, within its limits of the plain version."""
    det = importlib.import_module("xrft_tpu_torch.detrend")
    shape = (3, 257, 1001)
    flat = _k6_field(cuda, "sst", (1 + 3 * 257 * 1001,), 19).to(dtype)
    x = flat[1:].view(shape)
    assert x.data_ptr() % 16 != 0
    da = LabeledArray(x, ("time", "y", "x"))
    got = det.detrend_and_window(da, ["y", "x"], "linear", "hann")
    ref = det.detrend_and_window_plain(da, ["y", "x"], "linear", "hann")
    torch.cuda.synchronize()
    lim = 2.0 ** -22 if dtype == torch.float32 else 1e-13
    err = (got.data - ref.data).abs().max().item()
    assert err <= lim * ref.data.abs().max().item()


@pytest.mark.parametrize("path,syncs,h2d", [
    ("psd", 2, 2 * 256 * 4),                   # the float32 windows
    ("psd-hp", 2, 2 * 256 * 8),
    ("irfft2", 0, 0),
])
def test_host_syncs_match_the_profilers_stream_syncs(cuda, tmp_path, path,
                                                     syncs, h2d):
    """One call of each benchmark path on a small stack: the program's own
    count of its blocking copies onto the card (``telemetry``'s
    ``host_syncs``: each axis's window; K6 computes the detrend's
    coordinates from the index) equals the host's ``cudaStreamSynchronize``
    calls in a profiler trace of the call; a copy that bypassed
    ``to_device`` would show in the trace alone.  The PSD paths' prologue
    is K6's three launches, none left to the plain version."""
    import json

    from torch.profiler import ProfilerActivity, profile

    from xrft_tpu_torch import telemetry

    g = torch.Generator(device=cuda).manual_seed(17)
    x = torch.randn((4, 256, 256), generator=g, device=cuda)
    coords = {"time": np.arange(4.0), "y": 0.5 * np.arange(256),
              "x": 0.5 * np.arange(256)}
    kw = dict(dim=["y", "x"], window="hann", detrend="linear")
    if path == "irfft2":
        h = torch.fft.rfft2(x)
        coords = {"time": coords["time"],
                  "freq_y": np.fft.fftfreq(256, 0.5),
                  "freq_x": np.fft.rfftfreq(256, 0.5)}
        da = LabeledArray(h, ("time", "freq_y", "freq_x"), coords)
        kw = dict(dim=["freq_y", "freq_x"], real_dim="freq_x", shift=False,
                  lag=None, true_phase=False, true_amplitude=False)
        call = ifft
    else:
        da = LabeledArray(x, ("time", "y", "x"), coords)
        if path == "psd-hp":
            kw["engine"] = "hp"
        call = power_spectrum
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", FutureWarning)
        call(da, **kw)                      # builds K1, makes cuFFT's plans
        torch.cuda.synchronize()
        telemetry.reset()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            call(da, **kw)
            torch.cuda.synchronize()        # cudaDeviceSynchronize
    trace = tmp_path / "trace.json"
    prof.export_chrome_trace(str(trace))
    events = json.loads(trace.read_text())["traceEvents"]
    stream_syncs = [e for e in events
                    if e.get("name") == "cudaStreamSynchronize"]
    snap = telemetry.snapshot()
    assert snap["calls"] == 1
    assert snap["host_syncs"] == syncs == len(stream_syncs)
    assert snap["h2d_bytes"] == h2d
    assert snap["cufft_plans"] == 0          # made by the first call
    assert snap["launches"]["K1"] == (path == "psd")
    assert snap["launches"]["K6"] == (0 if path == "irfft2" else 3)
    assert snap["prologue_plain_cuda"] == 0
