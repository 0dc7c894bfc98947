"""fftconvolve, oaconvolve, convolve, correlate and choose_conv_method of
xrft_tpu_torch against xrft_tpu on the CPU, case for case as
``tests/test_convolve.py`` and ``tests/test_oaconvolve.py``: every mode, real
and complex, swapped sizes, kernel broadcasting, the support and lag grids,
the direct route (one torch convolution; four dims as a sum of 3-D ones) and
the error contracts.  The FFT routes run under fft_impl "torch", "kernel"
and "matmul"; real oaconvolve takes irfftn, which "matmul" runs on the
pair engine's packed inverse, held against xrft_tpu's fft_engine("matmul")
and scipy.  Also: ``config.full_fp32`` scopes cuDNN's convolution
precision and restores the caller's.  Tolerances: 1e-12 (float64) and 2e-6
(float32) of the largest |value|."""

import numpy as np
import pytest
import scipy.signal as sps

torch = pytest.importorskip("torch")

import xrft_tpu
import xrft_tpu_torch as xt
from torch_parity import IMPLS, assert_same, check, pair
from xrft_tpu_torch.config import config, fft_impl, full_fp32
from xrft_tpu_torch.labeled import Coord

MODES = ["full", "same", "valid"]


def operands(n1, n2, seed, complex_input=False, dtype=np.float64):
    rng = np.random.RandomState(seed)
    x = rng.randn(n1) + (1j * rng.randn(n1) if complex_input else 0)
    y = rng.randn(n2) + (1j * rng.randn(n2) if complex_input else 0)
    if not complex_input:
        x, y = x.real.astype(dtype), y.real.astype(dtype)
    return pair(x, ["t"]), pair(y, ["t"])


@pytest.mark.parametrize("impl", IMPLS)
@pytest.mark.parametrize("complex_input", [False, True])
@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("n1,n2", [(20, 7), (20, 8), (19, 8), (7, 20)])
def test_fftconvolve_1d_parity(n1, n2, mode, complex_input, impl):
    (ra, da), (rb, db) = operands(n1, n2, 0, complex_input)
    got, _ = check("fftconvolve", [ra, rb], [da, db], impl, 1e-12, mode=mode)
    assert got.data.is_complex() == complex_input
    want = sps.fftconvolve(np.asarray(ra.values), np.asarray(rb.values),
                           mode=mode)
    assert np.abs(got.values - want).max() <= \
        1e-12 * max(1.0, np.abs(want).max())


@pytest.mark.parametrize("impl", IMPLS)
@pytest.mark.parametrize("mode", MODES)
def test_fftconvolve_2d_parity(mode, impl):
    rng = np.random.RandomState(1)
    (ra, da), (rb, db) = (pair(rng.randn(12, 15), ["y", "x"]),
                          pair(rng.randn(5, 4), ["y", "x"]))
    check("fftconvolve", [ra, rb], [da, db], impl, 1e-12, mode=mode)


@pytest.mark.parametrize("impl", IMPLS)
@pytest.mark.parametrize("complex_input", [False, True])
@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("n1,n2", [(20, 7), (20, 8), (19, 8)])
def test_correlate_parity(n1, n2, mode, complex_input, impl):
    (ra, da), (rb, db) = operands(n1, n2, 2, complex_input)
    check("correlate", [ra, rb], [da, db], impl, 1e-12, mode=mode)


@pytest.mark.parametrize("impl", IMPLS)
def test_correlate_2d_parity(impl):
    rng = np.random.RandomState(3)
    ra, da = pair(rng.randn(10, 12) + 1j * rng.randn(10, 12), ["y", "x"])
    rb, db = pair(rng.randn(4, 5) - 1j * rng.randn(4, 5), ["y", "x"])
    check("correlate", [ra, rb], [da, db], impl, 1e-12, mode="full")


@pytest.mark.parametrize("impl", IMPLS)
def test_kernel_broadcast_over_batch_dims(impl):
    rng = np.random.RandomState(4)
    ra, da = pair(rng.randn(3, 30), ["z", "t"])
    rb, db = pair(rng.randn(7), ["t"])
    check("fftconvolve", [ra, rb], [da, db], impl, 1e-12, dims="t",
          mode="same")


def test_convolution_support_coordinate():
    ra, da = pair(np.ones(8), ["t"], {"t": 2.0 + np.arange(8) * 0.5})
    rb, db = pair(np.ones(3), ["t"], {"t": -1.0 + np.arange(3) * 0.5})
    out, _ = check("fftconvolve", [ra, rb], [da, db], "torch", 1e-12)
    np.testing.assert_allclose(out.coords["t"].values,
                               1.0 + np.arange(10) * 0.5, atol=1e-12)
    assert out.coords["t"].attrs["spacing"] == 0.5
    check("fftconvolve", [ra, rb], [da, db], "torch", 1e-12, mode="same")


@pytest.mark.parametrize("impl", IMPLS)
def test_autocorrelation_lag_coordinate_peaks_at_zero(impl):
    x = np.random.RandomState(5).randn(64)
    ra, da = pair(x, ["t"], {"t": 10.0 + np.arange(64) * 0.25})
    out, _ = check("correlate", [ra, ra], [da, da], impl, 1e-12)
    lags = out.coords["t"].values
    assert lags[np.argmax(out.values)] == 0.0
    np.testing.assert_allclose(out.values.max(), (x * x).sum(), rtol=1e-10)


def test_mismatched_spacing_drops_coord():
    ra, da = pair(np.ones(8), ["t"], {"t": np.arange(8) * 0.5})
    rb, db = pair(np.ones(3), ["t"], {"t": np.arange(3) * 0.25})
    out, _ = check("fftconvolve", [ra, rb], [da, db], "torch", 1e-12)
    assert "t" not in out.coords


@pytest.mark.parametrize("engine", ["xla", "matmul"])
def test_convolve_engine_argument(engine):
    (ra, da), (rb, db) = operands(40, 9, 6)
    check("fftconvolve", [ra, rb], [da, db], "kernel", 1e-12, mode="same",
          engine=engine)
    check("convolve", [ra, rb], [da, db], "kernel", 1e-12, mode="same",
          method="fft", engine=engine)


@pytest.mark.parametrize("impl", ["torch", "kernel", "matmul"])
@pytest.mark.parametrize("fn", ["fftconvolve", "correlate"])
def test_float32_through_k2(fn, impl):
    """float32 stays float32; the padded length 256 runs K2 under
    "kernel"."""
    rng = np.random.RandomState(7)
    ra, da = pair(rng.randn(2, 200).astype(np.float32), ["z", "t"])
    rb, db = pair(rng.randn(57).astype(np.float32), ["t"])
    for mode in MODES:
        got, _ = check(fn, [ra, rb], [da, db], impl, 2e-6, mode=mode)
        assert got.data.dtype == torch.float32


# ---------------------------------------------------------------------------
# method='direct': one torch convolution (cuDNN on the card)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("complex_input", [False, True])
@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("n1,n2", [(20, 7), (20, 8), (19, 8), (16, 1)])
def test_convolve_direct_1d_parity(n1, n2, mode, complex_input):
    (ra, da), (rb, db) = operands(n1, n2, 10, complex_input)
    got, _ = check("convolve", [ra, rb], [da, db], "torch", 1e-12,
                   mode=mode, method="direct")
    assert got.data.is_complex() == complex_input
    want = sps.convolve(np.asarray(ra.values), np.asarray(rb.values),
                        mode=mode, method="direct")
    assert np.abs(got.values - want).max() <= \
        1e-12 * max(1.0, np.abs(want).max())


@pytest.mark.parametrize("mode", MODES)
def test_convolve_direct_2d_batch_parity(mode):
    rng = np.random.RandomState(11)
    ra, da = pair(rng.randn(3, 12, 15), ["z", "y", "x"])
    rb, db = pair(rng.randn(5, 4), ["y", "x"])
    check("convolve", [ra, rb], [da, db], "torch", 1e-12, dims=["y", "x"],
          mode=mode, method="direct")


@pytest.mark.parametrize("complex_input", [False, True])
@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("n1,n2", [(20, 7), (20, 8), (19, 8)])
def test_correlate_direct_parity(n1, n2, mode, complex_input):
    (ra, da), (rb, db) = operands(n1, n2, 12, complex_input)
    check("correlate", [ra, rb], [da, db], "torch", 1e-12, mode=mode,
          method="direct")


def test_correlate_direct_mixed_kind_2d():
    rng = np.random.RandomState(13)
    ra, da = pair(rng.randn(10, 12), ["y", "x"])
    y = rng.randn(4, 5) - 1j * rng.randn(4, 5)
    rb, db = pair(y, ["y", "x"])
    check("correlate", [ra, rb], [da, db], "torch", 1e-12, mode="full",
          method="direct")
    rc, dc = pair(y[:3, :3], ["y", "x"])
    check("convolve", [rb, rc], [db, dc], "torch", 1e-12, mode="same",
          method="direct")


@pytest.mark.parametrize("impl", IMPLS)
def test_convolve_method_fft_matches_fftconvolve(impl):
    (ra, da), (rb, db) = operands(30, 50, 14)   # kernel larger: no direct
    with fft_impl(impl):
        a = xt.convolve(da, db, mode="full", method="fft").values
        b = xt.fftconvolve(da, db, mode="full").values
        c = xt.convolve(da, db, mode="full", method="auto").values
    np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(c, b)
    check("convolve", [ra, rb], [da, db], impl, 1e-12, method="auto")


def test_convolve_direct_coordinate_grids_match_fft_route():
    rng = np.random.RandomState(15)
    ra, da = pair(rng.randn(16), ["t"], {"t": 2.0 + np.arange(16) * 0.5})
    rb, db = pair(rng.randn(5), ["t"], {"t": -1.0 + np.arange(5) * 0.5})
    for mode in MODES:
        for fn in ("convolve", "correlate"):
            d, _ = check(fn, [ra, rb], [da, db], "torch", 1e-12, mode=mode,
                         method="direct")
            f, _ = check(fn, [ra, rb], [da, db], "torch", 1e-12, mode=mode,
                         method="fft")
            np.testing.assert_allclose(d.coords["t"].values,
                                       f.coords["t"].values, atol=1e-12)


def test_choose_conv_method():
    _, small = pair(np.ones(8), ["t"])
    _, field = pair(np.ones(4096), ["t"])
    assert xt.choose_conv_method(field, small) == "direct"
    _, big = pair(np.ones(config.direct_conv_max + 1), ["t"])
    _, wide = pair(np.ones(2 * config.direct_conv_max), ["t"])
    assert xt.choose_conv_method(wide, big) == "fft"
    # ineligible pairs always pick fft: a kernel larger than the data, or
    # one carrying a batch (non-transform) dim
    assert xt.choose_conv_method(small, field) == "fft"
    _, da = pair(np.ones((4, 32)), ["z", "t"])
    _, dk = pair(np.ones((4, 3)), ["z", "t"])
    assert xt.choose_conv_method(da, dk, dims="t") == "fft"
    # measure=True times both and returns one of them
    _, d64 = pair(np.ones(64), ["t"])
    assert xt.choose_conv_method(d64, small, measure=True) in ("direct",
                                                              "fft")


def test_convolve_direct_float32_and_four_dims():
    """float32 on the direct route at float32 grade, and a 4-D direct
    convolution, which torch has no single call for: a sum over the
    kernel's first axis of 3-D convolutions."""
    rng = np.random.RandomState(16)
    ra, da = pair(rng.randn(2, 40, 37).astype(np.float32), ["z", "y", "x"])
    rb, db = pair(rng.randn(5, 4).astype(np.float32), ["y", "x"])
    for mode in MODES:
        got, _ = check("convolve", [ra, rb], [da, db], "torch", 2e-6,
                       mode=mode, method="direct")
        assert got.data.dtype == torch.float32
    dims = ["a", "b", "c", "d"]
    ra, da = pair(rng.randn(2, 6, 5, 7, 6), ["z"] + dims)
    rb, db = pair(rng.randn(3, 2, 4, 3), dims)
    for mode in MODES:
        for fn in ("convolve", "correlate"):
            check(fn, [ra, rb], [da, db], "torch", 1e-12, dims=dims,
                  mode=mode, method="direct")
    assert xt.choose_conv_method(da, db, dims=dims) == (
        "direct" if 3 * 2 * 4 * 3 <= config.direct_conv_max else "fft")


def test_convolve_direct_complex64():
    """complex64 operands on the direct route: four real convolutions."""
    rng = np.random.RandomState(17)
    x = (rng.randn(24) + 1j * rng.randn(24)).astype(np.complex64)
    k = (rng.randn(6) + 1j * rng.randn(6)).astype(np.complex64)
    (ra, da), (rb, db) = pair(x, ["t"]), pair(k, ["t"])
    got, _ = check("convolve", [ra, rb], [da, db], "torch", 2e-6,
                   mode="same", method="direct")
    assert got.data.dtype == torch.complex64


def test_convolve_method_error_contracts():
    _, da = pair(np.ones((4, 8)), ["z", "t"])
    _, dk = pair(np.ones((4, 3)), ["z", "t"])
    with pytest.raises(ValueError, match="method='direct' is unavailable"):
        xt.convolve(da, dk, dims="t", mode="full", method="direct")
    with pytest.raises(ValueError, match="kernel is larger than the data"):
        xt.convolve(pair(np.ones(4), ["t"])[1], pair(np.ones(9), ["t"])[1],
                    method="direct")
    with pytest.raises(ValueError, match="method must be"):
        xt.convolve(da, pair(np.ones(3), ["t"])[1], method="bogus")
    bad = pair(np.ones(3), ["t"], {"t": np.arange(3) * 1.0})[1]
    bad.coords["t"] = Coord(("t",), np.arange(5) * 1.0, None, "t")
    with pytest.raises(ValueError, match="inconsistent coord"):
        xt.convolve(pair(np.ones(8), ["t"])[1], bad, method="direct")
    with pytest.raises(ValueError, match="mode must be"):
        xt.convolve(pair(np.ones(8), ["t"])[1], pair(np.ones(3), ["t"])[1],
                    mode="bogus", method="direct")


def test_error_contracts():
    _, da = pair(np.ones((4, 8)), ["z", "t"])
    _, dk = pair(np.ones(3), ["t"])
    with pytest.raises(ValueError, match="mode must be"):
        xt.fftconvolve(da, dk, dims="t", mode="bogus")
    with pytest.raises(ValueError, match="must be present in both"):
        xt.fftconvolve(da, dk, dims="z")
    with pytest.raises(ValueError, match="not present in the first"):
        xt.fftconvolve(dk, pair(np.ones((2, 3)), ["q", "t"])[1])
    with pytest.raises(ValueError, match="share no dims"):
        xt.fftconvolve(dk, pair(np.ones(3), ["s"])[1])
    with pytest.raises(ValueError, match="mismatched sizes"):
        xt.fftconvolve(da, pair(np.ones((3, 8)), ["z", "t"])[1], dims="t")
    with pytest.raises(ValueError, match="one operand must be at least"):
        xt.fftconvolve(pair(np.ones((4, 8)), ["z", "t"])[1],
                       pair(np.ones((6, 3)), ["z", "t"])[1], mode="valid")


@pytest.mark.parametrize("legacy", [None, True, False])
def test_full_fp32_restores_the_callers_cudnn_setting(legacy):
    """Inside full_fp32 cuDNN's convolutions run at "ieee" (full float32);
    on the way out the caller's conv, RNN and generic cuDNN precisions are
    back as they were, and the legacy allow_tf32 reads as before."""
    cudnn = torch.backends.cudnn
    saved = (cudnn.fp32_precision, cudnn.conv.fp32_precision,
             cudnn.rnn.fp32_precision)
    try:
        if legacy is not None:
            cudnn.allow_tf32 = legacy
        before = (cudnn.fp32_precision, cudnn.conv.fp32_precision,
                  cudnn.rnn.fp32_precision)
        allow = cudnn.allow_tf32
        with full_fp32():
            assert cudnn.conv.fp32_precision == "ieee"
            assert torch.get_float32_matmul_precision() == "highest"
        assert (cudnn.fp32_precision, cudnn.conv.fp32_precision,
                cudnn.rnn.fp32_precision) == before
        assert cudnn.allow_tf32 == allow
        cudnn.conv.fp32_precision = "tf32"     # the new API
        cudnn.rnn.fp32_precision = "ieee"
        with full_fp32():
            assert cudnn.conv.fp32_precision == "ieee"
        assert cudnn.conv.fp32_precision == "tf32"
        assert cudnn.rnn.fp32_precision == "ieee"
    finally:
        (cudnn.fp32_precision, cudnn.conv.fp32_precision,
         cudnn.rnn.fp32_precision) = saved


# ---------------------------------------------------------------------------
# oaconvolve
# ---------------------------------------------------------------------------


def _oa(n1, n2, seed, dims=("t",), coords=True):
    rng = np.random.RandomState(seed)
    ca = {"t": np.arange(n1) * 0.5} if coords else None
    cb = {"t": np.arange(n2) * 0.5} if coords else None
    return (pair(rng.randn(n1), list(dims), ca),
            pair(rng.randn(n2), list(dims), cb))


@pytest.mark.parametrize("impl", ["torch", "kernel"])
@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("n1,n2", [(5000, 64), (4096, 129), (3001, 17)])
def test_oaconvolve_parity(mode, n1, n2, impl):
    (ra, da), (rb, db) = _oa(n1, n2, 0)
    got, _ = check("oaconvolve", [ra, rb], [da, db], impl, 1e-12, dims="t",
                   mode=mode)
    want = sps.oaconvolve(np.asarray(ra.values), np.asarray(rb.values),
                          mode=mode)
    np.testing.assert_allclose(got.values, want, rtol=1e-9, atol=1e-10)
    ref = xt.fftconvolve(da, db, dims="t", mode=mode)
    np.testing.assert_allclose(got.values, ref.values, rtol=1e-9,
                               atol=1e-10)
    np.testing.assert_array_equal(got.coords["t"].values,
                                  ref.coords["t"].values)
    # real operands take rfftn/irfftn: under "matmul" the packed pair
    # engine's irfft, as xrft_tpu's fft_engine("matmul")
    with xrft_tpu.fft_engine("matmul"):
        ref_mm = xrft_tpu.oaconvolve(ra, rb, dims="t", mode=mode)
    with fft_impl("matmul"):
        got_mm = xt.oaconvolve(da, db, dims="t", mode=mode)
    assert_same(got_mm, ref_mm, 1e-12)
    np.testing.assert_allclose(got_mm.values, want, rtol=1e-9, atol=1e-10)


@pytest.mark.parametrize("impl", ["torch", "kernel"])
def test_oaconvolve_batched_and_kernel_broadcast(impl):
    rng = np.random.RandomState(1)
    ra, da = pair(rng.randn(3, 4000), ["z", "t"])
    rb, db = pair(rng.randn(65), ["t"])
    check("oaconvolve", [ra, rb], [da, db], impl, 1e-12, dims="t",
          mode="same")


@pytest.mark.parametrize("impl", ["torch", "kernel"])
def test_oaconvolve_transform_dim_not_last(impl):
    rng = np.random.RandomState(2)
    ra, da = pair(rng.randn(3000, 2), ["t", "z"])
    rb, db = pair(rng.randn(33, 2), ["t", "z"])
    check("oaconvolve", [ra, rb], [da, db], impl, 1e-12, dims="t")


@pytest.mark.parametrize("impl", IMPLS)
def test_oaconvolve_complex_input(impl):
    """Complex operands take fftn/ifftn, so the matmul engine runs them."""
    rng = np.random.RandomState(3)
    ra, da = pair(rng.randn(2500) + 1j * rng.randn(2500), ["t"])
    rb, db = pair(rng.randn(40) + 1j * rng.randn(40), ["t"])
    check("oaconvolve", [ra, rb], [da, db], impl, 1e-12, dims="t",
          mode="full")


@pytest.mark.parametrize("impl", IMPLS)
def test_oaconvolve_fallback_when_kernel_comparable(impl):
    (ra, da), (rb, db) = _oa(300, 200, 4, coords=False)
    check("oaconvolve", [ra, rb], [da, db], impl, 1e-12, dims="t")


@pytest.mark.parametrize("impl", IMPLS)
def test_oaconvolve_length_one_kernel(impl):
    (ra, da), (rb, db) = _oa(1000, 1, 5, coords=False)
    got, _ = check("oaconvolve", [ra, rb], [da, db], impl, 1e-12, dims="t")
    a, b = np.asarray(ra.values), np.asarray(rb.values)
    np.testing.assert_allclose(got.values, a * b[0], rtol=1e-9, atol=1e-10)


@pytest.mark.parametrize("impl", ["torch", "kernel"])
def test_oaconvolve_float32_through_k2(impl):
    """float32 blocks of nfft = 256 run K2 (rfft rows, and the Hermitian
    extension of the irfft) under "kernel"."""
    rng = np.random.RandomState(6)
    ra, da = pair(rng.randn(2, 2048).astype(np.float32), ["z", "t"])
    rb, db = pair(rng.randn(33).astype(np.float32), ["t"])
    got, _ = check("oaconvolve", [ra, rb], [da, db], impl, 2e-6, dims="t",
                   mode="same")
    assert got.data.dtype == torch.float32


def test_oaconvolve_error_contracts():
    rng = np.random.RandomState(7)
    _, da = pair(rng.randn(4, 100), ["z", "t"])
    _, db = pair(rng.randn(4, 10), ["z", "t"])
    with pytest.raises(ValueError, match="single long dim"):
        xt.oaconvolve(da, db)
    _, db2 = pair(rng.randn(3, 10), ["z", "t"])
    with pytest.raises(ValueError, match="mismatched"):
        xt.oaconvolve(da, db2, dims="t")
    with pytest.raises(ValueError, match="mode must be"):
        xt.oaconvolve(pair(rng.randn(5000), ["t"])[1],
                      pair(rng.randn(16), ["t"])[1], dims="t", mode="bogus")


def test_oaconvolve_block_path_validates_before_device_work():
    (_, da), (_, db) = _oa(5000, 64, 2)
    db.coords["t"] = Coord(("t",), np.arange(32) * 0.5, None, "t")
    with pytest.raises(ValueError, match="inconsistent coord"):
        xt.oaconvolve(da, db, dims="t")
    (_, da), (_, db2) = _oa(5000, 64, 2)
    with pytest.raises(ValueError, match="mode must be"):
        xt.oaconvolve(da, db2, dims="t", mode="bogus")
