"""firwin, upfirdn, resample_poly, decimate, savgol_coeffs and
savgol_filter of xrft_tpu_torch against xrft_tpu on the CPU, case for case
as ``tests/test_filter.py``: scipy's band configurations, every up/down
cell, the padtypes, both phase conventions of decimate, every savgol mode,
the coordinate rebuild and the error contracts.  The FFT convolutions run
under fft_impl "torch", "kernel" and "matmul"; float32 signals take K2's
lengths.  Tolerances: 1e-12 (float64) and 2e-6 (float32) of the largest
|value|."""

import numpy as np
import pytest
import scipy.signal as sps

torch = pytest.importorskip("torch")

import xrft_tpu
import xrft_tpu_torch as xt
from torch_parity import IMPLS, check, pair
from xrft_tpu_torch.config import fft_impl


def make_1d(n=50, seed=0, dtype=np.float64):
    x = np.random.RandomState(seed).randn(n).astype(dtype)
    return pair(x, ["t"], {"t": 2.0 + np.arange(n) * 0.25}, name="u")


FIRWIN = [
    dict(numtaps=31, cutoff=0.3),
    dict(numtaps=64, cutoff=0.2, pass_zero="lowpass"),
    dict(numtaps=33, cutoff=0.4, pass_zero="highpass"),
    dict(numtaps=41, cutoff=[0.2, 0.5], pass_zero="bandpass"),
    dict(numtaps=41, cutoff=[0.2, 0.5], pass_zero="bandstop"),
    dict(numtaps=42, cutoff=[0.1, 0.3, 0.5, 0.8], pass_zero=False),
    dict(numtaps=55, cutoff=0.25, width=0.08),
    dict(numtaps=21, cutoff=300, fs=2000, window="blackman"),
    dict(numtaps=21, cutoff=0.3, scale=False),
]


@pytest.mark.parametrize("kwargs", FIRWIN)
def test_firwin_parity(kwargs):
    got = xt.firwin(**kwargs)
    np.testing.assert_array_equal(got, xrft_tpu.firwin(**kwargs))
    np.testing.assert_allclose(got, sps.firwin(**kwargs), atol=1e-15)


def test_firwin_error_contracts():
    with pytest.raises(ValueError, match="Invalid cutoff frequency"):
        xt.firwin(11, 1.5)
    with pytest.raises(ValueError, match="strictly increasing"):
        xt.firwin(11, [0.5, 0.2])
    with pytest.raises(ValueError, match="even number of coefficients"):
        xt.firwin(10, 0.5, pass_zero=False)
    with pytest.raises(ValueError, match="one element"):
        xt.firwin(11, [0.2, 0.4], pass_zero="lowpass")
    with pytest.raises(ValueError, match="at least two"):
        xt.firwin(11, 0.2, pass_zero="bandpass")
    with pytest.raises(ValueError, match="not in"):
        xt.firwin(11, 0.2, pass_zero="nope")


@pytest.mark.parametrize("impl", IMPLS)
@pytest.mark.parametrize("up,down,taps", [
    (1, 1, 7), (3, 1, 11), (1, 4, 9), (3, 5, 21), (7, 3, 16), (2, 2, 5),
])
def test_upfirdn_parity(up, down, taps, impl):
    ref, da = make_1d()
    h = np.random.RandomState(taps).randn(taps)
    got, _ = check("upfirdn", [h, ref], [h, da], impl, 1e-12, up=up,
                   down=down)
    want = sps.upfirdn(h, np.asarray(ref.values), up, down)
    assert got.values.shape == want.shape
    np.testing.assert_allclose(got.values, want, atol=1e-12)


@pytest.mark.parametrize("impl", IMPLS)
def test_upfirdn_complex_and_batch(impl):
    rng = np.random.RandomState(3)
    ref, da = pair(rng.randn(4, 30) + 1j * rng.randn(4, 30), ["b", "t"])
    h = rng.randn(9)
    check("upfirdn", [h, ref], [h, da], impl, 1e-12, up=2, down=3, dim="t")


def test_upfirdn_error_contracts():
    _, da = make_1d()
    with pytest.raises(NotImplementedError, match="pre-pad"):
        xt.upfirdn(np.ones(3), da, mode="wrap")
    with pytest.raises(ValueError, match="must be >= 1"):
        xt.upfirdn(np.ones(3), da, up=0)
    with pytest.raises(ValueError, match="1-D"):
        xt.upfirdn(np.ones((3, 3)), da)


@pytest.mark.parametrize("impl", IMPLS)
@pytest.mark.parametrize("padtype", ["constant", "mean", "maximum",
                                     "median", "minimum"])
@pytest.mark.parametrize("up,down", [(2, 3), (3, 2), (5, 1), (1, 5),
                                     (7, 6)])
def test_resample_poly_parity(up, down, padtype, impl):
    ref, da = make_1d()
    got, _ = check("resample_poly", [ref], [da], impl, 1e-12, up=up,
                   down=down, padtype=padtype)
    want = sps.resample_poly(np.asarray(ref.values), up, down,
                             padtype=padtype)
    np.testing.assert_allclose(got.values, want, atol=1e-12)


@pytest.mark.parametrize("impl", IMPLS)
def test_resample_poly_explicit_window_taps(impl):
    ref, da = make_1d(seed=5)
    check("resample_poly", [ref], [da], impl, 1e-12, up=2, down=1,
          window=sps.firwin(33, 0.4))


def test_resample_poly_coordinate_rebuild():
    ref, da = make_1d()
    out, _ = check("resample_poly", [ref], [da], "torch", 1e-12, up=3,
                   down=2)
    np.testing.assert_allclose(
        out.coords["t"].values,
        2.0 + np.arange(out.sizes["t"]) * (0.25 * 2 / 3), atol=1e-12)
    same, _ = check("resample_poly", [ref], [da], "torch", 1e-12, up=4,
                    down=4)
    np.testing.assert_array_equal(same.coords["t"].values,
                                  da.coords["t"].values)


@pytest.mark.parametrize("impl", IMPLS)
def test_resample_poly_sine_preserved(impl):
    t = np.arange(600) / 100.0
    ref, da = pair(np.sin(2 * np.pi * 3.0 * t), ["t"], {"t": t})
    out, _ = check("resample_poly", [ref], [da], impl, 1e-12, up=2, down=3)
    want = np.sin(2 * np.pi * 3.0 * out.coords["t"].values)
    np.testing.assert_allclose(out.values[20:-20], want[20:-20], atol=1e-2)


@pytest.mark.parametrize("impl", ["torch", "kernel", "matmul"])
def test_float32_through_k2(impl):
    """float32 stays float32: resample_poly, decimate and upfirdn of a
    (2, 300) float32 signal, whose padded convolutions (512 and 1024
    points) run K2 under "kernel"."""
    x = np.random.RandomState(9).randn(2, 300).astype(np.float32)
    ref, da = pair(x, ["z", "t"], {"t": np.arange(300) * 0.5})
    for fn, kw in (("resample_poly", dict(up=3, down=2)),
                   ("resample_poly", dict(up=2, down=3, padtype="mean")),
                   ("decimate", dict(q=4)),
                   ("decimate", dict(q=3, zero_phase=False))):
        got, _ = check(fn, [ref], [da], impl, 2e-6, **kw)
        assert got.data.dtype == torch.float32
    h = xt.firwin(31, 0.3)
    got, _ = check("upfirdn", [h, ref], [h, da], impl, 2e-6, up=2, down=1)
    assert got.data.dtype == torch.float32


def test_resample_poly_error_contracts():
    _, da = make_1d()
    with pytest.raises(ValueError, match="no effect"):
        xt.resample_poly(da, 2, 3, padtype="mean", cval=1.0)
    with pytest.raises(NotImplementedError, match="pre-pad"):
        xt.resample_poly(da, 2, 3, padtype="edge")
    with pytest.raises(NotImplementedError, match="nonzero cval"):
        xt.resample_poly(da, 2, 3, cval=1.0)
    with pytest.raises(ValueError, match=">= 1"):
        xt.resample_poly(da, 0, 3)
    with pytest.raises(ValueError, match="window must be 1-D"):
        xt.resample_poly(da, 2, 3, window=np.ones((3, 3)))


@pytest.mark.parametrize("impl", IMPLS)
@pytest.mark.parametrize("q", [2, 3, 5])
@pytest.mark.parametrize("zero_phase", [True, False])
def test_decimate_parity(q, zero_phase, impl):
    ref, da = make_1d()
    got, _ = check("decimate", [ref], [da], impl, 1e-12, q=q,
                   zero_phase=zero_phase)
    want = sps.decimate(np.asarray(ref.values), q, ftype="fir",
                        zero_phase=zero_phase)
    np.testing.assert_allclose(got.values, want, atol=1e-12)
    assert got.name == "u_decimated"


def test_decimate_custom_order_and_coords():
    ref, da = make_1d()
    got, _ = check("decimate", [ref], [da], "kernel", 1e-12, q=2, n=24)
    np.testing.assert_allclose(got.coords["t"].values,
                               2.0 + np.arange(got.sizes["t"]) * 0.5,
                               atol=1e-12)


def test_decimate_iir_prescriptive_error():
    _, da = make_1d()
    with pytest.raises(NotImplementedError, match="ftype='fir'"):
        xt.decimate(da, 2, ftype="iir")
    with pytest.raises(ValueError, match="must be 'fir'"):
        xt.decimate(da, 2, ftype="cic")
    with pytest.raises(ValueError, match="positive integer"):
        xt.decimate(da, 0)


@pytest.mark.parametrize("kwargs", [
    dict(window_length=5, polyorder=2),
    dict(window_length=7, polyorder=3, deriv=1, delta=0.5),
    dict(window_length=8, polyorder=3),
    dict(window_length=9, polyorder=4, deriv=2),
    dict(window_length=11, polyorder=2, pos=3),
    dict(window_length=7, polyorder=2, use="dot"),
    dict(window_length=5, polyorder=2, deriv=3),
])
def test_savgol_coeffs_parity(kwargs):
    got = xt.savgol_coeffs(**kwargs)
    np.testing.assert_array_equal(got, xrft_tpu.savgol_coeffs(**kwargs))
    np.testing.assert_allclose(got, sps.savgol_coeffs(**kwargs), atol=1e-12)


@pytest.mark.parametrize("impl", IMPLS)
@pytest.mark.parametrize("mode", ["interp", "mirror", "nearest",
                                  "constant", "wrap"])
@pytest.mark.parametrize("window_length,polyorder,deriv", [
    (5, 2, 0), (7, 3, 1), (8, 3, 0), (11, 4, 2),
])
def test_savgol_filter_parity(mode, window_length, polyorder, deriv, impl):
    ref, da = make_1d(n=60, seed=7)
    kw = dict(window_length=window_length, polyorder=polyorder, deriv=deriv,
              delta=0.7, mode=mode, cval=1.5)
    got, _ = check("savgol_filter", [ref], [da], impl, 1e-12, **kw)
    want = sps.savgol_filter(np.asarray(ref.values), **kw)
    np.testing.assert_allclose(got.values, want, atol=1e-10)


@pytest.mark.parametrize("impl", IMPLS)
def test_savgol_filter_batch_middle_dim(impl):
    x = np.random.RandomState(11).randn(4, 33, 3)
    ref, da = pair(x, ["b", "y", "c"], {"y": 1.0 + 0.5 * np.arange(33)})
    out, _ = check("savgol_filter", [ref], [da], impl, 1e-12,
                   window_length=9, polyorder=3, deriv=1, delta=0.5, dim="y")
    np.testing.assert_allclose(
        out.values, sps.savgol_filter(x, 9, 3, deriv=1, delta=0.5, axis=1),
        atol=1e-10)


@pytest.mark.parametrize("impl", IMPLS)
def test_savgol_filter_recovers_polynomial(impl):
    t = np.linspace(0, 1, 41)
    x = 3.0 - 2.0 * t + 0.5 * t ** 2
    ref, da = pair(x, ["t"], {"t": t})
    out, _ = check("savgol_filter", [ref], [da], impl, 1e-12,
                   window_length=9, polyorder=2, mode="interp")
    np.testing.assert_allclose(out.values, x, atol=1e-10)
    d1, _ = check("savgol_filter", [ref], [da], impl, 1e-12,
                  window_length=9, polyorder=2, deriv=1, delta=t[1] - t[0],
                  mode="interp")
    np.testing.assert_allclose(d1.values, -2.0 + 1.0 * t, atol=1e-9)


@pytest.mark.parametrize("impl", ["torch", "kernel"])
@pytest.mark.parametrize("mode", ["interp", "mirror", "wrap"])
def test_savgol_filter_float32_through_k2(mode, impl):
    """float32 stays float32 (the interp edges are float32 products at
    full grade); the padded convolution of 400 + 100 points runs K2 at
    512."""
    x = np.random.RandomState(12).randn(3, 400).astype(np.float32)
    ref, da = pair(x, ["z", "t"])
    got, _ = check("savgol_filter", [ref], [da], impl, 2e-6,
                   window_length=101, polyorder=3, mode=mode)
    assert got.data.dtype == torch.float32


def test_savgol_error_contracts():
    _, da = make_1d(n=10)
    with pytest.raises(ValueError, match="polyorder must be less"):
        xt.savgol_filter(da, 5, 7)
    with pytest.raises(ValueError, match="window_length must be less"):
        xt.savgol_filter(da, 15, 2, mode="interp")
    with pytest.raises(ValueError, match="mode must be"):
        xt.savgol_filter(da, 5, 2, mode="bogus")
    with pytest.raises(ValueError, match="pos must be nonnegative"):
        xt.savgol_coeffs(5, 2, pos=9)
    with pytest.raises(ValueError, match="'conv' or 'dot'"):
        xt.savgol_coeffs(5, 2, use="x")
    _, dz = pair(np.ones(10) + 1j, ["t"])
    with pytest.raises(ValueError, match="must be real"):
        xt.savgol_filter(dz, 5, 2)
    with fft_impl("kernel"), pytest.raises(ValueError,
                                           match="four-step kernel"):
        xt.savgol_filter(pair(np.ones(10, np.float32), ["t"])[1], 5, 2)
