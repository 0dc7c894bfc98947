"""stft/istft of xrft_tpu_torch against xrft_tpu on the CPU, and the
roundtrip.  The forward runs under ``fft_impl="torch"`` and ``"matmul"``;
the inverse, an irfft, under ``"torch"`` and, on the matmul engine's packed
pair-engine inverse, under ``"matmul"``.

Tolerances, relative to the largest |value|: 1e-12 in float64, 2e-6 in
float32; the roundtrip to 1e-6 (float64: the scale, window and
normalisation constants are float32, as in xrft_tpu) and 1e-5 (float32) of
max|x|.
"""

import numpy as np
import numpy.testing as npt
import pytest

torch = pytest.importorskip("torch")

import xrft_tpu
import xrft_tpu_torch as xt
from xrft_tpu_torch.config import fft_impl
from xrft_tpu_torch.interop import from_reference

TOL = {np.float32: 2e-6, np.float64: 1e-12}
ROUNDTRIP = {np.float32: 1e-5, np.float64: 1e-6}


def _series(n, dtype, seed=0):
    rng = np.random.RandomState(seed)
    ref = xrft_tpu.LabeledArray(
        rng.randn(2, n).astype(dtype), dims=("time", "t"),
        coords={"time": np.arange(2.0), "t": np.arange(n) * 0.05 + 1.0},
        name="sig")
    return ref, from_reference(ref, device="cpu")


def assert_same(got, ref, tol):
    assert tuple(got.dims) == tuple(ref.dims)
    assert got.name == ref.name
    assert got.attrs.keys() == ref.attrs.keys()
    for k, v in ref.attrs.items():
        assert got.attrs[k] == v, k
    assert set(got.coords) == set(ref.coords)
    for c in ref.coords:
        npt.assert_array_equal(got.coords[c].values, ref.coords[c].values)
        assert dict(got.coords[c].attrs).keys() == \
            dict(ref.coords[c].attrs).keys()
    r = np.asarray(ref.values)
    g = got.values
    assert g.shape == r.shape and g.dtype.kind == r.dtype.kind
    assert np.abs(g - r).max() <= tol * np.abs(r).max()


CASES = {
    "default": dict(seglen=64),
    "odd_seglen": dict(seglen=45, segment_overlap=20),
    "no_boundary": dict(seglen=64, boundary=None, padded=False,
                        segment_overlap=48, window="hamming"),
    "psd": dict(seglen=32, scaling="psd", window="hamming"),
}


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
@pytest.mark.parametrize("case", sorted(CASES))
def test_stft_istft_match_reference(case, dtype):
    ref, da = _series(300, dtype, seed=len(case))
    kw = CASES[case]
    Z_ref = xrft_tpu.stft(ref, dim="t", **kw)
    Z = xt.stft(da, dim="t", **kw)
    assert_same(Z, Z_ref, TOL[dtype])
    if case != "odd_seglen":
        with fft_impl("matmul"):
            assert_same(xt.stft(da, dim="t", **kw), Z_ref, TOL[dtype])
    back_ref = xrft_tpu.istft(Z_ref)
    back = xt.istft(Z)
    assert_same(back, back_ref, TOL[dtype])
    x = da.values
    err = np.abs(back.values - x[:, :back.sizes["t"]]).max() / np.abs(x).max()
    if case != "no_boundary":
        assert back.sizes["t"] == 300
    assert err <= ROUNDTRIP[dtype]


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
def test_istft_under_matmul(dtype):
    """istft takes irfftn: under "matmul" the pair engine's packed inverse,
    against xrft_tpu's fft_engine("matmul") and the roundtrip limit."""
    ref, da = _series(128, dtype)
    with xrft_tpu.fft_engine("matmul"):
        back_ref = xrft_tpu.istft(xrft_tpu.stft(ref, dim="t", seglen=32))
    with fft_impl("matmul"):
        back = xt.istft(xt.stft(da, dim="t", seglen=32))
    assert_same(back, back_ref, TOL[dtype])
    x = da.values
    err = np.abs(back.values - x[:, :back.sizes["t"]]).max() / np.abs(x).max()
    assert back.sizes["t"] == 128 and err <= ROUNDTRIP[dtype]
