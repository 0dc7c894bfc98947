"""czt and zoom_fft of xrft_tpu_torch against xrft_tpu on the CPU, case
for case as ``tests/test_czt.py``: the DFT circle, off-circle spirals,
bands and endpoints, complex input, the coordinate-aware ``fs`` default,
batch dims, the dynamic-range warning and the error contracts, under
fft_impl "torch", "kernel" and "matmul".  float32 takes K2's lengths
(chirp length 512).  Tolerances: 1e-12 (float64) and 2e-6 (float32) of the
largest |value| (1e-10 on the off-circle spirals, whose dynamic range the
float64 rounding of both packages scales)."""

import numpy as np
import pytest
import scipy.signal as sps

torch = pytest.importorskip("torch")

import xrft_tpu_torch as xt
from torch_parity import IMPLS, check, pair
from xrft_tpu_torch.czt import _cconst, _real_dtype


def make_1d(n, seed=0, complex=False, dtype=np.float64):
    rng = np.random.RandomState(seed)
    x = rng.randn(n) + (1j * rng.randn(n) if complex else 0)
    x = x if complex else x.real.astype(dtype)
    return pair(x, ["t"], {"t": np.arange(n) * 0.5}, name="u")


@pytest.mark.parametrize("impl", IMPLS)
@pytest.mark.parametrize("n", [64, 65])
def test_czt_default_equals_fft(n, impl):
    ref, da = make_1d(n)
    got, _ = check("czt", [ref], [da], impl, 1e-12)
    np.testing.assert_allclose(got.values, np.fft.fft(ref.values),
                               atol=1e-10 * n)


@pytest.mark.parametrize("impl", IMPLS)
@pytest.mark.parametrize("complex_input", [False, True])
@pytest.mark.parametrize("n", [64, 65])
def test_czt_spiral_parity(n, complex_input, impl):
    ref, da = make_1d(n, seed=2, complex=complex_input)
    m, w, a = 40, 0.999 * np.exp(-2j * np.pi / 40), 1.1 * np.exp(0.3j)
    got, _ = check("czt", [ref], [da], impl, 1e-10, m=m, w=w, a=a)
    want = sps.czt(np.asarray(ref.values), m=m, w=w, a=a)
    assert got.values.shape == (m,)
    assert np.abs(got.values - want).max() <= 1e-10 * np.abs(want).max()


@pytest.mark.parametrize("impl", IMPLS)
@pytest.mark.parametrize("endpoint", [False, True])
def test_zoom_fft_parity(endpoint, impl):
    ref, da = make_1d(128, seed=3)
    check("zoom_fft", [ref], [da], impl, 1e-12, fn=[10.0, 20.0], m=31,
          fs=100.0, endpoint=endpoint)
    check("zoom_fft", [ref], [da], impl, 1e-12, fn=15.0, m=16, fs=100.0,
          endpoint=endpoint)


@pytest.mark.parametrize("impl", IMPLS)
def test_zoom_fft_coordinate_aware_fs_and_freq_coord(impl):
    ref, da = make_1d(128, seed=4)        # spacing 0.5 -> fs = 2.0
    got, _ = check("zoom_fft", [ref], [da], impl, 1e-12, fn=[0.2, 0.8],
                   m=64)
    assert got.dims == ("freq_t",)
    np.testing.assert_allclose(got.coords["freq_t"].values,
                               0.2 + np.arange(64) * (0.6 / 64))
    np.testing.assert_allclose(got.coords["freq_t"].attrs["spacing"],
                               0.6 / 64)


@pytest.mark.parametrize("impl", IMPLS)
def test_zoom_fft_matches_dense_fft_on_grid(impl):
    ref, da = make_1d(256, seed=5)
    f = np.fft.fftfreq(256, d=0.5)
    got, _ = check("zoom_fft", [ref], [da], impl, 1e-12, fn=[f[8], f[24]],
                   m=16)
    want = np.fft.fft(ref.values)[8:24]
    assert np.abs(got.values - want).max() <= 1e-10 * np.abs(want).max()


@pytest.mark.parametrize("engine", ["xla", "matmul"])
def test_czt_engine_argument(engine):
    ref, da = make_1d(100, seed=6)
    check("czt", [ref], [da], "kernel", 1e-12, m=40, engine=engine)


@pytest.mark.parametrize("impl", IMPLS)
def test_czt_batch_dims_and_coords(impl):
    x = np.random.RandomState(7).randn(3, 50)
    ref, da = pair(x, ["z", "t"], {"z": np.arange(3.0), "t": np.arange(50.0)})
    out, _ = check("czt", [ref], [da], impl, 1e-12, dim="t", m=20)
    assert out.dims == ("z", "t")
    np.testing.assert_array_equal(out.coords["t"].values, np.arange(20))


@pytest.mark.parametrize("impl", ["torch", "kernel", "matmul"])
def test_float32_through_k2(impl):
    """float32 stays complex64; n = m = 256 makes a chirp of 512 points,
    which K2 runs under "kernel"."""
    ref, da = make_1d(256, seed=8, dtype=np.float32)
    got, _ = check("zoom_fft", [ref], [da], impl, 2e-6, fn=[0.2, 0.6],
                   m=256)
    assert got.data.dtype == torch.complex64
    got, _ = check("czt", [ref], [da], impl, 2e-6)
    assert got.data.dtype == torch.complex64


def test_czt_dynamic_range_warning():
    ref, da = pair(np.random.RandomState(9).randn(4096).astype(np.float32),
                   ["t"], {"t": np.arange(4096) * 1.0})
    with pytest.warns(UserWarning, match="chirp dynamic range"):
        xt.czt(da, m=512, w=0.99999 * np.exp(-2j * np.pi / 512))


def test_helpers_for_fht():
    """fht builds its constants with czt's helpers."""
    assert _real_dtype(torch.zeros(2, dtype=torch.complex64)) == \
        torch.float32
    assert _real_dtype(torch.zeros(2, dtype=torch.int32)) == torch.float64
    c = _cconst(np.array([1 + 2j, 3j]), torch.zeros(1, 2, 1), 1,
                torch.float32)
    assert c.shape == (1, 2, 1) and c.dtype == torch.complex64


def test_error_contracts():
    _, da = make_1d(16)
    with pytest.raises(ValueError, match="m must be a positive"):
        xt.czt(da, m=0)
    with pytest.raises(ValueError, match="w must be nonzero"):
        xt.czt(da, w=0.0)
    with pytest.raises(ValueError, match="fn must be a scalar"):
        xt.zoom_fft(da, [1.0, 2.0, 3.0])
    with pytest.raises(ValueError, match="m must be a positive"):
        xt.zoom_fft(da, 0.5, m=-1)
    with pytest.raises(ValueError, match="Unknown fft engine"):
        xt.czt(da, engine="bogus")
