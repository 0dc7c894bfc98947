"""resample of xrft_tpu_torch against xrft_tpu on the CPU, case for case as
``tests/test_resample.py``: up, down and same, even and odd lengths, real
and complex input, the Nyquist bookkeeping, windows, ``domain="freq"``, the
coordinate rebuild and the error contracts, under fft_impl "torch",
"kernel" and "matmul" where the engine plans both lengths.  float32 takes
K2's lengths (4096 -> 3000 = 12 x 250).  Tolerances: 1e-12 (float64) and
2e-6 (float32) of the largest |value|."""

import numpy as np
import pytest
import scipy.signal as sps

torch = pytest.importorskip("torch")

import xrft_tpu_torch as xt
from torch_parity import IMPLS, check, pair
from xrft_tpu_torch.config import fft_impl


def make_1d(n, seed=0, complex=False, dx=0.5, dtype=np.float64):
    rng = np.random.RandomState(seed)
    x = rng.randn(n) + (1j * rng.randn(n) if complex else 0)
    x = x if complex else x.real.astype(dtype)
    return pair(x, ["t"], {"t": np.arange(n) * dx}, name="u")


@pytest.mark.parametrize("impl", IMPLS)
@pytest.mark.parametrize("complex_input", [False, True])
@pytest.mark.parametrize("n,num", [
    (16, 24), (16, 25), (15, 24), (15, 25),
    (16, 8), (16, 9), (15, 8), (15, 9),
    (16, 16), (15, 15),
    (2, 5), (2, 3), (4, 2),
])
def test_resample_parity(n, num, complex_input, impl):
    ref, da = make_1d(n, seed=1, complex=complex_input)
    got, _ = check("resample", [ref], [da], impl, 1e-12, num=num)
    want = sps.resample(np.asarray(ref.values), num)
    assert got.values.shape == (num,)
    assert got.data.is_complex() == complex_input
    assert np.abs(got.values - want).max() <= \
        1e-12 * max(1.0, np.abs(want).max())


@pytest.mark.parametrize("impl", IMPLS)
def test_resample_bandlimited_exact(impl):
    def f(s):
        return np.sin(2 * np.pi * 3 * s) + 0.5 * np.cos(2 * np.pi * 5 * s)

    t = np.arange(32) / 32
    ref, da = pair(f(t), ["t"], {"t": t})
    got, _ = check("resample", [ref], [da], impl, 1e-12, num=96)
    np.testing.assert_allclose(got.values, f(np.arange(96) / 96), atol=1e-12)


@pytest.mark.parametrize("impl", IMPLS)
@pytest.mark.parametrize("window", ["hann", ("kaiser", 5.0),
                                    ("tukey", 0.25)])
@pytest.mark.parametrize("n", [16, 15])
def test_resample_window_string_parity(n, window, impl):
    ref, da = make_1d(n, seed=2)
    check("resample", [ref], [da], impl, 1e-12, num=11, window=window)


@pytest.mark.parametrize("impl", IMPLS)
def test_resample_window_callable_and_array(impl):
    ref, da = make_1d(20, seed=3, complex=True)
    check("resample", [ref], [da], impl, 1e-12, num=30,
          window=lambda freqs: np.exp(-(freqs / 0.25) ** 2))
    check("resample", [ref], [da], impl, 1e-12, num=12,
          window=np.random.RandomState(4).rand(20))


@pytest.mark.parametrize("impl", IMPLS)
def test_resample_domain_freq(impl):
    X = np.fft.fft(np.random.RandomState(5).randn(24)
                   + 1j * np.random.RandomState(6).randn(24))
    ref, da = pair(X, ["t"], {"t": np.arange(24.0)})
    check("resample", [ref], [da], impl, 1e-12, num=15, domain="freq")


def test_resample_coordinate_rebuild_matches_scipy_t():
    ref, da = make_1d(16, seed=6, dx=0.5)
    out, _ = check("resample", [ref], [da], "torch", 1e-12, num=24)
    _, new_t = sps.resample(ref.values, 24, t=np.arange(16) * 0.5)
    np.testing.assert_allclose(out.coords["t"].values, new_t, atol=1e-14)
    ref2, dd = pair(np.asarray(ref.values), ["t"],
                    {"t": np.arange(16)[::-1] * 2.0})
    o2, _ = check("resample", [ref2], [dd], "torch", 1e-12, num=8)
    np.testing.assert_allclose(o2.coords["t"].values,
                               30.0 + np.arange(8) * (-2.0 * 16 / 8),
                               atol=1e-12)


@pytest.mark.parametrize("impl", IMPLS)
def test_resample_batch_dims_and_other_coords(impl):
    x = np.random.RandomState(7).randn(3, 20)
    ref, da = pair(x, ["z", "t"], {"z": np.arange(3.0), "t": np.arange(20.0)})
    out, _ = check("resample", [ref], [da], impl, 1e-12, num=30, dim="t")
    assert out.sizes["t"] == 30
    check("resample", [ref], [da], impl, 1e-12, num=5, dim="z")


@pytest.mark.parametrize("engine", ["xla", "matmul"])
def test_resample_engine_argument(engine):
    ref, da = make_1d(32, seed=8)
    check("resample", [ref], [da], "kernel", 1e-12, num=48, engine=engine)


@pytest.mark.parametrize("impl", IMPLS)
def test_float32_through_k2(impl):
    """The flagship's resampling cut to one row: 4096 -> 3000 in float32,
    whose inverse length 3000 = 12 x 250 runs K2 under "kernel"; a length
    with a prime factor above 256 raises there, with no fallback."""
    ref, da = make_1d(4096, seed=9, dtype=np.float32)
    got, _ = check("resample", [ref], [da], impl, 2e-6, num=3000)
    assert got.data.dtype == torch.float32
    if impl == "kernel":
        with fft_impl("kernel"), pytest.raises(ValueError,
                                               match="four-step kernel"):
            xt.resample(da, 2 * 257)


def test_resample_error_contracts():
    _, da = make_1d(16)
    with pytest.raises(ValueError, match="domain must be"):
        xt.resample(da, 8, domain="nope")
    with pytest.raises(ValueError, match="num must be a positive"):
        xt.resample(da, 0)
    with pytest.raises(ValueError, match="window array must have shape"):
        xt.resample(da, 8, window=np.ones(7))
