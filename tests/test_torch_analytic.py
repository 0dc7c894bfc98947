"""hilbert, hilbert2 and envelope of xrft_tpu_torch against xrft_tpu on the
CPU, case for case as ``tests/test_analytic.py``, under fft_impl "torch",
"kernel" and "matmul" (each length here plans on the matmul engine).
Tolerances: 1e-12 (float64) and 2e-6 (float32) of the largest |value|."""

import numpy as np
import pytest
import scipy.signal as sps

torch = pytest.importorskip("torch")

import xrft_tpu_torch as xt
from torch_parity import IMPLS, check, pair
from xrft_tpu_torch.config import config, fft_impl


def make_1d(n, seed=0, dtype=np.float64):
    x = np.random.RandomState(seed).randn(n).astype(dtype)
    return pair(x, ["t"], {"t": np.arange(n) * 0.1}, name="u")


@pytest.mark.parametrize("impl", IMPLS)
@pytest.mark.parametrize("n", [128, 127])
def test_hilbert_parity(n, impl):
    ref, da = make_1d(n)
    got, _ = check("hilbert", [ref], [da], impl, 1e-12)
    assert got.data.dtype == torch.complex128
    x = np.asarray(ref.values)
    assert np.abs(got.values - sps.hilbert(x)).max() <= \
        1e-10 * np.abs(x).max() * n


@pytest.mark.parametrize("engine", ["xla", "matmul", "auto", None])
def test_hilbert_engine_argument(engine):
    """engine= maps onto fft_impl for the call ("xla" is "torch") and
    leaves config.fft_impl as it was."""
    ref, da = make_1d(96, seed=3)
    got, _ = check("hilbert", [ref], [da], "kernel", 1e-12, engine=engine)
    assert config.fft_impl == "torch"
    with pytest.raises(ValueError, match="Unknown fft engine"):
        xt.hilbert(da, engine="bogus")


def test_hilbert_preserves_coords_and_names():
    ref, da = make_1d(64, seed=5)
    out, _ = check("hilbert", [ref], [da], "torch", 1e-12)
    assert out.dims == ("t",) and out.name == "u_analytic"
    assert xt.envelope(da).name == "u_envelope"


@pytest.mark.parametrize("impl", IMPLS)
@pytest.mark.parametrize("dim", ["t", "z"])
def test_hilbert_batch_dim_axis_selection(dim, impl):
    x = np.random.RandomState(7).randn(3, 80)
    ref, da = pair(x, ["z", "t"], {"z": np.arange(3), "t": np.arange(80.0)})
    check("hilbert", [ref], [da], impl, 1e-12, dim=dim)


@pytest.mark.parametrize("impl", IMPLS)
def test_envelope_recovers_am_modulation(impl):
    t = np.arange(2048) / 2048.0
    am = 1.0 + 0.5 * np.sin(2 * np.pi * 3 * t)
    ref, da = pair(am * np.cos(2 * np.pi * 200 * t), ["t"], {"t": t})
    env, _ = check("envelope", [ref], [da], impl, 1e-12)
    np.testing.assert_allclose(env.values[100:-100], am[100:-100], rtol=2e-3)


@pytest.mark.parametrize("impl", IMPLS)
def test_hilbert_integer_input_and_complex_error(impl):
    """Integers promote as jnp.fft promotes them: int32 to complex64 (so
    "kernel" runs K2 at n = 256), int64 to complex128."""
    rng = np.random.RandomState(11)
    x = 5 * rng.randn(256)
    for dtype, tol, out in ((np.int32, 2e-6, torch.complex64),
                            (np.int64, 1e-12, torch.complex128)):
        ref, di = pair(x.astype(dtype), ["t"], {"t": np.arange(256)})
        got, _ = check("hilbert", [ref], [di], impl, tol)
        assert got.data.dtype == out
    _, dz = pair(rng.randn(32) + 1j * rng.randn(32), ["t"],
                 {"t": np.arange(32)})
    with pytest.raises(ValueError, match="must be real"):
        xt.hilbert(dz)


@pytest.mark.parametrize("impl", ["torch", "kernel"])
def test_hilbert_float32_through_k2(impl):
    """float32 stays float32 (complex64 out); under "kernel" it runs K2's
    plain version at n = 1000 (40 x 25)."""
    ref, da = make_1d(1000, seed=13, dtype=np.float32)
    got, _ = check("envelope", [ref], [da], impl, 2e-6)
    assert got.data.dtype == torch.float32
    got, _ = check("hilbert", [ref], [da], impl, 2e-6)
    assert got.data.dtype == torch.complex64


@pytest.mark.parametrize("impl", IMPLS)
@pytest.mark.parametrize("shape", [(12, 9), (8, 8), (7, 11)])
def test_hilbert2_parity(shape, impl):
    """Every even/odd shape cell, with the even-N Nyquist bin the 2-D mask
    zeroes."""
    x = np.random.RandomState(2).randn(*shape)
    ref, da = pair(x, ["y", "x"])
    got, _ = check("hilbert2", [ref], [da], impl, 1e-12)
    want = sps.hilbert2(x)
    assert np.abs(got.values - want).max() <= 1e-10 * np.abs(want).max()


@pytest.mark.parametrize("impl", IMPLS)
def test_hilbert2_batch_and_named_dims(impl):
    x = np.random.RandomState(4).randn(3, 10, 6)
    ref, da = pair(x, ["t", "y", "x"])
    check("hilbert2", [ref], [da], impl, 1e-12, dim=["y", "x"])
    check("hilbert2", [ref], [da], impl, 1e-12, dim=["t", "x"])


def test_hilbert2_error_contracts():
    rng = np.random.RandomState(5)
    _, da1 = pair(rng.randn(16), ["t"])
    with pytest.raises(ValueError, match="at least 2 dims"):
        xt.hilbert2(da1)
    _, da2 = pair(rng.randn(4, 4), ["y", "x"])
    with pytest.raises(ValueError, match="exactly 2"):
        xt.hilbert2(da2, dim="y")
    with pytest.raises(ValueError, match="exactly 2"):
        xt.hilbert2(da2, dim=["y"])
    with pytest.raises(ValueError, match="not found"):
        xt.hilbert2(da2, dim=["y", "q"])
    _, dz = pair(rng.randn(4, 4) + 1j, ["y", "x"])
    with pytest.raises(ValueError, match="must be real"):
        xt.hilbert2(dz)


@pytest.mark.parametrize("impl", ["torch", "kernel"])
def test_hilbert2_float32_through_k2(impl):
    """A float32 (256, 300) field: K2's plain version on both axes."""
    x = np.random.RandomState(6).randn(256, 300).astype(np.float32)
    ref, da = pair(x, ["y", "x"])
    got, _ = check("hilbert2", [ref], [da], impl, 2e-6)
    assert got.data.dtype == torch.complex64
    # a length K2 cannot run raises under "kernel": no fallback
    _, small = pair(x[:100, :100], ["y", "x"])
    with fft_impl("kernel"), pytest.raises(ValueError,
                                           match="four-step kernel"):
        xt.hilbert2(small)
