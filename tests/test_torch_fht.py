"""fht, ifht and fhtoffset of xrft_tpu_torch against xrft_tpu on the CPU,
case for case as ``tests/test_fht.py``: even and odd lengths, Bessel orders,
bias and offset, the round trip, the analytic self-transform, the
log-spacing from the coordinate, the singular warnings and the error
contracts.  Even lengths take rfftn/irfftn (under "matmul" the packed pair
engine's irfft, also held against xrft_tpu's fft_engine("matmul")), odd
lengths fftn/ifftn; both run on all three fft_impl.  Tolerances: 1e-12 (float64) and 2e-6 (float32) of the largest |value|."""

import numpy as np
import pytest
import scipy.fft as sfft

torch = pytest.importorskip("torch")

import xrft_tpu
import xrft_tpu_torch as xt
from torch_parity import IMPLS, assert_same, check, pair
from xrft_tpu_torch.config import fft_impl


def _loggrid(n, lo=-4.0, hi=2.0):
    r = np.logspace(lo, hi, n)
    return r, float(np.log(r[1] / r[0]))


@pytest.mark.parametrize("mu", [0.0, 0.5, 2.0, -0.5])
@pytest.mark.parametrize("n", [64, 128, 63, 97])
def test_fht_parity(n, mu):
    r, dln = _loggrid(n)
    ref, da = pair(r ** (mu + 1) * np.exp(-(r ** 2) / 2), ["r"], {"r": r})
    want = sfft.fht(ref.values, dln, mu=mu)
    for impl in IMPLS:
        got, _ = check("fht", [ref], [da], impl, 1e-12, dln=dln, mu=mu,
                       dim="r")
        assert got.dims == ("freq_r",)
        np.testing.assert_allclose(got.values, want, rtol=1e-9, atol=1e-12)
    with xrft_tpu.fft_engine("matmul"):
        ref_mm = xrft_tpu.fht(ref, dln=dln, mu=mu, dim="r")
    with fft_impl("matmul"):
        assert_same(xt.fht(da, dln=dln, mu=mu, dim="r"), ref_mm, 1e-12)


@pytest.mark.parametrize("bias", [0.5, -1.0])
@pytest.mark.parametrize("n", [64, 63])
def test_fht_bias_and_offset_parity(n, bias):
    r, dln = _loggrid(n)
    offset = xt.fhtoffset(dln, 1.0, initial=0.3, bias=bias)
    assert offset == xrft_tpu.fhtoffset(dln, 1.0, initial=0.3, bias=bias)
    assert offset == pytest.approx(sfft.fhtoffset(dln, 1.0, initial=0.3,
                                                  bias=bias))
    ref, da = pair(r ** 2 * np.exp(-r), ["r"], {"r": r})
    for impl in IMPLS:
        for fn in ("fht", "ifht"):
            check(fn, [ref], [da], impl, 1e-12, dln=dln, mu=1.0,
                  offset=offset, bias=bias, dim="r")


@pytest.mark.parametrize("impl", ["torch", "kernel"])
@pytest.mark.parametrize("n", [128, 97])
def test_ifht_parity_and_roundtrip(n, impl):
    r, dln = _loggrid(n)
    a = r * np.exp(-(r ** 2) / 2)
    ref, da = pair(a, ["r"], {"r": r})
    A, A_ref = check("fht", [ref], [da], impl, 1e-12, dln=dln, mu=0.0,
                     dim="r")
    back, _ = check("ifht", [A_ref], [A], impl, 1e-12, dln=dln, mu=0.0,
                    dim="freq_r")
    assert back.dims == ("r",)
    np.testing.assert_allclose(back.values, a, rtol=1e-8, atol=1e-12)
    np.testing.assert_allclose(back.coords["r"].values, r, rtol=1e-10)


@pytest.mark.parametrize("impl", ["torch", "kernel"])
def test_analytic_self_transform(impl):
    """∫ r^{mu+1} e^{-r²/2} J_mu(kr) k dr = k^{mu+1} e^{-k²/2}; dln from
    the coordinate."""
    r = np.logspace(-7, 1, 128)
    dln = float(np.log(r[1] / r[0]))
    offset = xt.fhtoffset(dln, mu=0.0, initial=-6 * np.log(10))
    k = np.exp(offset) / r[::-1]
    ref, da = pair(r * np.exp(-(r ** 2) / 2), ["r"], {"r": r})
    out, _ = check("fht", [ref], [da], impl, 1e-12, mu=0.0, offset=offset,
                   dim="r")
    want = k * np.exp(-(k ** 2) / 2)
    sel = want > 1e-4 * want.max()
    np.testing.assert_allclose(out.values[sel], want[sel], rtol=1e-3)
    np.testing.assert_allclose(out.coords["freq_r"].values, k)


@pytest.mark.parametrize("impl", ["torch", "kernel"])
def test_dln_from_coordinate_and_batched(impl):
    r, dln = _loggrid(96)
    a = np.random.RandomState(0).randn(4, 96) * np.exp(-((np.log(r) / 3)
                                                        ** 2))
    ref, da = pair(a, ["z", "r"], {"r": r, "z": np.arange(4)})
    check("fht", [ref], [da], impl, 1e-12, mu=1.0, dim="r")
    ref_t, da_t = pair(a.T.copy(), ["r", "z"], {"r": r})
    check("fht", [ref_t], [da_t], impl, 1e-12, mu=1.0, dim="r")


@pytest.mark.parametrize("impl", ["torch", "kernel"])
def test_singular_warnings(impl):
    r, dln = _loggrid(32)
    ref, da = pair(np.exp(-r), ["r"], {"r": r})
    with pytest.warns(UserWarning, match="singular transform"):
        check("fht", [ref], [da], impl, 1e-12, dln=dln, mu=-1.0, bias=-2.0,
              dim="r")
    with pytest.warns(UserWarning, match="singular inverse"):
        check("ifht", [ref], [da], impl, 1e-12, dln=dln, mu=-1.0, bias=2.0,
              dim="r")


@pytest.mark.parametrize("impl", ["torch", "kernel"])
def test_float32_through_k2(impl):
    """float32 stays float32; n = 512 runs K2 (the rfft rows and the
    irfft's Hermitian extension) under "kernel"."""
    r, dln = _loggrid(512)
    a = (r * np.exp(-r)).astype(np.float32)
    ref, da = pair(np.stack([a, 2 * a]), ["z", "r"], {"r": r})
    got, _ = check("fht", [ref], [da], impl, 2e-6, mu=0.5, dim="r")
    assert got.data.dtype == torch.float32


def test_error_contracts():
    r, dln = _loggrid(32)
    _, nocoord = pair(np.exp(-r), ["r"])
    with pytest.raises(ValueError, match="no coordinate"):
        xt.fht(nocoord, mu=0.0, dim="r")
    _, lin = pair(np.exp(-r), ["r"], {"r": np.linspace(1.0, 2.0, 32)})
    with pytest.raises(ValueError, match="not uniformly logarithmically"):
        xt.fht(lin, mu=0.0, dim="r")
    _, neg = pair(np.exp(-r), ["r"], {"r": np.arange(32.0) - 5})
    with pytest.raises(ValueError, match="positive 1-D grid"):
        xt.fht(neg, mu=0.0, dim="r")
    _, cplx = pair(np.exp(-r) + 1j * r, ["r"], {"r": r})
    with pytest.raises(ValueError, match="must be real"):
        xt.fht(cplx, dln=dln, mu=0.0, dim="r")


@pytest.mark.parametrize("impl", ["torch", "kernel"])
def test_explicit_dln_overrides_and_no_coord_grid(impl):
    r, dln = _loggrid(64)
    ref, da = pair(np.exp(-r), ["r"])
    out, _ = check("fht", [ref], [da], impl, 1e-12, dln=dln, mu=0.0,
                   dim="r")
    assert "freq_r" not in out.coords
