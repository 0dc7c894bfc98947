"""The DCT/DST family of xrft_tpu_torch against xrft_tpu on the CPU, case
for case as ``tests/test_trig.py``: every (type, norm, parity) cell under
fft_impl "torch", "kernel" and "matmul", the round trips, batch dims, the N-D
forms and the error contracts.  float32 runs K2's lengths (N = 300: DCT-I
at 598 = 26 x 23, DST-I at 602 = 43 x 14).  Tolerances: 1e-12 (float64)
and 2e-6 (float32) of the largest |value|."""

import numpy as np
import pytest
import scipy.fft as sfft

torch = pytest.importorskip("torch")

import xrft_tpu
import xrft_tpu_torch as xt
from torch_parity import IMPLS, assert_same, check, pair
from xrft_tpu_torch.config import fft_impl

TYPES = [1, 2, 3, 4]
NORMS = [None, "backward", "ortho", "forward"]
FUNCS = ("dct", "dst", "idct", "idst")


def make_1d(n, seed=0, dtype=np.float64):
    x = np.random.RandomState(seed).randn(n).astype(dtype)
    return pair(x, ["t"], {"t": np.arange(n) * 0.5}, name="u")


def make_3d(shape=(5, 8, 9), seed=7, dtype=np.float64):
    x = np.random.RandomState(seed).randn(*shape).astype(dtype)
    return pair(x, ["z", "y", "x"], name="u")


@pytest.mark.parametrize("impl", IMPLS)
@pytest.mark.parametrize("n", [16, 17])
@pytest.mark.parametrize("norm", NORMS)
@pytest.mark.parametrize("type", TYPES)
def test_dct_dst_parity(type, norm, n, impl):
    """Every (type, norm, even/odd N) cell of the four 1-D functions."""
    ref, da = make_1d(n)
    x = np.asarray(ref.values)
    for fn in FUNCS:
        got, _ = check(fn, [ref], [da], impl, 1e-12, type=type, norm=norm)
        want = getattr(sfft, fn)(x, type=type, norm=norm)
        assert np.abs(got.values - want).max() <= 1e-12 * np.abs(want).max()


@pytest.mark.parametrize("engine", ["xla", "matmul"])
def test_dct_engine_argument(engine):
    """engine= per call; the odd length 33 = 3 x 11 on both engines."""
    ref, da = make_1d(33, seed=3)
    for type in TYPES:
        check("dct", [ref], [da], "kernel", 1e-12, type=type, norm="ortho",
              engine=engine)
        check("dst", [ref], [da], "kernel", 1e-12, type=type, engine=engine)


@pytest.mark.parametrize("impl", IMPLS)
@pytest.mark.parametrize("norm", NORMS)
@pytest.mark.parametrize("type", TYPES)
def test_round_trips(type, norm, impl):
    ref, da = make_1d(24, seed=5)
    x = np.asarray(ref.values)
    with fft_impl(impl):
        rt = xt.idct(xt.dct(da, type=type, norm=norm), type=type, norm=norm)
        rs = xt.idst(xt.dst(da, type=type, norm=norm), type=type, norm=norm)
    assert np.abs(rt.values - x).max() <= 1e-12
    assert np.abs(rs.values - x).max() <= 1e-12


@pytest.mark.parametrize("impl", IMPLS)
def test_batch_dims_and_axis_selection(impl):
    x = np.random.RandomState(7).randn(3, 40)
    ref, da = pair(x, ["z", "t"], {"z": np.arange(3.0), "t": np.arange(40.0)})
    check("dct", [ref], [da], impl, 1e-12, dim="t")
    check("dst", [ref], [da], impl, 1e-12, dim="z", type=3)


def test_coords_names_pass_through():
    ref, da = make_1d(16, seed=9)
    out, _ = check("dct", [ref], [da], "torch", 1e-12)
    assert out.dims == ("t",) and out.name == "u_dct"
    assert xt.idst(da).name == "u_idst"


@pytest.mark.parametrize("impl", ["torch", "kernel", "matmul"])
@pytest.mark.parametrize("type", TYPES)
def test_float32_through_k2(type, impl):
    """float32 stays float32; under "kernel" every type's FFT runs K2
    (300, 598 and 602 points), and a DCT-II low-pass round trip holds."""
    ref, da = make_1d(300, seed=11, dtype=np.float32)
    for fn in FUNCS:
        got, _ = check(fn, [ref], [da], impl, 2e-6, type=type, norm="ortho")
        assert got.data.dtype == torch.float32
    with fft_impl(impl):
        c = xt.dct(da, type=2, norm="ortho")
        back = xt.idct(c.copy(data=c.data * (torch.arange(300) < 40)),
                       type=2, norm="ortho")
    want = sfft.dct(np.asarray(ref.values, np.float64), norm="ortho")
    want[40:] = 0.0
    want = sfft.idct(want, norm="ortho")
    assert np.abs(back.values - want).max() <= 2e-6 * np.abs(want).max()


def test_dst1_extension_lengths_at_4096():
    """At N = 4096 DCT-I and DST-I transform 8190 = 90 x 91 and
    8194 = 34 x 241 points: K2 runs both under "kernel"; under "matmul" the
    stacked engine plans 8190, and 8194, with its prime factor 241 above
    direct_dft_max = 128, goes to the pair engine, whose K2 step takes the
    whole length (as xrft_tpu's fft_engine("matmul") takes its einsum
    recursion)."""
    ref, da = make_1d(4096, seed=1, dtype=np.float32)
    for impl in IMPLS:
        check("dst", [ref], [da], impl, 2e-6, type=1)
        check("dct", [ref], [da], impl, 2e-6, type=1)
    with xrft_tpu.fft_engine("matmul"):
        want = xrft_tpu.dst(ref, type=1)
    with fft_impl("matmul"):
        assert_same(xt.dst(da, type=1), want, 2e-6)


def test_error_contracts():
    _, da = make_1d(8)
    with pytest.raises(ValueError, match="type must be 1, 2, 3 or 4"):
        xt.dct(da, type=5)
    with pytest.raises(ValueError, match="invalid norm"):
        xt.dct(da, norm="bogus")
    with pytest.raises(ValueError, match="invalid norm"):
        xt.idst(da, norm="bogus")
    _, d1 = pair(np.ones(1), ["t"], {"t": [0.0]})
    with pytest.raises(ValueError, match="DCT-I requires"):
        xt.dct(d1, type=1)
    _, dz = pair(np.ones(8) + 1j, ["t"], {"t": np.arange(8.0)})
    with pytest.raises(ValueError, match="must be real"):
        xt.dct(dz)
    with pytest.raises(ValueError, match="Unknown fft engine"):
        xt.dct(da, engine="pallas")


@pytest.mark.parametrize("impl", IMPLS)
def test_neumann_poisson_solve(impl):
    """DCT-II diagonalizes the Neumann-BC 1-D Laplacian: the spectral
    solve matches a dense finite-difference solve and xrft_tpu's."""
    n = 64
    f = np.random.RandomState(13).randn(n)
    f -= f.mean()
    A = -2.0 * np.eye(n) + np.eye(n, k=1) + np.eye(n, k=-1)
    A[0, 0] = A[-1, -1] = -1.0
    u_dense = np.linalg.lstsq(A, f, rcond=None)[0]
    ref, da = pair(f, ["x"], {"x": np.arange(n) * 1.0})
    fh, _ = check("dct", [ref], [da], impl, 1e-12, type=2)
    lam = 2.0 * np.cos(np.pi * np.arange(n) / n) - 2.0
    uh = np.zeros(n)
    uh[1:] = fh.values[1:] / lam[1:]
    ref_h, dah = pair(uh, ["x"], {"x": np.arange(n) * 1.0})
    u, _ = check("idct", [ref_h], [dah], impl, 1e-12, type=2)
    u = u.values - u.values.mean()
    np.testing.assert_allclose(u, u_dense - u_dense.mean(), atol=1e-9)


@pytest.mark.parametrize("impl", IMPLS)
@pytest.mark.parametrize("norm", NORMS)
@pytest.mark.parametrize("type", TYPES)
def test_dctn_dstn_parity(type, norm, impl):
    """dctn/dstn/idctn/idstn over a dim subset and over all dims."""
    ref, da = make_3d()
    for fn in ("dctn", "dstn", "idctn", "idstn"):
        check(fn, [ref], [da], impl, 1e-12, dim=["y", "x"], type=type,
              norm=norm)
    got, _ = check("dctn", [ref], [da], impl, 1e-12, type=type, norm=norm)
    want = sfft.dctn(np.asarray(ref.values), type=type, norm=norm)
    assert np.abs(got.values - want).max() <= 1e-11 * np.abs(want).max()
    assert got.name == "u_dctn"


@pytest.mark.parametrize("impl", ["torch", "kernel"])
@pytest.mark.parametrize("norm", NORMS)
@pytest.mark.parametrize("type", TYPES)
def test_dctn_dstn_round_trips(type, norm, impl):
    ref, da = make_3d(seed=11)
    x = np.asarray(ref.values)
    with fft_impl(impl):
        rt = xt.idctn(xt.dctn(da, type=type, norm=norm), type=type,
                      norm=norm)
        rs = xt.idstn(xt.dstn(da, dim=["z", "x"], type=type, norm=norm),
                      dim=["z", "x"], type=type, norm=norm)
    assert np.abs(rt.values - x).max() <= 1e-11
    assert np.abs(rs.values - x).max() <= 1e-11


def test_dctn_single_dim_equals_dct():
    _, da = make_3d(seed=3)
    a = xt.dctn(da, dim="y", type=3, norm="ortho").values
    b = xt.dct(da, dim="y", type=3, norm="ortho").values
    np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("impl", ["torch", "kernel"])
def test_dctn_float32_field_through_k2(impl):
    """The flagship's shape cut down: a float32 (2, 256, 300) field, dctn
    over (y, x) and back, K2 on both axes under "kernel"."""
    ref, da = make_3d((2, 256, 300), seed=5, dtype=np.float32)
    got, _ = check("dctn", [ref], [da], impl, 2e-6, dim=["y", "x"],
                   norm="ortho")
    assert got.data.dtype == torch.float32
    with fft_impl(impl):
        back = xt.idctn(got, dim=["y", "x"], norm="ortho")
    x = np.asarray(ref.values)
    assert np.abs(back.values - x).max() <= 2e-6 * np.abs(x).max()


def test_dctn_error_contracts():
    _, da = make_3d()
    with pytest.raises(ValueError, match="not found"):
        xt.dctn(da, dim=["y", "nope"])
    with pytest.raises(ValueError, match="duplicate"):
        xt.dstn(da, dim=["y", "y"])
    with pytest.raises(ValueError, match="at least one"):
        xt.dctn(da, dim=[])
