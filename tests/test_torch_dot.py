"""K5a-c of xrft_tpu_torch (ops/dot.py) against xrft_tpu's Pallas kernels
(ops/pallas_dot.py, interpret mode) on the CPU, where each wrapper runs its
plain version.  Tolerance: 1e-6 of max|out|, as tests/test_pallas_dot.py
holds the Pallas kernels to a float64 oracle (float32 products summed over
K = 128 terms in another order).
"""

import numpy as np
import numpy.testing as npt
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp

from xrft_tpu.ops import pallas_dot
from xrft_tpu_torch.ops import dot

TOL = 1e-6
N = 8192


@pytest.fixture(scope="module")
def packed():
    rng = np.random.RandomState(0)
    w2 = rng.randn(64, 32).astype(np.float32)
    W = pallas_dot.pack_block_diag(w2, 4)          # (256, 128)
    x = rng.randn(128, N).astype(np.float32)
    return w2, W, x


def _rel(got, ref):
    ref = np.asarray(ref, np.float64)
    return np.abs(np.asarray(got, np.float64) - ref).max() / np.abs(ref).max()


def test_pack_block_diag_matches_reference(packed):
    w2, W, _ = packed
    got = dot.pack_block_diag(torch.from_numpy(w2), 4)
    assert got.dtype == torch.float32
    npt.assert_array_equal(got.numpy(), W)


@pytest.mark.parametrize("name", ["dot", "dot_dma", "dot_fold"])
def test_kernels_match_pallas(packed, name):
    _, W, x = packed
    make = {"dot": pallas_dot.make_dot_kernel,
            "dot_dma": pallas_dot.make_dot_kernel_dma,
            "dot_fold": pallas_dot.make_dot_fold_kernel}[name]
    ref = np.asarray(make(W, N, tile_cols=2048, interpret=True)(
        jnp.asarray(x)))
    wt, xt = torch.from_numpy(W), torch.from_numpy(x)
    plain = getattr(dot, f"{name}_plain")(wt, xt)
    before = getattr(dot, name).launches
    got = getattr(dot, name)(wt, xt)
    assert getattr(dot, name).launches == before   # the CPU runs plain
    assert got.shape == ref.shape and got.dtype == torch.float32
    assert torch.equal(got, plain)
    assert _rel(got.numpy(), ref) <= TOL


def test_fold_needs_m_equal_2k(packed):
    _, W, x = packed
    with pytest.raises(ValueError, match="M == 2K"):
        pallas_dot.make_dot_fold_kernel(W[:200], N, tile_cols=2048)
    for fn in (dot.dot_fold, dot.dot_fold_plain):
        with pytest.raises(ValueError, match="M == 2K"):
            fn(torch.from_numpy(W[:200]), torch.from_numpy(x))


@pytest.mark.parametrize("shape", [(3, 32, 45), (5, 32, 7)])
def test_ragged_and_strided_columns(shape):
    """A column count that no tile divides is accepted, and a (P, K, Q)
    operand is read as X[j, p*Q + q] = x[p, j, q]."""
    rng = np.random.RandomState(1)
    w = rng.randn(64, 32).astype(np.float32)
    a = rng.randn(*shape).astype(np.float32)
    want = np.einsum("mj,pjq->mpq", w.astype(np.float64),
                     a.astype(np.float64)).reshape(64, -1)
    for fn in (dot.dot, dot.dot_dma):
        got = fn(torch.from_numpy(w), torch.from_numpy(a))
        assert got.shape == (64, shape[0] * shape[2])
        assert _rel(got.numpy(), want) <= TOL
    with pytest.raises(ValueError, match="float32"):
        dot.dot(torch.from_numpy(w).double(), torch.from_numpy(a))
    with pytest.raises(ValueError, match="contraction"):
        dot.dot(torch.from_numpy(w), torch.from_numpy(a[:, :16]))
