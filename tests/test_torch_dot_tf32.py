"""K5a's 3xTF32 arithmetic (xrft_tpu_torch/ops/dot.py: tf32_rna and
dot_replay, the host replay of csrc/dot.cu's tensor-core kernel) on the CPU.

The replay is held to the float64 product and to xrft_tpu's K5a
(ops/pallas_dot.py::make_dot_kernel, interpret mode) at TOL = 1e-6 of
max|out|, the limit the kernel is held to against its plain version on the
card: the split keeps about 22 bits of each operand, each TF32 product is
exact in float32, and the sums round in float32 over K <= 128 terms.
"""

import numpy as np
import pytest
from hypothesis import given, settings, strategies as st

torch = pytest.importorskip("torch")

import jax.numpy as jnp

from xrft_tpu.ops import pallas_dot
from xrft_tpu_torch.ops import dot

TOL = 1e-6
N = 8192


def _bits(v: torch.Tensor) -> list:
    return [int(b) & 0xffffffff for b in v.view(torch.int32).tolist()]


def _from_bits(bits) -> torch.Tensor:
    u = np.array(bits, dtype=np.uint32)
    return torch.from_numpy(u.view(np.int32).copy()).view(torch.float32)


def _rel(got, ref):
    ref = np.asarray(ref, np.float64)
    return np.abs(np.asarray(got, np.float64) - ref).max() / np.abs(ref).max()


@pytest.mark.parametrize("given_bits,want", [
    (0x3f800000, 0x3f800000),   # 1.0: already TF32
    (0x3f800fff, 0x3f800000),   # below half: down
    (0x3f801000, 0x3f802000),   # a tie on an even kept bit: away (RNE keeps)
    (0x3f803000, 0x3f804000),   # a tie on an odd kept bit: away
    (0x3f801001, 0x3f802000),   # above half: up
    (0xbf801000, 0xbf802000),   # negative tie: away from zero
    (0xbf800fff, 0xbf800000),
    (0x3fffffff, 0x40000000),   # the carry runs into the exponent
    (0x00001000, 0x00002000),   # subnormal tie
    (0x00000fff, 0x00000000),   # subnormal below half: zero
    (0x007ff000, 0x00800000),   # largest subnormals round to the smallest normal
    (0x80001000, 0x80002000),   # negative subnormal
    (0x7f7fffff, 0x7f800000),   # the largest float rounds to inf
    (0xff7fffff, 0xff800000),
    (0x7f7fe000, 0x7f7fe000),   # the largest TF32 value stays
    (0x7f800000, 0x7f800000),   # inf
    (0xff800000, 0xff800000),   # -inf
    (0x7fc00000, 0x7fc00000),   # NaN passes through
    (0x7f800001, 0x7f800001),   # a NaN with low payload bits, unrounded
    (0xffffffff, 0xffffffff),
    (0x00000000, 0x00000000),
    (0x80000000, 0x80000000),   # -0
])
def test_tf32_rna_bit_patterns(given_bits, want):
    assert _bits(dot.tf32_rna(_from_bits([given_bits]))) == [want]


def test_tf32_split_is_exact_to_22_bits():
    """hi and lo carry 13 clear low bits, and v - hi - lo is below 2^-22
    of |v| (the x_lo w_lo term the kernel drops is of that order)."""
    rng = np.random.RandomState(0)
    v = torch.from_numpy((rng.randn(100000) *
                          10.0 ** rng.randint(-30, 30, 100000))
                         .astype(np.float32))
    hi = dot.tf32_rna(v)
    lo = dot.tf32_rna(v - hi)
    for part in (hi, lo):
        assert int((part.view(torch.int32) & 0x1fff).abs().max()) == 0
    err = (v.double() - hi.double() - lo.double()).abs()
    assert bool((err <= 2.0 ** -22 * v.double().abs()).all())


def test_tf32_rna_rejects_other_dtypes():
    with pytest.raises(ValueError, match="float32"):
        dot.tf32_rna(torch.zeros(3, dtype=torch.float64))


@pytest.mark.parametrize("m,k,packed", [(64, 32, False), (256, 128, True)])
def test_replay_matches_float64_and_pallas(m, k, packed):
    """The engine's level-0 shape and the packed A/B shape."""
    rng = np.random.RandomState(m)
    w2 = rng.randn(64, 32).astype(np.float32)
    W = pallas_dot.pack_block_diag(w2, 4) if packed else w2
    assert W.shape == (m, k)
    x = rng.randn(k, N).astype(np.float32)
    got = dot.dot_replay(torch.from_numpy(W), torch.from_numpy(x)).numpy()
    want = W.astype(np.float64) @ x.astype(np.float64)
    pallas = np.asarray(pallas_dot.make_dot_kernel(
        W, N, tile_cols=2048, interpret=True)(jnp.asarray(x)))
    assert got.shape == (m, N) and got.dtype == np.float32
    assert _rel(got, want) <= TOL
    assert _rel(got, pallas) <= TOL
    plain = dot.dot_plain(torch.from_numpy(W), torch.from_numpy(x)).numpy()
    assert _rel(got, plain) <= TOL


def test_replay_reads_strided_operands():
    """A (P, K, Q) operand is read as X[j, p*Q + q] = x[p, j, q], as the
    kernel reads it."""
    rng = np.random.RandomState(4)
    w = rng.randn(48, 24).astype(np.float32)
    a = rng.randn(5, 24, 13).astype(np.float32)
    want = np.einsum("mj,pjq->mpq", w.astype(np.float64),
                     a.astype(np.float64)).reshape(48, -1)
    got = dot.dot_replay(torch.from_numpy(w), torch.from_numpy(a)).numpy()
    assert got.shape == want.shape
    assert _rel(got, want) <= TOL


@settings(max_examples=30, deadline=None)
@given(m=st.integers(1, 24), k=st.integers(1, 40), n=st.integers(1, 60),
       seed=st.integers(0, 2 ** 31 - 1))
def test_replay_property_small_shapes(m, k, n, seed):
    rng = np.random.RandomState(seed)
    w = rng.randn(m, k).astype(np.float32)
    x = rng.randn(k, n).astype(np.float32)
    got = dot.dot_replay(torch.from_numpy(w), torch.from_numpy(x)).numpy()
    want = w.astype(np.float64) @ x.astype(np.float64)
    assert got.shape == (m, n)
    assert np.abs(got - want).max() <= TOL * max(np.abs(want).max(), 1e-30)


# every shape of tests/test_torch_cuda.py::test_dot_kernels_match_plain and
# chip_smoke.py's two timed shapes, with the producer K5c takes for each
DMA_SHAPES = [
    ((32, 40000), 2), ((128, 8192), 2), ((300, 32, 32), 3), ((24, 1001), 0),
    ((3, 7, 13), 0), ((128, 8195), 0), ((5, 128, 13), 0), ((96, 1000), 2),
    ((32768, 32, 128), 3),          # chip_smoke's engine shape: TMA, 3-D
    ((128, 1 << 20), 2),            # chip_smoke's packed shape: TMA, 2-D
]


@pytest.mark.parametrize("shape,rank", DMA_SHAPES)
def test_dma_tensor_map_layouts(shape, rank):
    """K5c's TMA-or-cp.async choice: the tensor map's strides are 16-byte
    multiples, its box divides the 128-column x 32-deep tile, and the map
    addresses the same elements as the strides."""
    x = torch.empty(shape, dtype=torch.float32)
    tm = dot.dma_tensor_map(x)
    if rank == 0:
        assert tm is None
        return
    assert tm["rank"] == rank == len(tm["dims"]) == len(tm["box"])
    assert len(tm["strides"]) == rank - 1
    assert all(s % 16 == 0 for s in tm["strides"])
    assert dot.DMA_TILE_COLS % tm["box"][0] == 0 and 32 % tm["box"][1] == 0
    assert tm["box"][0] * 4 == 128                # the 128-byte swizzle span
    x3 = x.unsqueeze(0) if x.ndim == 2 else x
    P, K, Q = x3.shape
    assert tm["dims"][:2] == (Q, K)
    assert tm["strides"][0] == x3.stride(1) * 4
    if rank == 3:
        assert tm["dims"][2] == P and tm["strides"][1] == x3.stride(0) * 4
        assert Q % tm["box"][0] == 0 and tm["box"][2] == 1


def test_dma_tensor_map_refuses_what_the_tma_cannot_read():
    x = torch.empty((64, 4096), dtype=torch.float32)
    assert dot.dma_tensor_map(x) is not None
    assert dot.dma_tensor_map(x[:, 1:]) is None          # base off 16 bytes
    assert dot.dma_tensor_map(x[:, ::2]) is None         # strided columns
    assert dot.dma_tensor_map(torch.empty((8, 32, 48))) is None  # Q % 32
    assert dot.dma_tensor_map(torch.empty((8, 32, 64))[:, :, :32]) is not None


def test_dma_contract_on_the_host():
    """K5c keeps W resident: M <= 512 and K <= 256, on every device."""
    x = torch.zeros((300, 10))
    with pytest.raises(ValueError, match="resident"):
        dot.dot_dma(torch.zeros((520, 300)), x)
    with pytest.raises(ValueError, match="resident"):
        dot.dot_dma(torch.zeros((513, 8)), torch.zeros((8, 10)))
    got = dot.dot_dma(torch.ones((512, 256)), torch.ones((256, 3)))
    assert got.shape == (512, 3) and bool((got == 256).all())
