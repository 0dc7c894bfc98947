"""The host plans of the Stockham FFT that kernels K2 and K4 run
(xrft_tpu_torch/ops/fft_plan.py), pinned on the CPU through the numpy
replay of exactly the int32 plan and the table the kernels receive.

Tolerances, relative to max|X|:
  * 1e-13 against numpy's complex128 FFT for the float64 tables: the replay
    computes in complex128, with errors of a few 1e-16 at these sizes;
  * 5e-6 against ``df64_fft_nd`` (interpret mode), the JAX package's own CPU
    bound (tests/test_df64_fft.py);
  * 2e-6 for the complex64-rounded tables replayed in float32, the bound
    tests/test_torch_fft_fourstep.py holds K2 to.
"""

import numpy as np
import numpy.testing as npt
import pytest
from hypothesis import given, settings
from hypothesis import strategies as st

torch = pytest.importorskip("torch")

from xrft_tpu.ops.df64_fft import df64_fft_nd, df64_to_numpy
from xrft_tpu_torch.ops import dft64, fft_fourstep, fft_plan

NUMPY_TOL = 1e-13
DF64_CPU_TOL = 5e-6
F32_TOL = 2e-6


def _input(rows, n, seed):
    rng = np.random.RandomState(seed)
    return rng.randn(rows, n) + 1j * rng.randn(rows, n)


def _numpy_dft(x, sign):
    n = x.shape[-1]
    return np.fft.fft(x) if sign == -1 else np.fft.ifft(x) * n


def _assert_close(got, ref, tol):
    m = np.abs(ref).max()
    npt.assert_allclose(got / m, ref / m, rtol=0, atol=tol)


@pytest.mark.parametrize("n", list(range(1, 257)) + [1000, 1004, 4096, 8192])
def test_replay_matches_numpy(n):
    """Both signs: the replay of the plan and its float64 table is the
    unnormalised DFT in natural order."""
    x = _input(3, n, n)
    for sign in (-1, 1):
        plan, table = fft_plan.build(n, sign)
        assert table.dtype == np.complex128
        _assert_close(fft_plan.replay(plan, table, x), _numpy_dft(x, sign),
                      NUMPY_TOL)


@settings(max_examples=40, deadline=None)
@given(n=st.integers(1, 256), sign=st.sampled_from([-1, 1]),
       rows=st.integers(1, 4), seed=st.integers(0, 2 ** 16))
def test_replay_property(n, sign, rows, seed):
    x = _input(rows, n, seed)
    plan, table = fft_plan.build(n, sign)
    _assert_close(fft_plan.replay(plan, table, x), _numpy_dft(x, sign),
                  NUMPY_TOL)


@pytest.mark.parametrize("kind", ["fft", "ifft"])
@pytest.mark.parametrize("n", [96, 256])
def test_replay_matches_tpu_kernel(n, kind):
    """The plan against df64_fft_nd, whose base case is the Pallas kernel
    K4 replaces, at the JAX package's CPU tolerance."""
    x = _input(4, n, 7 * n)
    ref = df64_to_numpy(df64_fft_nd(x, [-1], kind))
    plan, table = fft_plan.build(n, -1 if kind == "fft" else 1)
    got = fft_plan.replay(plan, table, x)
    if kind == "ifft":
        got = got / n
    _assert_close(got, ref, DF64_CPU_TOL)


@pytest.mark.parametrize("sign", [-1, 1])
@pytest.mark.parametrize("cplx", [False, True])
def test_complex64_tables_in_float32(cplx, sign):
    """K2's table rounded to complex64 and replayed in float32 at the main
    path's n = 4096 (three radix-16 stages)."""
    x = _input(8, 4096, 11 + cplx)
    x = (x if cplx else x.real).astype(np.complex64 if cplx else np.float32)
    plan, table = fft_fourstep._plan(4096, sign, torch.device("cpu"))
    assert plan[2] == 1 and table.dtype == torch.complex64
    got = fft_plan.replay(plan, table.numpy(), x)
    assert got.dtype == np.complex64
    _assert_close(got, _numpy_dft(x.astype(np.complex128), sign), F32_TOL)


@pytest.mark.parametrize("n,split", [(65536, (256, 256)), (16384, (128, 128)),
                                     (13000, (125, 104)), (1004, (251, 4))])
def test_two_pass_replay(n, split):
    """K2's four-step form (above ``FUSED_MAX``): the n1-point plan on the
    columns, the inter-pass twiddle, the n2-point plan on the rows."""
    x = _input(2, n, n)
    for sign in (-1, 1):
        plan, table = fft_plan.build(n, sign, split)
        assert tuple(plan[:3]) == (n, sign, 2)
        _assert_close(fft_plan.replay(plan, table, x), _numpy_dft(x, sign),
                      NUMPY_TOL)
        if n > fft_fourstep.FUSED_MAX:
            p32, t32 = fft_fourstep._plan(n, sign, torch.device("cpu"))
            npt.assert_array_equal(p32, plan)
            got = fft_plan.replay(p32, t32.numpy(), x.astype(np.complex64))
            _assert_close(got, _numpy_dft(x, sign), F32_TOL)


def test_radices_largest_first():
    assert fft_plan.radices(1) == ()
    assert fft_plan.radices(16) == (16,)
    assert fft_plan.radices(256) == (16, 16)
    assert fft_plan.radices(4096) == (16, 16, 16)
    assert fft_plan.radices(8192) == (16, 16, 16, 2)
    assert fft_plan.radices(96) == (16, 3, 2)
    assert fft_plan.radices(1000) == (8, 5, 5, 5)
    assert fft_plan.radices(1004) == (251, 4)
    assert fft_plan.radices(251) == (251,)
    assert fft_plan.radices(289) == (17, 17)
    for n in range(1, 3000):
        r = fft_plan.radices(n)
        assert int(np.prod(r)) == n and list(r) == sorted(r, reverse=True)


@pytest.mark.parametrize("n", [16, 96, 251, 256, 289])
def test_plan_words_and_table_layout(n):
    """The int32 words: header, then per stage (radix, stride, twiddle
    offset, root offset); every twiddle block is W_(ns*R)^(r*k) in [r-1][k]
    order and every root block W_R^m, all inside the table."""
    for sign in (-1, 1):
        plan, table = fft_plan.build(n, sign)
        assert tuple(plan[:5]) == (n, sign, 1, -1, table.size)
        assert plan[5] == n and plan[6] == len(fft_plan.radices(n))
        assert plan.size == 7 + 4 * plan[6]
        ns = 1
        for s, R in enumerate(fft_plan.radices(n)):
            radix, stride, tw, rt = plan[7 + 4 * s: 11 + 4 * s]
            assert (radix, stride) == (R, ns)
            m = np.arange(R)
            npt.assert_allclose(table[rt: rt + R],
                                np.exp(sign * 2j * np.pi * m / R),
                                rtol=0, atol=4e-15)
            if ns == 1:
                assert tw == -1
            else:
                r = np.arange(1, R)[:, None]
                k = np.arange(ns)[None, :]
                npt.assert_allclose(
                    table[tw: tw + (R - 1) * ns].reshape(R - 1, ns),
                    np.exp(sign * 2j * np.pi * r * k / (ns * R)),
                    rtol=0, atol=4e-15)
            ns *= R


def test_kernel_plans_cover_their_contracts():
    """K4 takes one pass for every n <= 256; K2 one pass up to FUSED_MAX
    and two at its balanced factors above it, for every length it
    accepts."""
    for n in range(1, dft64.KERNEL_MAX + 1):
        plan, _ = dft64._plan(n, -1, torch.device("cpu"))
        assert plan[2] == 1 and plan[5] == n
    for n in list(range(256, 2100)) + [4096, 8192, 16384, 65536]:
        factors = fft_fourstep._balanced_factors(n)
        if factors is None:
            continue
        plan, _ = fft_fourstep._plan(n, 1, torch.device("cpu"))
        assert plan[2] == (1 if n <= fft_fourstep.FUSED_MAX else 2)
        if plan[2] == 2:
            assert plan[5] == factors[0]


def test_build_rejects_bad_arguments():
    with pytest.raises(ValueError, match="sign"):
        fft_plan.build(16, 0)
    with pytest.raises(ValueError, match=">= 1"):
        fft_plan.build(0, -1)
    with pytest.raises(ValueError, match="multiply"):
        fft_plan.build(100, -1, (7, 14))
    plan, table = fft_plan.build(8, -1)
    with pytest.raises(ValueError, match="length 8"):
        fft_plan.replay(plan, table, np.zeros((2, 9)))
