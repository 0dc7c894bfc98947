"""K2, the four-step DFT (xrft_tpu_torch/ops/fft_fourstep.py), held against
the TPU kernel it replaces (xrft_tpu/ops/pallas_fft.py) in interpret mode
and against numpy's complex128 FFT.

Tolerance: 2e-6 relative to max|X|, the bound tests/test_pallas_fft.py holds
the TPU kernel to (float32 sums over n1 + n2 <= 512 terms).
"""

import numpy as np
import numpy.testing as npt
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp

from xrft_tpu.ops import pallas_fft
from xrft_tpu.ops.carray import as_pair, to_numpy
from xrft_tpu_torch.config import fft_impl
from xrft_tpu_torch.ops import fft_core, fft_fourstep

TOL = 2e-6


def _input(n, rows, cplx, seed):
    rng = np.random.RandomState(seed)
    if cplx:
        return (rng.randn(rows, n) + 1j * rng.randn(rows, n)).astype(
            np.complex64)
    return rng.randn(rows, n).astype(np.float32)


def _assert_close(got, ref):
    m = np.abs(ref).max()
    npt.assert_allclose(got / m, ref / m, rtol=0, atol=TOL)


@pytest.mark.parametrize("sign", [-1, 1])
@pytest.mark.parametrize("cplx", [False, True])
@pytest.mark.parametrize("n", [256, 4096])
def test_plain_matches_tpu_kernel(n, cplx, sign):
    x = _input(n, 8, cplx, n + cplx)
    ref = to_numpy(pallas_fft.pallas_fft_last(
        as_pair(x) if cplx else jnp.asarray(x), sign, interpret=True))
    got = fft_fourstep.fft_last(torch.from_numpy(x), sign).numpy()
    assert got.dtype == np.complex64
    _assert_close(got, ref)


@pytest.mark.parametrize("cplx", [False, True])
@pytest.mark.parametrize("n", [1000, 65536])
def test_plain_matches_numpy(n, cplx):
    x = _input(n, 2, cplx, n)
    ref = np.fft.fft(x.astype(np.complex128), axis=-1)
    got = fft_fourstep.fft_last(torch.from_numpy(x), -1).numpy()
    _assert_close(got, ref)


def test_balanced_factors_match_reference():
    for n in list(range(1, 3000)) + [4096, 8192, 65536, 65537, 2 * 65536]:
        assert fft_fourstep._balanced_factors(n) == \
            pallas_fft._balanced_factors(n), n


def test_unsupported_inputs_raise():
    with pytest.raises(ValueError, match="float32/complex64"):
        fft_fourstep.fft_last(torch.zeros(2, 256, dtype=torch.float64))
    with pytest.raises(ValueError, match="factor pair"):
        fft_fourstep.fft_last(torch.zeros(2, 128))       # n < 256
    with pytest.raises(ValueError, match="factor pair"):
        fft_fourstep.fft_last(torch.zeros(2, 65537))     # no pair <= 256
    with pytest.raises(ValueError, match="cuda or cpu"):
        fft_fourstep.fft_last(torch.empty(2, 256, device="meta"))
    before = fft_fourstep.fft_last.launches
    fft_fourstep.fft_last(torch.zeros(2, 256))
    assert fft_fourstep.fft_last.launches == before  # CPU: plain version


@pytest.mark.parametrize("shift", [False, True])
def test_fft_core_kernel_route_matches_torch_fft(shift):
    """Under fft_impl="kernel" every axis goes through K2 (moved last, made
    contiguous, moved back); the rfft keeps n//2 + 1 columns."""
    x = torch.from_numpy(np.random.RandomState(5).randn(2, 256, 320)
                         .astype(np.float32))
    post = [1] if shift else ()
    ref_r = fft_core.rfftn(x.double(), [1, 2], post_shift_axes=post)
    ref_c = fft_core.fftn(x.double(), [1, 2], pre_shift_axes=[1, 2])
    with fft_impl("kernel"):
        got_r = fft_core.rfftn(x, [1, 2], post_shift_axes=post)
        got_c = fft_core.fftn(x, [1, 2], pre_shift_axes=[1, 2])
    assert got_r.shape == (2, 256, 161)
    _assert_close(got_r.numpy(), ref_r.numpy())
    _assert_close(got_c.numpy(), ref_c.numpy())


@pytest.mark.parametrize("n,sign", [(4096, -1), (1000, 1), (65536, -1)])
def test_tables_match_reference_matrices(n, sign):
    """The kernel's tables, expanded as the plain version expands them, are
    the TPU kernel's DFT and twiddle matrices rounded to complex64."""
    from xrft_tpu.ops.matmul_fft import _dft_matrix_np, _twiddle_np

    n1, n2 = fft_fourstep._balanced_factors(n)
    t1, t2, tn = fft_fourstep._tables_np(n1, n2, sign)
    j1, j2 = np.arange(n1), np.arange(n2)
    npt.assert_array_equal(t1[np.outer(j1, j1) % n1],
                           _dft_matrix_np(n1, sign).astype(np.complex64))
    npt.assert_array_equal(t2[np.outer(j2, j2) % n2],
                           _dft_matrix_np(n2, sign).astype(np.complex64))
    npt.assert_array_equal(tn[np.outer(j1, j2) % n],
                           _twiddle_np(n1, n2, sign).astype(np.complex64))
