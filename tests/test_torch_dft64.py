"""K4, the FP64 direct DFT, and its four-step recursion
(xrft_tpu_torch/ops/dft64.py), held against numpy's complex128 FFT and
against the TPU kernel it replaces (xrft_tpu/ops/df64_fft.py, in interpret
mode).

Tolerances, relative to max|X|:
  * 1e-12 against numpy: the port computes in FP64, with errors of a few
    1e-16 at these sizes;
  * 5e-6 against ``df64_fft_nd`` on this CPU, the JAX package's own CPU bound
    (tests/test_df64_fft.py): XLA:CPU contracts the FMAs that the double-word
    compensation relies on, so the reference itself is float32-grade here.
Inputs are float64/complex128 from numpy seeds; ``as_df64`` splits them
exactly.
"""

import numpy as np
import numpy.testing as npt
import pytest

torch = pytest.importorskip("torch")

from xrft_tpu.ops.df64_fft import df64_fft_nd, df64_to_numpy
from xrft_tpu.ops.matmul_fft import _dft_matrix_np, _largest_small_divisor
from xrft_tpu_torch.config import fft_impl
from xrft_tpu_torch.ops import dft64, fft_core
from xrft_tpu_torch.ops.fft_fourstep import fft_last

NUMPY_TOL = 1e-12
DF64_CPU_TOL = 5e-6


def _input(shape, seed, cplx=True):
    rng = np.random.RandomState(seed)
    x = rng.randn(*shape)
    return x + 1j * rng.randn(*shape) if cplx else x


def _assert_close(got, ref, tol):
    m = np.abs(ref).max()
    npt.assert_allclose(got / m, ref / m, rtol=0, atol=tol)


def _numpy_dft(x, sign, axes=(-1,)):
    if sign == -1:
        return np.fft.fftn(x, axes=axes)
    return np.fft.ifftn(x, axes=axes) * np.prod([x.shape[a] for a in axes])


@pytest.mark.parametrize("sign", [-1, 1])
@pytest.mark.parametrize("n", [1, 2, 16, 96, 120, 250, 256])
def test_plain_matches_numpy(n, sign):
    x = _input((5, n), n)
    got = dft64.dft_last_plain(torch.from_numpy(x), sign).numpy()
    assert got.dtype == np.complex128
    _assert_close(got, _numpy_dft(x, sign), NUMPY_TOL)
    # the wrapper takes the plain version for a CPU tensor, and counts nothing
    before = dft64.dft_last.launches
    npt.assert_array_equal(dft64.dft_last(torch.from_numpy(x), sign).numpy(),
                           got)
    assert dft64.dft_last.launches == before


@pytest.mark.parametrize("kind", ["fft", "ifft"])
@pytest.mark.parametrize("n", [1, 16, 250, 256, 512, 1000, 2048, 4096])
def test_fftn64_matches_numpy(n, kind):
    x = _input((3, n), n + 1)
    got = dft64.fftn64(torch.from_numpy(x), [-1], kind).numpy()
    ref = np.fft.fft(x) if kind == "fft" else np.fft.ifft(x)
    _assert_close(got, ref, NUMPY_TOL)


@pytest.mark.parametrize("kind", ["fft", "ifft"])
def test_fftn64_two_axes_and_real_input(kind):
    """Both axes of a stack, a non-trailing axis first; real input is
    promoted to complex128."""
    x = _input((2, 1000, 48), 7, cplx=False)
    got = dft64.fftn64(torch.from_numpy(x), [1, 2], kind)
    assert got.dtype == torch.complex128
    ref = np.fft.fftn(x, axes=(1, 2)) if kind == "fft" \
        else np.fft.ifftn(x, axes=(1, 2))
    _assert_close(got.numpy(), ref, NUMPY_TOL)


@pytest.mark.parametrize("kind", ["fft", "ifft"])
@pytest.mark.parametrize("n", [96, 256, 1000])
def test_fftn64_matches_tpu_kernel(n, kind):
    """The recursion against df64_fft_nd, whose base case is the Pallas
    kernel K4 replaces, at the JAX package's CPU tolerance."""
    x = _input((4, n), 3 * n)
    ref = df64_to_numpy(df64_fft_nd(x, [-1], kind))
    got = dft64.fftn64(torch.from_numpy(x), [-1], kind).numpy()
    _assert_close(got, ref, DF64_CPU_TOL)
    _assert_close(got, np.fft.fft(x) if kind == "fft" else np.fft.ifft(x),
                  NUMPY_TOL)


def test_factor_chain_matches_reference():
    for n in list(range(1, 3000)) + [4096, 8192, 65536, 65537, 2 * 65537]:
        assert dft64._largest_small_divisor(n, 256) == \
            _largest_small_divisor(n, 256), n


@pytest.mark.parametrize("n,sign", [(16, -1), (250, 1), (256, -1)])
def test_table_builds_reference_matrix(n, sign):
    """The kernel's table, expanded as the plain version expands it, is the
    TPU kernel's DFT matrix bit for bit."""
    j = np.arange(n)
    npt.assert_array_equal(dft64._table_np(n, sign)[np.outer(j, j) % n],
                           _dft_matrix_np(n, sign))


def test_prime_length_raises_in_both_packages():
    x = _input((2, 257), 0)
    with pytest.raises(NotImplementedError, match="prime size 257"):
        dft64.fftn64(torch.from_numpy(x), [-1])
    with pytest.raises(NotImplementedError, match="prime size 257"):
        df64_fft_nd(x, [-1], "fft")
    with pytest.raises(NotImplementedError, match="prime size 257"):
        dft64.fftn64(torch.from_numpy(_input((2, 514), 1)), [-1])


def test_unsupported_inputs_raise():
    with pytest.raises(ValueError, match="complex128 only"):
        dft64.dft_last(torch.zeros(2, 16, dtype=torch.complex64))
    with pytest.raises(ValueError, match="length 1 to 256"):
        dft64.dft_last(torch.zeros(2, 512, dtype=torch.complex128))
    with pytest.raises(ValueError, match="sign"):
        dft64.dft_last(torch.zeros(2, 16, dtype=torch.complex128), 2)
    with pytest.raises(ValueError, match="cuda or cpu"):
        dft64.dft_last(torch.empty(2, 16, dtype=torch.complex128,
                                   device="meta"))
    with pytest.raises(ValueError, match="kind"):
        dft64.fftn64(torch.zeros(2, 16, dtype=torch.complex128), [-1], "rfft")


@pytest.mark.parametrize("impl", ["torch", "kernel"])
def test_fft_core_picks_k4_for_float64(impl, monkeypatch):
    """Under fft_impl="kernel", float64 data take the K4 recursion on every
    axis of every transform kind, and agree with torch.fft in complex128."""
    calls = []
    real_fft_last = dft64.fft_last

    def counting(x, sign=-1):
        calls.append((x.shape[-1], sign))
        return real_fft_last(x, sign)

    monkeypatch.setattr(dft64, "fft_last", counting)
    x = torch.from_numpy(_input((2, 512, 96), 9, cplx=False))
    z = torch.from_numpy(_input((2, 512, 96), 10))
    h = torch.from_numpy(_input((2, 512, 49), 11))
    with fft_impl(impl):
        got = [fft_core.fftn(z, [1, 2], pre_shift_axes=[1],
                             post_shift_axes=[2]),
               fft_core.ifftn(z, [1, 2], post_shift_axes=[1, 2],
                              post_kind="ifftshift"),
               fft_core.rfftn(x, [1, 2], post_shift_axes=[1]),
               fft_core.irfftn(h, [1, 2], pre_shift_axes=[1])]
    ref = [np.fft.fftshift(np.fft.fftn(np.fft.ifftshift(z.numpy(), axes=1),
                                       axes=(1, 2)), axes=2),
           np.fft.ifftshift(np.fft.ifftn(z.numpy(), axes=(1, 2)),
                            axes=(1, 2)),
           np.fft.fftshift(np.fft.rfftn(x.numpy(), axes=(1, 2)), axes=1),
           np.fft.irfftn(np.fft.ifftshift(h.numpy(), axes=1), axes=(1, 2))]
    for g, r in zip(got, ref):
        assert g.dtype == (torch.float64 if r.dtype == np.float64
                           else torch.complex128)
        _assert_close(g.numpy(), r, NUMPY_TOL)
    if impl == "torch":
        assert calls == []
    else:
        assert {n for n, _ in calls} == {512, 96, 256, 2}
        assert {s for _, s in calls} == {-1, 1}


def test_fft_core_kernel_route_raises_on_what_it_cannot_run():
    """The float32 kernel route is K2 and still raises where K2 cannot run,
    the float64 route raises on a prime factor > 256; neither switches to
    torch.fft."""
    with fft_impl("kernel"):
        with pytest.raises(ValueError, match="factor pair"):
            fft_core.fftn(torch.zeros(2, 96), [1])
        # a dtype: float16 reaches no kernel; a complex transform promotes
        # it to complex64 (K2), a real one raises the JAX package's error
        with pytest.raises(ValueError, match="float32/complex64"):
            fft_last(torch.zeros(2, 256, dtype=torch.float16), -1)
        assert fft_core.fftn(torch.zeros(2, 256, dtype=torch.float16),
                             [1]).dtype == torch.complex64
        with pytest.raises(ValueError, match="RFFT input must be float32 "
                           "or float64, got float16"):
            fft_core.rfftn(torch.zeros(2, 256, dtype=torch.float16), [1])
        with pytest.raises(NotImplementedError, match="prime size"):
            fft_core.fftn(torch.zeros(2, 257, dtype=torch.float64), [1])
