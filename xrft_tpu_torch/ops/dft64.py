"""K4: the FP64 DFT along the last axis, n <= 256 (``csrc/dft64.cu``, a
shared-memory Stockham FFT on the plan of :mod:`.fft_plan`), and the
four-step recursion that makes it the base case of any composite length.

Counterpart of ``xrft_tpu/ops/df64_fft.py``: ``_df64_dft_last`` (the Pallas
kernel, n <= 256) becomes :func:`dft_last`, ``_df64_fft_last`` becomes
:func:`fft_last` and ``df64_fft_nd`` becomes :func:`fftn64`.  The TPU kernel
carried float64 as double-word float32 planes because the TPU has none; a
CUDA card has FP64 units, so here the data are complex128 tensors and the
kernel computes in FP64.  The factor chain (``n1`` the largest divisor of
``n`` that is <= 256, ``n2 = n // n1``), the stage order and the twiddles
``T[k1, m2] = exp(sign*2*pi*i*k1*m2/n)`` are the JAX package's, built on the
host in float64 with exact integer angle reduction.

:func:`dft_last` launches the CUDA kernel for a CUDA tensor and runs its
plain version :func:`dft_last_plain` (``x @ W`` against the dense DFT
matrix) for a CPU tensor; any other device raises.
"""

from __future__ import annotations

import ctypes
import math
from functools import lru_cache

import numpy as np
import torch

from . import fft_plan

__all__ = ["KERNEL_MAX", "dft_last", "dft_last_plain", "fft_last", "fftn64"]

KERNEL_MAX = 256  # largest direct DFT (xrft_tpu/ops/df64_fft.py:39)


@lru_cache(maxsize=None)
def _largest_small_divisor(n: int, cap: int) -> int:
    """Largest divisor of n that is <= cap (1 if none beyond the trivial);
    a copy of ``xrft_tpu/ops/matmul_fft.py::_largest_small_divisor``."""
    best = 1
    d = 2
    while d * d <= n:
        if n % d == 0:
            if d <= cap and d > best:
                best = d
            q = n // d
            if q <= cap and q > best:
                best = q
        d += 1
    return best


@lru_cache(maxsize=None)
def _table_np(n: int, sign: int) -> np.ndarray:
    """W[e] = exp(sign*2*pi*i*e/n), e in [0, n), complex128: the entries of
    ``xrft_tpu/ops/matmul_fft.py::_dft_matrix_np`` (whose angles are
    ``(j*k) mod n``)."""
    ang = (2.0 * np.pi * sign / n) * np.arange(n, dtype=np.int64)
    return np.cos(ang) + 1j * np.sin(ang)


@lru_cache(maxsize=None)
def _twiddle_np(n1: int, n2: int, sign: int) -> np.ndarray:
    """Four-step twiddle T[k1, m2] = exp(sign*2*pi*i*k1*m2/(n1*n2))
    (``xrft_tpu/ops/matmul_fft.py::_twiddle_np``)."""
    n = n1 * n2
    prod = np.mod(np.outer(np.arange(n1, dtype=np.int64),
                           np.arange(n2, dtype=np.int64)), n)
    ang = (2.0 * np.pi * sign / n) * prod
    return np.cos(ang) + 1j * np.sin(ang)


@lru_cache(maxsize=64)
def _table(n, sign, device):
    """The table on ``device``, copied there once."""
    return torch.as_tensor(_table_np(n, sign), device=device)


@lru_cache(maxsize=64)
def _plan(n, sign, device):
    """The kernel's int32 plan (host) and its complex128 table on
    ``device``, copied there once."""
    plan, table = fft_plan.build(n, sign)
    return plan, torch.tensor(table, device=device)


@lru_cache(maxsize=64)
def _twiddle_t(n1, n2, sign, device):
    """T transposed to (m2, k1), the layout of stage 1's output, on
    ``device``, copied there once."""
    return torch.as_tensor(np.ascontiguousarray(_twiddle_np(n1, n2, sign).T),
                           device=device)


def _check(x: torch.Tensor, sign: int) -> int:
    if sign not in (-1, 1):
        raise ValueError(f"sign must be -1 or +1, got {sign}")
    if x.dtype != torch.complex128:
        raise ValueError(f"the FP64 DFT kernel is complex128 only, got "
                         f"{x.dtype}")
    if x.ndim < 1 or not 1 <= x.shape[-1] <= KERNEL_MAX:
        raise ValueError(f"the FP64 DFT kernel needs a last axis of length 1 "
                         f"to {KERNEL_MAX}, got shape {tuple(x.shape)}")
    return x.shape[-1]


def dft_last_plain(x: torch.Tensor, sign: int = -1) -> torch.Tensor:
    """Plain torch version of the kernel: ``x @ W`` in complex128, with
    ``W[j, k] = table[(j*k) mod n]`` built from the n-entry table of
    ``W_n^e`` (the TPU kernel's DFT matrix)."""
    n = _check(x, sign)
    j = np.arange(n, dtype=np.int64)
    w = _table(n, sign, x.device)[
        torch.as_tensor(np.outer(j, j) % n, device=x.device)]
    return x @ w


def dft_last(x: torch.Tensor, sign: int = -1) -> torch.Tensor:
    """Unnormalised DFT along the last axis (length <= 256) of a complex128
    tensor; ``sign`` is -1 (forward) or +1."""
    n = _check(x, sign)
    if x.device.type == "cpu":
        return dft_last_plain(x, sign)
    if x.device.type != "cuda":
        raise ValueError(f"dft_last runs on cuda or cpu tensors, not "
                         f"{x.device.type}")
    if not x.is_contiguous():
        raise ValueError("dft_last needs a contiguous input")
    out = torch.empty_like(x)
    rows = x.numel() // n
    if rows == 0:
        return out
    from ._build import load

    with torch.cuda.device(x.device):
        plan, table = _plan(n, sign, x.device)
        fn = load("dft64").dft64_last
        fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                       ctypes.c_void_p, ctypes.c_longlong, ctypes.c_void_p]
        fn.restype = ctypes.c_int
        err = fn(x.data_ptr(), out.data_ptr(), plan.ctypes.data,
                 table.data_ptr(), rows,
                 torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"dft_last kernel launch failed: CUDA error {err}")
    dft_last.launches += 1
    return out


dft_last.launches = 0


def fft_last(x: torch.Tensor, sign: int = -1) -> torch.Tensor:
    """Unnormalised DFT along the last axis of any length that factors into
    parts <= 256 (``xrft_tpu/ops/df64_fft.py::_df64_fft_last``), in
    complex128; real input is promoted first.  Each stage is a
    :func:`dft_last` over a contiguous last axis; the twiddle is a complex128
    multiply in place."""
    if not x.is_complex():
        x = x.to(torch.complex128)
    n = x.shape[-1]
    if n <= KERNEL_MAX:
        return dft_last(x.contiguous(), sign)
    n1 = _largest_small_divisor(n, KERNEL_MAX)
    if n1 == 1:
        raise NotImplementedError(
            f"df64 FFT of prime size {n} (Bluestein in df64) is not "
            f"implemented; pad to a composite size."
        )
    n2 = n // n1
    shape = x.shape
    # stage 1: DFT over j1 of x[..., j1*n2 + j2], brought last
    a = x.reshape(shape[:-1] + (n1, n2)).transpose(-1, -2).contiguous()
    a = fft_last(a, sign)                                 # (..., m2, k1)
    a.mul_(_twiddle_t(n1, n2, sign, a.device))
    # stage 2: DFT over m2
    a = fft_last(a.transpose(-1, -2).contiguous(), sign)  # (..., k1, k2)
    # output index k = k1 + n1*k2
    return a.transpose(-1, -2).reshape(shape)


def fftn64(x: torch.Tensor, axes, kind: str = "fft") -> torch.Tensor:
    """N-D FFT over ``axes`` in complex128 through :func:`fft_last`
    (``xrft_tpu/ops/df64_fft.py::df64_fft_nd``): ``kind="fft"`` is the
    unnormalised forward transform, ``"ifft"`` the sign +1 transform scaled
    by 1/prod(n), as numpy's."""
    if kind not in ("fft", "ifft"):
        raise ValueError(f"kind must be 'fft' or 'ifft', got {kind!r}")
    sign = -1 if kind == "fft" else 1
    axes = [a % x.ndim for a in ([axes] if isinstance(axes, int) else axes)]
    out = x
    for a in axes:
        out = fft_last(out.movedim(a, -1), sign).movedim(-1, a)
    if kind == "ifft" and axes:
        out = out * (1.0 / math.prod(x.shape[a] for a in axes))
    return out
