"""K2: the float32 DFT along the last axis (``csrc/fft_fourstep.cu``).

Counterpart of ``xrft_tpu/ops/pallas_fft.py::pallas_fft_last``: for
``n = n1*n2`` with ``(n1, n2) = _balanced_factors(n)`` (both <= 256, and
``n >= 256``), a float32 or complex64 ``(..., n)`` input gives the
unnormalised complex64 DFT ``sum_j x[j] exp(sign*2*pi*i*j*k/n)`` in natural
frequency order.  The kernel is a shared-memory Stockham FFT on the plan of
:mod:`.fft_plan`: one launch for rows of up to ``FUSED_MAX`` points, the
four-step form in two passes through a scratch tensor above that.  The
plain version :func:`fft_last_plain` (torch einsums) keeps the TPU kernel's
factors, tables and digit order, which the CPU tests pin against it.
:func:`fft_last` launches the CUDA kernel for a CUDA tensor and runs the
plain version for a CPU tensor; any other device raises.
"""

from __future__ import annotations

import ctypes
from functools import lru_cache

import numpy as np
import torch

from ..config import full_fp32
from . import fft_plan

__all__ = ["fft_last", "fft_last_plain", "check_supported"]

MIN_N = 256
FUSED_MAX = 8192   # longest row the kernel transforms in shared memory


@lru_cache(maxsize=None)
def _balanced_factors(n: int, cap: int = 256):
    """Most-balanced divisor pair (n1, n2 <= cap) with n = n1*n2 and
    n1 >= n2, or None (``xrft_tpu/ops/pallas_fft.py:53-64``)."""
    best = None
    d = 1
    while d * d <= n:
        if n % d == 0:
            q = n // d
            if d <= cap and q <= cap:
                best = (q, d)
        d += 1
    return best


def check_supported(n: int, dtype: torch.dtype) -> tuple[int, int]:
    """(n1, n2) for a length-n transform of ``dtype`` data, or ValueError."""
    if dtype not in (torch.float32, torch.complex64):
        raise ValueError(
            f"the four-step kernel is float32/complex64 only, got {dtype}")
    factors = _balanced_factors(n)
    if n < MIN_N or factors is None:
        raise ValueError(
            f"the four-step kernel needs n >= {MIN_N} with a factor pair "
            f"n1*n2 = n, n1, n2 <= 256; n = {n} has none")
    return factors


@lru_cache(maxsize=None)
def _tables_np(n1: int, n2: int, sign: int):
    """complex64 tables W_m^e = exp(sign*2*pi*i*e/m), e in [0, m), for
    m = n1, n2 and n1*n2 (float64 on the host, then rounded)."""
    def table(m):
        ang = (2.0 * np.pi * sign / m) * np.arange(m)
        return (np.cos(ang) + 1j * np.sin(ang)).astype(np.complex64)
    return table(n1), table(n2), table(n1 * n2)


@lru_cache(maxsize=64)
def _tables(n1, n2, sign, device):
    """The tables as tensors on ``device``, copied there once."""
    return [torch.as_tensor(t, device=device) for t in _tables_np(n1, n2, sign)]


@lru_cache(maxsize=64)
def _plan(n, sign, device):
    """The kernel's int32 plan (host; two passes above ``FUSED_MAX``) and
    its table rounded to complex64 on ``device``, copied there once."""
    split = None if n <= FUSED_MAX else _balanced_factors(n)
    plan, table = fft_plan.build(n, sign, split)
    return plan, torch.as_tensor(table.astype(np.complex64), device=device)


def fft_last_plain(x: torch.Tensor, sign: int = -1) -> torch.Tensor:
    """Plain torch version of the kernel, on the TPU kernel's tables: two
    einsums and the twiddle multiply, in complex64 at full float32 grade
    (``full_fp32``, which leaves the caller's TF32 setting as it was)."""
    n = x.shape[-1]
    n1, n2 = check_supported(n, x.dtype)
    t1, t2, tn = _tables(n1, n2, sign, x.device)
    j1, j2 = np.arange(n1), np.arange(n2)
    dev = x.device
    w1 = t1[torch.as_tensor(np.outer(j1, j1) % n1, device=dev)]   # (j1, k1)
    w2 = t2[torch.as_tensor(np.outer(j2, j2) % n2, device=dev)]   # (j2, k2)
    tw = tn[torch.as_tensor(np.outer(j2, j1) % n, device=dev)]    # (j2, k1)
    xr = x.reshape(-1, n1, n2).to(torch.complex64)               # (r, j1, j2)
    with full_fp32():
        b = torch.einsum("rab,ak->rbk", xr, w1) * tw             # (r, j2, k1)
        d = torch.einsum("rbk,bm->rkm", b, w2)                   # (r, k1, k2)
    # frequency k = k1 + n1*k2 is the row-major flattening of (k2, k1)
    return d.transpose(1, 2).reshape(x.shape)


def fft_last(x: torch.Tensor, sign: int = -1) -> torch.Tensor:
    """Unnormalised DFT along the last axis of a float32 or complex64
    tensor; ``sign`` is -1 (forward) or +1."""
    if sign not in (-1, 1):
        raise ValueError(f"sign must be -1 or +1, got {sign}")
    if x.ndim < 1:
        raise ValueError("fft_last needs at least one axis")
    n = x.shape[-1]
    n1, n2 = check_supported(n, x.dtype)
    if x.device.type == "cpu":
        return fft_last_plain(x, sign)
    if x.device.type != "cuda":
        raise ValueError(f"fft_last runs on cuda or cpu tensors, not "
                         f"{x.device.type}")
    if not x.is_contiguous():
        raise ValueError("fft_last needs a contiguous input")
    rows = x.numel() // n
    strips = -(-max(n1, n2) // 16)
    if rows * strips >= 2 ** 31:
        raise ValueError(f"{rows} rows exceed the kernel's grid")
    out = torch.empty(x.shape, dtype=torch.complex64, device=x.device)
    if rows == 0:
        return out
    scratch = None
    if n > FUSED_MAX:
        scratch = torch.empty((rows, n), dtype=torch.complex64,
                              device=x.device)
    from ._build import load

    with torch.cuda.device(x.device):
        plan, table = _plan(n, sign, x.device)
        fn = load("fft_fourstep").fft_fourstep_f32
        fn.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p,
                       ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                       ctypes.c_longlong, ctypes.c_void_p]
        fn.restype = ctypes.c_int
        err = fn(x.data_ptr(), int(x.is_complex()),
                 None if scratch is None else scratch.data_ptr(),
                 out.data_ptr(), plan.ctypes.data, table.data_ptr(), rows,
                 torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"fft_last kernel launch failed: CUDA error {err}")
    fft_last.launches += 1
    return out


fft_last.launches = 0
