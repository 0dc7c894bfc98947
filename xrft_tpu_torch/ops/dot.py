"""K5a-c: small-weight float32 products over a long column axis
(``csrc/dot.cu``).

Counterpart of ``xrft_tpu/ops/pallas_dot.py``: :func:`pack_block_diag`, K5a
:func:`dot` (``make_dot_kernel``), K5b :func:`dot_fold`
(``make_dot_fold_kernel``) and K5c :func:`dot_dma` (``make_dot_kernel_dma``),
each at full float32 grade, as the TPU kernels run at ``Precision.HIGHEST``.

``x`` is the product's right operand: a (K, N) matrix, or a (P, K, Q) array
read as ``X[j, p*Q + q] = x[p, j, q]`` through its strides, so an axis in the
middle of an array is contracted without a moveaxis copy; the result is
(M, N) (``dot_fold``: (K, N)).  The JAX versions' ``n_cols % tile_cols``
contract does not carry over: the CUDA kernels mask the ragged tail.

Each wrapper launches its kernel for a CUDA tensor and runs its plain version
(``torch.matmul`` at full float32 grade) for a CPU tensor; any other device
raises.  ``launches`` counts kernel launches.
"""

from __future__ import annotations

import ctypes

import torch

from ..config import full_fp32

__all__ = ["pack_block_diag", "dot", "dot_fold", "dot_dma", "dot_plain",
           "dot_fold_plain", "dot_dma_plain"]


def pack_block_diag(w2: torch.Tensor, groups: int) -> torch.Tensor:
    """Block-diagonal expansion diag(w2, ..., w2) packing ``groups``
    independent K-tiles into one contraction
    (``xrft_tpu/ops/pallas_dot.py:55``)."""
    m, k = w2.shape
    out = w2.new_zeros((groups * m, groups * k))
    for g in range(groups):
        out[g * m:(g + 1) * m, g * k:(g + 1) * k] = w2
    return out


def _as3(x: torch.Tensor) -> torch.Tensor:
    """x as (P, K, Q): a (K, N) matrix is (1, K, N)."""
    if x.ndim == 2:
        return x.unsqueeze(0)
    if x.ndim != 3:
        raise ValueError(f"x must be (K, N) or (P, K, Q), got {tuple(x.shape)}")
    return x


def _check(w: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    if w.ndim != 2:
        raise ValueError(f"w must be (M, K), got {tuple(w.shape)}")
    x3 = _as3(x)
    if x3.shape[1] != w.shape[1]:
        raise ValueError(f"contraction mismatch: w {tuple(w.shape)}, x "
                         f"{tuple(x.shape)}")
    if w.dtype != torch.float32 or x.dtype != torch.float32:
        raise ValueError(f"the dot kernels are float32 only, got {w.dtype} "
                         f"and {x.dtype}")
    if w.device != x.device:
        raise ValueError(f"w on {w.device}, x on {x.device}")
    return x3


def dot_plain(w: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """Plain version of K5a: ``torch.matmul`` in float32 with TF32 off."""
    x3 = _check(w, x)
    with full_fp32():
        y = torch.matmul(w, x3)                     # (P, M, Q)
    return y.transpose(0, 1).reshape(w.shape[0], -1)


def dot_fold_plain(w: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """Plain version of K5b: ``y[:K] + 1e-38 * y[K:]`` of ``y = w @ x``."""
    k = w.shape[1]
    if w.shape[0] != 2 * k:
        raise ValueError("fold kernel expects M == 2K")
    y = dot_plain(w, x)
    return y[:k] + 1e-38 * y[k:]


dot_dma_plain = dot_plain


def _launch(symbol: str, w: torch.Tensor, x3: torch.Tensor,
            out_rows: int) -> torch.Tensor:
    if x3.device.type != "cuda":
        raise ValueError(f"the dot kernels run on cuda or cpu tensors, not "
                         f"{x3.device.type}")
    P, K, Q = x3.shape
    out = torch.empty((out_rows, P * Q), dtype=torch.float32,
                      device=x3.device)
    if out.numel() == 0:
        return out
    wt = w.t().contiguous()                         # (K, M)
    from ._build import load

    with torch.cuda.device(x3.device):
        fn = getattr(load("dot"), symbol)
        fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                       ctypes.c_int, ctypes.c_int, ctypes.c_longlong,
                       ctypes.c_longlong, ctypes.c_longlong,
                       ctypes.c_longlong, ctypes.c_longlong, ctypes.c_void_p]
        fn.restype = ctypes.c_int
        sP, sK, sQ = x3.stride()
        if P == 1:
            sP = 0  # one block of columns: its stride is never used
        err = fn(wt.data_ptr(), x3.data_ptr(), out.data_ptr(), w.shape[0], K,
                 P, Q, sP, sK, sQ, torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"{symbol} kernel launch failed: CUDA error {err}")
    return out


def dot(w: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """K5a: ``W(M, K) @ X`` in float32 at full float32 grade."""
    x3 = _check(w, x)
    if x3.device.type == "cpu":
        return dot_plain(w, x)
    out = _launch("dot_f32", w, x3, w.shape[0])
    dot.launches += 1
    return out


def dot_fold(w: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """K5b: ``(W[:K] @ X) + 1e-38 * (W[K:] @ X)`` for ``W(2K, K)``, in one
    pass over X."""
    x3 = _check(w, x)
    if w.shape[0] != 2 * w.shape[1]:
        raise ValueError("fold kernel expects M == 2K")
    if x3.device.type == "cpu":
        return dot_fold_plain(w, x)
    out = _launch("dot_fold_f32", w, x3, w.shape[1])
    dot_fold.launches += 1
    return out


def dot_dma(w: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """K5c: K5a's function on persistent blocks with a two-stage copy
    ring; equal to :func:`dot` bit for bit."""
    x3 = _check(w, x)
    if x3.device.type == "cpu":
        return dot_dma_plain(w, x)
    out = _launch("dot_dma_f32", w, x3, w.shape[0])
    dot_dma.launches += 1
    return out


dot.launches = 0
dot_fold.launches = 0
dot_dma.launches = 0
