"""K5a-c: small-weight float32 products over a long column axis
(``csrc/dot.cu``).

Counterpart of ``xrft_tpu/ops/pallas_dot.py``: :func:`pack_block_diag`, K5a
:func:`dot` (``make_dot_kernel``), K5b :func:`dot_fold`
(``make_dot_fold_kernel``) and K5c :func:`dot_dma` (``make_dot_kernel_dma``),
each at full float32 grade, as the TPU kernels run at ``Precision.HIGHEST``.
K5a and K5c run on the tensor cores in 3xTF32 (:func:`dot_replay` repeats
their arithmetic on the host, for the tests); K5b runs FP32 FMAs.  K5c keeps
W resident in the shared memory of a group of CTAs (so ``M <= 512`` and
``K <= 256``) and reads X by TMA where :func:`dma_tensor_map` finds a tensor
map for it, by cp.async otherwise.

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
           "dot_fold_plain", "dot_dma_plain", "tf32_rna", "dot_replay",
           "dma_tensor_map"]

# K5c's contract: W's rows held by one group of CTAs of 64 rows, its K
# chunks of 32 resident (``csrc/dot.cu``'s kDmaMaxGroup, kDmaMaxChunks)
DMA_MAX_M, DMA_MAX_K = 8 * 64, 8 * 32
# K5c's X box: 32 columns (128 bytes, the TMA's swizzle span) x 32 of K; a
# stage of a 128-column tile is four of them
DMA_BOX = (32, 32)
DMA_TILE_COLS = 128


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


def tf32_rna(v: torch.Tensor) -> torch.Tensor:
    """float32 ``v`` rounded to TF32 as ``cvt.rna.tf32.f32`` does: the 13
    low mantissa bits rounded to nearest, ties away from zero, then cleared
    (the largest finite floats round to inf); inf and NaN pass through."""
    if v.dtype != torch.float32:
        raise ValueError(f"tf32_rna takes float32, got {v.dtype}")
    bits = v.contiguous().view(torch.int32)
    # the int32 sum never carries into the sign: |bits| <= 0x7f7fffff
    rounded = (bits + 0x1000) & -0x2000
    special = (bits & 0x7f800000) == 0x7f800000
    return torch.where(special, bits, rounded).view(torch.float32)


def dot_replay(w: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """K5a's and K5c's arithmetic on the host (for the tests; the card's
    kernels are :func:`dot` and :func:`dot_dma`, which share its device
    functions ``split_frags`` and ``tc_chunk``): each operand split into ``hi = tf32_rna(v)`` and
    ``lo = tf32_rna(v - hi)``, the small products ``x_lo w_hi`` and
    ``x_hi w_lo`` summed into one float32 accumulator and ``x_hi w_hi`` into
    another, 8-deep step by step (each product exact in float32, the sums
    in k order: the tensor cores' order inside a step is their own), then
    the two accumulators added."""
    x3 = _check(w, x)
    xm = x3.transpose(0, 1).reshape(w.shape[1], -1)     # X(K, N)
    whi, xhi = tf32_rna(w), tf32_rna(xm)
    wlo, xlo = tf32_rna(w - whi), tf32_rna(xm - xhi)
    small = torch.zeros((w.shape[0], xm.shape[1]), dtype=torch.float32,
                        device=w.device)
    big = torch.zeros_like(small)
    K = w.shape[1]
    for k0 in range(0, K, 8):
        ks = range(k0, min(K, k0 + 8))
        for k in ks:
            small += whi[:, k, None] * xlo[None, k]
        for k in ks:
            small += wlo[:, k, None] * xhi[None, k]
        for k in ks:
            big += whi[:, k, None] * xhi[None, k]
    return small + big


def dma_tensor_map(x: torch.Tensor):
    """K5c's X producer for ``x`` ((K, N), or (P, K, Q) read through its
    strides): the TMA tensor map as {"rank", "dims" (elements, innermost
    first), "strides" (bytes, rank - 1 of them), "box"}, or None where the
    TMA cannot describe the layout and a cp.async producer copies X.

    The TMA needs a 16-byte aligned base, strides that are 16-byte
    multiples, a contiguous innermost axis and int32 coordinates.  A
    (K, N) operand (P == 1) is a 2-D map (n, j); a (P, K, Q) one is a 3-D
    map (q, j, p) whose Q is a multiple of 32, so that each 32-column box of
    a tile lies within one p."""
    x3 = _as3(x)
    P, K, Q = x3.shape
    sP, sK, sQ = x3.stride()
    if x3.data_ptr() % 16 or Q < DMA_BOX[0] or (sQ != 1 and Q > 1) \
            or sK * 4 % 16 or P * Q >= 2 ** 31 or K >= 2 ** 31:
        return None
    if P == 1:
        return {"rank": 2, "dims": (Q, K), "strides": (sK * 4,),
                "box": DMA_BOX}
    if Q % DMA_BOX[0] or sP * 4 % 16:
        return None
    return {"rank": 3, "dims": (Q, K, P), "strides": (sK * 4, sP * 4),
            "box": DMA_BOX + (1,)}


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
        lib = load("dot")
        fn = getattr(lib, symbol)
        argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                    ctypes.c_int, ctypes.c_int, ctypes.c_longlong,
                    ctypes.c_longlong, ctypes.c_longlong, ctypes.c_longlong,
                    ctypes.c_longlong]
        sP, sK, sQ = x3.stride()
        if P == 1:
            sP = 0  # one block of columns: its stride is never used
        args = [wt.data_ptr(), x3.data_ptr(), out.data_ptr(), w.shape[0], K,
                P, Q, sP, sK, sQ]
        if symbol == "dot_dma_f32":
            # K5c's X producer: a TMA tensor map, or rank 0 (cp.async)
            tm = dma_tensor_map(x3) or {"rank": 0, "dims": (0, 0, 0),
                                        "strides": (0, 0), "box": (0, 0, 0)}
            u64, u32 = ctypes.c_ulonglong, ctypes.c_uint
            argtypes += [ctypes.c_int, ctypes.POINTER(u64),
                         ctypes.POINTER(u64), ctypes.POINTER(u32)]
            args += [tm["rank"], (u64 * 3)(*tm["dims"]),
                     (u64 * 2)(*tm["strides"]), (u32 * 3)(*tm["box"])]
        if symbol in ("dot_f32", "dot_dma_f32"):
            # scratch: W split into TF32 hi and lo, in the kernel's order
            size = getattr(lib, symbol.replace("_f32", "_f32_scratch"))
            size.argtypes = [ctypes.c_int, ctypes.c_int]
            size.restype = ctypes.c_longlong
            scratch = torch.empty(size(w.shape[0], K), dtype=torch.float32,
                                  device=x3.device)
            argtypes.append(ctypes.c_void_p)
            args.append(scratch.data_ptr())
        fn.argtypes = argtypes + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        err = fn(*args, torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"{symbol} kernel launch failed: CUDA error {err}")
    return out


def dot(w: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """K5a: ``W(M, K) @ X`` at float32 grade, in 3xTF32 on the tensor
    cores (:func:`dot_replay` is its arithmetic)."""
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
    """K5c: K5a's function and 3xTF32 arithmetic with the copies explicit:
    W resident in shared memory (``M <= 512``, ``K <= 256``), X in by TMA
    or cp.async, the output out by TMA; within
    1e-6 of max of its plain version, and its repeats bit-identical."""
    x3 = _check(w, x)
    if w.shape[0] > DMA_MAX_M or w.shape[1] > DMA_MAX_K:
        raise ValueError(f"dot_dma keeps W resident: M <= {DMA_MAX_M} and "
                         f"K <= {DMA_MAX_K}, got {tuple(w.shape)}")
    if x3.device.type == "cpu":
        return dot_dma_plain(w, x)
    out = _launch("dot_dma_f32", w, x3, w.shape[0])
    dot_dma.launches += 1
    return out


dot.launches = 0
dot_fold.launches = 0
dot_dma.launches = 0
