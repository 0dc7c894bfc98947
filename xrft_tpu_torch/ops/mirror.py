"""K1: the fused two-sided PSD epilogue (``csrc/mirror.cu``).

Turns the unshifted complex half spectrum ``F[..., NY, MH]`` of a real 2-D
transform into the scaled two-sided PSD ``P[..., NY, NX]``:

    ky = (oy - hy) mod NY,  k = (ox - hx) mod NX,  h* = N*//2 if shift else 0
    k <= NX//2 :  P = s * |F[..., ky, k]|^2
    otherwise  :  P = s * |F[..., (NY - ky) mod NY, NX - k]|^2

Counterpart of ``xrft_tpu/ops/pallas_mirror.py::mirror_two_sided``, with
|F|^2, the scale and the y-fftshift folded in.  :func:`mirror_psd` launches
the CUDA kernel for a CUDA tensor and runs :func:`mirror_psd_plain` (torch
ops, same index maps) for a CPU tensor; any other device raises.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from .. import telemetry

__all__ = ["mirror_psd", "mirror_psd_plain"]

_ENTRY = {torch.complex64: "mirror_psd_f32", torch.complex128: "mirror_psd_f64"}


def _index_maps(ny: int, nx: int, shift: bool):
    """Host index maps of the output grid: source row of each output row
    for direct and mirrored columns, source column of each output column,
    and which output columns are direct."""
    hy = ny // 2 if shift else 0
    hx = nx // 2 if shift else 0
    ky = (np.arange(ny) - hy) % ny
    k = (np.arange(nx) - hx) % nx
    direct = k <= nx // 2
    return ky, (ny - ky) % ny, np.where(direct, k, nx - k), direct


def mirror_psd_plain(F: torch.Tensor, n_full: int, shift: bool,
                     scale: float) -> torch.Tensor:
    """Plain torch version of the kernel (the CPU route and the oracle on the
    card): ``(F.real**2 + F.imag**2) * scale``, then two ``index_select``
    gathers with host-built index maps."""
    p = (F.real ** 2 + F.imag ** 2) * scale
    ky, ky_mirror, col, direct = _index_maps(F.shape[-2], n_full, shift)
    out = torch.empty(F.shape[:-1] + (n_full,), dtype=p.dtype,
                      device=p.device)
    for rows, keep in ((ky, direct), (ky_mirror, ~direct)):
        pos = np.nonzero(keep)[0]
        if pos.size == 0:
            continue
        src = p.index_select(-2, telemetry.to_device(rows, device=p.device))
        src = src.index_select(
            -1, telemetry.to_device(col[pos], device=p.device))
        out.index_copy_(-1, telemetry.to_device(pos, device=p.device), src)
    return out


def mirror_psd(F: torch.Tensor, n_full: int, shift: bool,
               scale: float) -> torch.Tensor:
    """Scaled two-sided PSD ``[..., NY, n_full]`` from the unshifted complex
    half spectrum ``F[..., NY, MH]`` (``MH >= n_full//2 + 1``; columns past
    ``n_full//2`` are ignored).  complex64 gives float32, complex128 gives
    float64."""
    if F.dtype not in _ENTRY:
        raise ValueError(f"mirror_psd takes complex64/complex128, got {F.dtype}")
    if F.ndim < 2:
        raise ValueError(f"mirror_psd needs [..., NY, MH], got {tuple(F.shape)}")
    ny, mh = F.shape[-2], F.shape[-1]
    if n_full < 1 or mh < n_full // 2 + 1:
        raise ValueError(
            f"half spectrum has {mh} columns; n_full={n_full} needs "
            f"{n_full // 2 + 1}")
    if F.device.type == "cpu":
        return mirror_psd_plain(F, n_full, shift, scale)
    if F.device.type != "cuda":
        raise ValueError(f"mirror_psd runs on cuda or cpu tensors, not "
                         f"{F.device.type}")
    if not F.is_contiguous():
        raise ValueError("mirror_psd needs a contiguous half spectrum")
    out = torch.empty(F.shape[:-1] + (n_full,), dtype=F.dtype.to_real(),
                      device=F.device)
    if out.numel() == 0:
        return out
    batch = F.numel() // (ny * mh)
    from ._build import load

    with torch.cuda.device(F.device):
        fn = getattr(load("mirror"), _ENTRY[F.dtype])
        fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong,
                       ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                       ctypes.c_double, ctypes.c_void_p]
        fn.restype = ctypes.c_int
        err = fn(F.data_ptr(), out.data_ptr(), batch, ny, mh, n_full,
                 int(bool(shift)), float(scale),
                 torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"mirror_psd kernel launch failed: CUDA error {err}")
    mirror_psd.launches += 1
    return out


mirror_psd.launches = 0
