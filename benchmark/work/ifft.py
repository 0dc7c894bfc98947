"""The work of ``ifft`` of a one-sided (fields, fy, fx) spectrum over its two
trailing dims, ``real_dim`` the last: the spectrum read once, the inverse
real 2-D transform (2.5 N log2 N operations a field, N = fy 2 (fx - 1)),
and the real field written once."""

from __future__ import annotations

import math

import torch


def layers(shape, in_dtype: torch.dtype, kwargs) -> dict:
    fields, ny, mh = shape
    n = ny * 2 * (mh - 1)
    real = in_dtype.to_real().itemsize if in_dtype.is_complex else 4
    peak = "float64" if real == 8 else "float32"
    half = fields * ny * mh * 2 * real
    out = fields * n * real
    ops = fields * 2.5 * n * math.log2(n)
    return {
        "call": {"bytes": half + out, "flops": ops, "peak": peak},
        "fft": {"bytes": half + out, "flops": ops, "peak": peak},
    }
