"""The work of ``power_spectrum`` of a real (fields, y, x) stack over its two
trailing dims, with the linear detrend and a window: the field read once,
the real 2-D transform (2.5 N log2 N operations a field, N = y x), and the
two-sided spectrum written once, in float64 on the hp path
(``engine="hp"``) and in the data's single precision otherwise."""

from __future__ import annotations

import math

import torch


def layers(shape, in_dtype: torch.dtype, kwargs) -> dict:
    fields, ny, nx = shape
    n = ny * nx
    hp = kwargs.get("engine") == "hp" or in_dtype == torch.float64
    real = 8 if hp else 4
    peak = "float64" if hp else "float32"
    field_in = fields * n * in_dtype.itemsize
    prepared = fields * n * real           # detrended, windowed, the FFT's input
    half = fields * ny * (nx // 2 + 1) * 2 * real   # one-sided spectrum
    psd = fields * n * real                # two-sided spectrum
    ops = fields * 2.5 * n * math.log2(n)
    return {
        "call": {"bytes": field_in + psd, "flops": ops, "peak": peak},
        "prologue": {"bytes": field_in + prepared, "flops": 0.0,
                     "peak": peak},
        "fft": {"bytes": prepared + half, "flops": ops, "peak": peak},
        "epilogue": {"bytes": half + psd, "flops": 0.0, "peak": peak},
    }
