"""The work of ``power_spectrum`` of a real array over its transform dims
``dim`` (any number of them), over the whole global array: the field read
once, the real N-D transform (2.5 N log2 N operations a field, N the product
of the transform lengths), and the two-sided spectrum written once, in
float64 on the hp path (``engine="hp"``) and in the data's single precision
otherwise.  A sharded entry's model names the dims besides the shapes
(``layers(shape, in_dtype, kwargs, dims)``, over the global array); the
harness gives each rank of a sharded cell an even share."""

from __future__ import annotations

import math

import torch


def layers(shape, in_dtype: torch.dtype, kwargs, dims) -> dict:
    axes = [dims.index(d) for d in kwargs["dim"]]
    n = math.prod(shape[a] for a in axes)
    fields = math.prod(shape) // n
    last = shape[max(axes)]
    hp = kwargs.get("engine") == "hp" or in_dtype == torch.float64
    real = 8 if hp else 4
    peak = "float64" if hp else "float32"
    field_in = fields * n * in_dtype.itemsize
    prepared = fields * n * real           # detrended, windowed, the FFT's input
    half = fields * n // last * (last // 2 + 1) * 2 * real
    psd = fields * n * real                # two-sided spectrum
    ops = fields * 2.5 * n * math.log2(n)
    return {
        "call": {"bytes": field_in + psd, "flops": ops, "peak": peak},
        "prologue": {"bytes": field_in + prepared, "flops": 0.0,
                     "peak": peak},
        "fft": {"bytes": prepared + half, "flops": ops, "peak": peak},
        "epilogue": {"bytes": half + psd, "flops": 0.0, "peak": peak},
    }
