"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense rates,
at the full 700 W power limit) and the least time a piece of work takes on
it: the longer of its bytes over HBM bandwidth and its operations over the
peak of the units that may run them."""

from __future__ import annotations

HBM_BYTES_S = 3.35e12
# float32 outside the tensor cores; float64 on the FP64 tensor cores (the
# vector FP64 rate is half); TF32, bf16 and fp16 dense on the tensor cores
PEAK_FLOP_S = {"float32": 67e12, "float64": 67e12, "tf32": 495e12,
               "bfloat16": 989e12, "float16": 989e12}


def least_seconds(work: dict) -> float:
    """max(bytes / HBM bandwidth, flops / peak) of ``work`` (a layer entry of
    a work model: ``bytes``, ``flops``, ``peak``)."""
    return max(work["bytes"] / HBM_BYTES_S,
               work["flops"] / PEAK_FLOP_S[work["peak"]])
