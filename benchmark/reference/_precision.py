"""Working precisions of the plain references.

``float64`` is the reference itself.  The lower ones are the controls:
``float32`` (float32 and complex64 arithmetic, the control of a float64
cell) and ``tf32`` (the same, with every stage's result rounded to a 10-bit
mantissa, as a float32 GEMM with TF32 on: the control of a float32 cell
whose TF32 is off).
Imports torch and numpy only.
"""

from __future__ import annotations

import torch

PRECISIONS = ("float64", "float32", "tf32")


def dtypes(precision: str) -> tuple[torch.dtype, torch.dtype]:
    """(real, complex) dtypes the arithmetic runs in."""
    if precision not in PRECISIONS:
        raise ValueError(f"unknown precision {precision!r}; expected one of "
                         f"{PRECISIONS}")
    if precision == "float64":
        return torch.float64, torch.complex128
    return torch.float32, torch.complex64


def _tf32(t: torch.Tensor) -> torch.Tensor:
    """float32 ``t`` with its mantissa rounded to the top 10 bits, to
    nearest even."""
    i = t.contiguous().view(torch.int32)
    lsb = torch.bitwise_and(torch.bitwise_right_shift(i, 13), 1)
    i = torch.bitwise_and(i + (0xFFF + lsb), -8192)
    return i.view(torch.float32)


def rounded(t: torch.Tensor, precision: str) -> torch.Tensor:
    """``t`` rounded to the storage precision (a no-op but for ``tf32``);
    complex tensors part by part."""
    if precision != "tf32":
        return t
    if t.is_complex():
        return torch.view_as_complex(_tf32(torch.view_as_real(t)))
    return _tf32(t)
