"""The dtypes the JAX package computes non-float data in, for torch data.

``xrft_tpu`` promotes integer, bool and float16 data by two rules, both of
which the port repeats where the JAX package applies them:

  * ``"jax"``   - JAX's ``to_inexact_dtype`` (``LabeledArray.mean``, the
                  constant detrend, every transform): bool and integers of
                  up to 32 bits give float32, 64-bit integers float64;
                  floats stay as they are.
  * ``"numpy"`` - ``numpy.result_type(dtype, float32)`` (the linear
                  detrend, ``xrft_tpu/detrend.py:96``; with complex64, the
                  inverse's phase factors, ``ops/carray.py:544``): bool and
                  integers of up to 16 bits give float32, wider integers
                  float64, and float16 gives float32.

``"float64"`` sends every non-float dtype to float64 (the filter and
trigonometric families, which compute integer data in float64 as scipy
does) and float16 and bfloat16 to float32.

Under every rule complex32 data give complex64: the port's single-precision
rule computes data of less than single precision in single precision.
"""

from __future__ import annotations

import torch

__all__ = ["float_dtype", "promote", "complex_dtype"]


def float_dtype(dtype: torch.dtype, rule: str) -> torch.dtype:
    """The floating (or complex) dtype that ``rule`` gives data of
    ``dtype``."""
    if dtype.is_complex:
        return torch.complex64 if dtype.itemsize < 8 else dtype
    if dtype.is_floating_point:
        return torch.float32 if rule in ("numpy", "float64") \
            and dtype.itemsize < 4 else dtype
    if rule == "float64":
        return torch.float64
    widest_single = 2 if rule == "numpy" else 4
    return torch.float32 if dtype.itemsize <= widest_single \
        else torch.float64


def complex_dtype(dtype: torch.dtype, rule: str = "jax") -> torch.dtype:
    """The complex dtype of ``rule``'s promotion: complex64 for data of
    single precision or less, complex128 for double (with ``"jax"``, JAX's
    ``to_complex_dtype``; with ``"numpy"``, ``numpy.result_type(dtype,
    complex64)``)."""
    dtype = float_dtype(dtype, rule)
    if dtype.is_complex:
        return dtype
    return torch.complex128 if dtype == torch.float64 else torch.complex64


def promote(x: torch.Tensor, rule: str = "jax") -> torch.Tensor:
    """``x`` in :func:`float_dtype` of its dtype (``x`` itself where that
    is its dtype)."""
    dtype = float_dtype(x.dtype, rule)
    return x if dtype == x.dtype else x.to(dtype)
