"""Window functions: built on the host, applied on the data's device.

Counterpart of ``xrft_tpu/ops/window.py``.  A window is a pure function of
(window name, axis length), so each 1-D window is generated on the host with
``scipy.signal.windows`` in float64 (``sym=False``, the reference's periodic
convention) and moved to the data's device in the data's real dtype; the
N-D window is the separable product over the transform dims, applied by
dim-aligned broadcasting (``xrft/xrft.py:39-103``).
"""

from __future__ import annotations

import operator
import warnings
from functools import reduce as _reduce

import numpy as np
import scipy.signal as sps
import torch

from .. import telemetry
from ..dtypes import float_dtype
from ..labeled import LabeledArray

__all__ = ["apply_window", "WINDOW_TYPES"]

# the reference's allowlist (xrft/xrft.py:48-72)
WINDOW_TYPES = [
    "hann", "hamming", "kaiser", "tukey", "parzen", "taylor", "boxcar",
    "barthann", "bartlett", "blackman", "blackmanharris", "bohman",
    "chebwin", "cosine", "dpss", "exponential", "flattop", "gaussian",
    "general_cosine", "general_gaussian", "general_hamming", "triang",
    "nuttall",
]


def real_dtype(dtype: torch.dtype) -> torch.dtype:
    """The real dtype that multiplies data of ``dtype`` without promoting
    it past single precision: the dtype itself for float32 and float64, its
    component dtype for complex64 and complex128, float32 for float16,
    bfloat16 and complex32 (which ``xrft_tpu`` windows in float64, and a
    transform would reject), and float64 for integer and bool data, as
    ``xrft_tpu``'s float64 window promotes them."""
    return float_dtype(dtype, "float64").to_real()


def build_window(da: LabeledArray, dims, window_type="hann", dtype=None,
                 device=None) -> LabeledArray:
    """The separable N-D window over ``dims`` as a LabeledArray, in
    ``dtype`` (default: the real dtype of ``da``) on ``device`` (default:
    ``da``'s)."""
    if window_type is True:
        window_type = "hann"
        warnings.warn(
            "Please provide the name of window adhering to "
            "scipy.signal.windows. The boolean option will be deprecated in "
            "future releases.",
            FutureWarning,
        )
    elif window_type not in WINDOW_TYPES:
        raise NotImplementedError(
            f"Window type {window_type} not supported. Please adhere to "
            "scipy.signal.windows for naming convention."
        )
    if dims is None:
        dims = list(da.dims)
    elif isinstance(dims, str):
        dims = [dims]
    dtype = real_dtype(da.dtype) if dtype is None else dtype
    device = da.device if device is None else device

    win_func = getattr(sps.windows, window_type)
    windows = []
    for d in dims:
        w = np.asarray(win_func(da.sizes[d], sym=False), dtype=np.float64)
        coords = {d: da.coords[d]} if d in da.coords else None
        windows.append(LabeledArray(
            telemetry.to_device(w, dtype=dtype, device=device), dims=(d,),
            coords=coords))
    # outer product in reversed order, as the reference's
    # reduce(operator.mul, windows[::-1])
    return _reduce(operator.mul, windows[::-1])


def apply_window(da: LabeledArray, dims, window_type="hann"):
    """Build the separable N-D window over `dims` and apply it.

    Returns ``(window, windowed_da)`` like the reference.  The 1-D factors
    are rounded to the data's real dtype before the product, so float32
    data stays float32.
    """
    window = build_window(da, dims, window_type)
    return window, da * window
