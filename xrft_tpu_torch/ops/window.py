"""Window functions: built on the host, applied on the data's device.

Counterpart of ``xrft_tpu/ops/window.py``.  A window is a pure function of
(window name, axis length), so each 1-D window is generated on the host with
``scipy.signal.windows`` in float64 (``sym=False``, the reference's periodic
convention) and moved to the data's device in the data's real dtype; the
N-D window is the separable product over the transform dims, applied by
dim-aligned broadcasting (``xrft/xrft.py:39-103``).  :func:`window_factor`
is the one place a 1-D factor is made; the spectra's window correction is
taken from those factors (:func:`correction_factor`), never from the N-D
window.
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

__all__ = ["apply_window", "build_window", "correction_factor",
           "warn_if_true", "window_factor", "window_vectors", "WINDOW_TYPES"]

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


def warn_if_true(window_type):
    """The deprecation warning of ``window=True``, the name "hann"."""
    if window_type is True:
        warnings.warn(
            "Please provide the name of window adhering to "
            "scipy.signal.windows. The boolean option will be deprecated in "
            "future releases.",
            FutureWarning,
        )


def window_factor(window_type, n: int) -> np.ndarray:
    """The 1-D factor of length ``n`` of the window ``window_type`` (``True``
    is "hann"; the caller warns): ``scipy.signal.windows``' periodic
    (``sym=False``) window in float64, the one place it is made."""
    if window_type is True:
        window_type = "hann"
    if window_type not in WINDOW_TYPES:
        raise NotImplementedError(
            f"Window type {window_type} not supported. Please adhere to "
            "scipy.signal.windows for naming convention."
        )
    return np.asarray(getattr(sps.windows, window_type)(n, sym=False),
                      dtype=np.float64)


def window_vectors(da: LabeledArray, dims, window_type, dtype,
                   device) -> list:
    """The 1-D factors of the window over ``dims`` (a list), in ``dtype``
    on ``device``, each generated in float64 on the host and copied once
    (``True`` is the deprecated name of "hann")."""
    warn_if_true(window_type)
    return [telemetry.to_device(window_factor(window_type, da.sizes[d]),
                                dtype=dtype, device=device) for d in dims]


def correction_factor(da: LabeledArray, dims, window_type,
                      scaling) -> float:
    """The window correction of a spectrum over ``dims`` (a list): the
    separable N-D window's mean square (``scaling == "density"``) or
    squared mean (any other), as the product over ``dims`` of each 1-D
    factor's, in host float64; no N-D window is built."""
    if window_type is None:
        raise ValueError(
            "window_correction can only be applied when windowing is "
            "turned on."
        )
    corr = 1.0
    for d in dims:
        w = window_factor(window_type, da.sizes[d])
        corr *= float(np.mean(w ** 2)) if scaling == "density" \
            else float(np.mean(w)) ** 2
    return corr


def build_window(da: LabeledArray, dims, window_type="hann", dtype=None,
                 device=None) -> LabeledArray:
    """The separable N-D window over ``dims`` as a LabeledArray, in
    ``dtype`` (default: the real dtype of ``da``) on ``device`` (default:
    ``da``'s)."""
    if dims is None:
        dims = list(da.dims)
    elif isinstance(dims, str):
        dims = [dims]
    dtype = real_dtype(da.dtype) if dtype is None else dtype
    device = da.device if device is None else device
    windows = [
        LabeledArray(w, dims=(d,),
                     coords={d: da.coords[d]} if d in da.coords else None)
        for d, w in zip(dims, window_vectors(da, dims, window_type, dtype,
                                             device))]
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
