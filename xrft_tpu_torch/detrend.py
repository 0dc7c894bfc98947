"""Detrending with the closed-form hyperplane fit, in torch.

Counterpart of ``xrft_tpu/detrend.py``.  On a full regular grid the centered
per-axis index coordinates are mutually orthogonal regressors, so the
least-squares fit ``a0 + a1*i + a2*j (+ ...)`` decouples into the grid mean
plus one independent slope per axis,

    a_m = <d, c_m> / <c_m, c_m>,   c_m = i_m - mean(i_m),

which is exactly the solution xrft's per-block solver computes
(``xrft/detrend.py:64-95``), for any number of dims.
"""

from __future__ import annotations

import numpy as np
import torch

from .labeled import LabeledArray

__all__ = ["detrend"]


def detrend(da: LabeledArray, dim, detrend_type="constant") -> LabeledArray:
    """Detrend a LabeledArray along dim(s).

    detrend_type:
      - None       : passthrough
      - 'constant' : remove the mean over ``dim``
      - 'linear'   : remove the least-squares linear (hyperplane) fit over
                     ``dim``
    """
    if dim is None:
        dim = list(da.dims)
    elif isinstance(dim, str):
        dim = [dim]

    if detrend_type not in ["constant", "linear", None]:
        raise NotImplementedError(
            f"{detrend_type} is not a valid detrending option. Valid "
            "options are: 'constant','linear', or None."
        )

    if detrend_type is None:
        return da
    if detrend_type == "constant":
        return da - da.mean(dim=dim)
    axes = tuple(da.get_axis_num(d) for d in dim)
    return da.copy(data=da.data - _linear_fit(da.data, axes))


def _linear_fit(x: torch.Tensor, axes: tuple[int, ...]) -> torch.Tensor:
    """The least-squares linear trend of x over `axes` (broadcast over the
    remaining axes), in x's dtype."""
    fit = torch.mean(x, dim=axes, keepdim=True)
    n_el = 1.0
    for a in axes:
        n_el *= x.shape[a]
    for a in axes:
        n = x.shape[a]
        if n == 1:
            continue
        shape = [1] * x.ndim
        shape[a] = n
        # centered index coordinate arange(n) - (n-1)/2, built in float64 on
        # the host; its sum of squares stays a float64 scalar
        c64 = np.arange(n) - (n - 1) / 2.0
        c = torch.as_tensor(c64.reshape(shape), dtype=x.dtype,
                            device=x.device)
        css = float(np.sum(c64 ** 2)) * (n_el / n)
        slope = torch.sum(x * c, dim=axes, keepdim=True) / css
        fit = fit + slope * c
    return fit
