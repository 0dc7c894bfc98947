"""Detrending with the closed-form hyperplane fit, in torch.

Counterpart of ``xrft_tpu/detrend.py``.  On a full regular grid the centered
per-axis index coordinates are mutually orthogonal regressors, so the
least-squares fit ``a0 + a1*i + a2*j (+ ...)`` decouples into the grid mean
plus one independent slope per axis,

    a_m = <d, c_m> / <c_m, c_m>,   c_m = i_m - mean(i_m),

which is exactly the solution xrft's per-block solver computes
(``xrft/detrend.py:64-95``), for any number of dims.

Sharded data are detrended on each rank's block: the moments (the sum and
one centered first moment per axis) are stacked into one local tensor and
summed across the ranks of the sharded axes in one all_reduce per mesh axis
(:func:`~xrft_tpu_torch.ops.shards.all_sum`), and the result keeps the
input's sharding.
"""

from __future__ import annotations

import numpy as np
import torch

from .dtypes import promote
from .labeled import LabeledArray
from .ops import shards

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
    # integer, bool and float16 data in the dtype xrft_tpu computes them in
    # (``dtypes``): JAX's mean for "constant", numpy's result_type(dtype,
    # float32) for "linear"
    if detrend_type == "constant":
        x = da.copy(data=promote(da.data))
        return x - x.mean(dim=dim)
    axes = tuple(da.get_axis_num(d) for d in dim)
    x = promote(da.data, "numpy")
    return da.copy(data=shards.like(x, shards.local(x) - _linear_fit(x, axes)))


def _linear_fit(x: torch.Tensor, axes: tuple[int, ...]) -> torch.Tensor:
    """The least-squares linear trend of x over `axes` (broadcast over the
    remaining axes), in x's dtype, which must be inexact; for a sharded
    ``x``, the trend of its local block.  The mean is in that dtype too:
    ``xrft_tpu`` rounds it to JAX's mean dtype of the input (float32 for
    int32 data, float16 for float16), which the port does not repeat."""
    xl = shards.local(x)
    n_el = 1.0
    for a in axes:
        n_el *= x.shape[a]
    # centered index coordinates arange(n) - (n-1)/2 (this rank's stretch of
    # each), built in float64 on the host; their sums of squares stay
    # float64 scalars
    coords, moments = [], [torch.sum(xl, dim=axes, keepdim=True)]
    for a in axes:
        n = x.shape[a]
        if n == 1:
            continue
        lo, hi = shards.local_range(x, a)
        shape = [1] * x.ndim
        shape[a] = hi - lo
        c64 = np.arange(n) - (n - 1) / 2.0
        c = torch.as_tensor(c64[lo:hi].reshape(shape), dtype=xl.dtype,
                            device=xl.device)
        coords.append((c, float(np.sum(c64 ** 2)) * (n_el / n)))
        moments.append(torch.sum(xl * c, dim=axes, keepdim=True))
    sums = shards.all_sum(x, torch.stack(moments), axes)
    fit = sums[0] / n_el
    for (c, css), s in zip(coords, sums[1:]):
        fit = fit + (s / css) * c
    return fit
