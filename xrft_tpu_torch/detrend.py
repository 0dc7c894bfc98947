"""Detrending with the closed-form hyperplane fit, in torch.

Counterpart of ``xrft_tpu/detrend.py``.  On a full regular grid the centered
per-axis index coordinates are mutually orthogonal regressors, so the
least-squares fit ``a0 + a1*i + a2*j (+ ...)`` decouples into the grid mean
plus one independent slope per axis,

    a_m = <d, c_m> / <c_m, c_m>,   c_m = i_m - mean(i_m),

which is exactly the solution xrft's per-block solver computes
(``xrft/detrend.py:64-95``), for any number of dims.

Both detrends sum their moments and keep the trend in float64 until it
is subtracted (:func:`_detrended`), so a float32 field far from zero mean
(290 K, 101325 Pa, 12-bit counts) comes out at float32 grade against the
same call in float64.  ``xrft_tpu`` rounds its fit to float32 at the data's
magnitude and errs at DC by 1e-5 to 2e-4 of the spectrum's max there; the
port does not repeat that.

Sharded data are detrended on each rank's block: the moments (the sum and
one centered first moment per axis) are stacked into one local tensor and
summed across the ranks of the sharded axes in one all_reduce per mesh axis
(:func:`~xrft_tpu_torch.ops.shards.all_sum`), and the result keeps the
input's sharding.
"""

from __future__ import annotations

import numpy as np
import torch

from . import telemetry
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
    # (``dtypes``): JAX's float for "constant", numpy's result_type(dtype,
    # float32) for "linear"
    linear = detrend_type == "linear"
    x = promote(da.data, "numpy" if linear else "jax")
    axes = tuple(da.get_axis_num(d) for d in dim)
    out = da.copy(data=shards.like(x, _detrended(x, axes, linear)))
    if not linear:
        # xrft_tpu's ``da - da.mean(dim)`` drops the name and the user attrs
        chunks = da.attrs.get("_chunks")
        out.name = None
        out.attrs = {"_chunks": dict(chunks)} if chunks else {}
    return out


def _detrended(x: torch.Tensor, axes: tuple[int, ...],
               linear: bool) -> torch.Tensor:
    """x less its mean over `axes` (or, with ``linear``, its least-squares
    linear trend), broadcast over the remaining axes, in x's dtype, which
    must be inexact; for a sharded ``x``, the local block of that.

    The moments are summed in float64 (complex128) and the trend stays
    there until it is subtracted, so nothing is rounded at the data's
    magnitude: the result is rounded once, at the residual's.  Two float32
    shortcuts fail on data far from zero mean (a field in kelvin or
    pascal, 12-bit counts).  A float32 trend rounds at the data's magnitude
    (3e-5 at 290), and that rounding, constant along rows and columns,
    lands at DC and the lowest wavenumbers.  And float32 sums of a residual
    ``x - p`` of quantized data are biased on the GPU: every value shares
    p's offset from the data's grid, so the accumulator rounds the same way
    at every addition (on an H100, 1.9e-5 of max at DC for 12-bit counts,
    mean 2048).

    The trend is subtracted in parts, one per fitted axis (the first with
    the mean), each in one pass computed in float64, the last stored in
    the data's dtype.  The moments are one marginal sum per fitted
    axis against the centered index coordinate arange(n) - (n-1)/2 (this
    rank's stretch of it, built in float64 on the host), so a sharded
    block's moments add up over the ranks in the one all_reduce per mesh
    axis."""
    xl = shards.local(x)
    x64 = xl.to(torch.complex128 if xl.is_complex() else torch.float64)
    n_el = 1
    for a in axes:
        n_el *= x.shape[a]
    total, coords, moments = None, [], []
    for a in [a for a in axes if x.shape[a] > 1] if linear else ():
        rest = [b for b in axes if b != a]
        m = torch.sum(x64, dim=rest, keepdim=True) if rest else x64
        if total is None:
            total = torch.sum(m, dim=a, keepdim=True)
        n = x.shape[a]
        lo, hi = shards.local_range(x, a)
        shape = [1] * x.ndim
        shape[a] = hi - lo
        c64 = np.arange(n) - (n - 1) / 2.0
        c = telemetry.to_device(c64[lo:hi].reshape(shape), device=xl.device)
        coords.append((c, float(np.sum(c64 ** 2)) * (n_el / n)))
        moments.append(torch.sum(m * c, dim=a, keepdim=True))
    if total is None:
        total = torch.sum(x64, dim=axes, keepdim=True)
    sums = shards.all_sum(x, torch.stack([total] + moments), axes)
    mean = sums[0] / n_el
    parts = [(s / css) * c for (c, css), s in zip(coords, sums[1:])]
    parts = [mean + parts[0]] + parts[1:] if parts else [mean]
    # every part but the last is subtracted into float64 storage: the copy,
    # which the moments no longer need (a new buffer where x is the copy)
    out = xl
    if len(parts) > 1:
        buf = x64 if x64 is not xl else torch.empty_like(x64)
        for part in parts[:-1]:
            out = torch.sub(out, part, out=buf)
    return torch.sub(out, parts[-1], out=torch.empty_like(xl))
