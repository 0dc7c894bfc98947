"""Plain reference of xrft's ``ifft`` of a one-sided 2-D spectrum over a
stack's two trailing dims (``real_dim`` the last), with ``true_phase=False``
and no lag: the frequency dims are sorted ascending, the other axis is
ifftshifted back to natural order, the inverse real 2-D DFT gives
``2 (m - 1)`` columns, and the output is ifftshifted on both axes
(``shift=False``; ``shift=True`` would undo that) and, with
``true_amplitude``, divided by the product of the output spacings.  The dims
lose their ``freq_`` prefix and take the grids ``fftfreq(n, df)``.  Plain
torch and numpy; nothing of the program is imported.
"""

from __future__ import annotations

import numpy as np
import torch

from ._precision import dtypes, rounded

PREFIX = "freq_"


def _check(dims, kwargs):
    space = list(kwargs["dim"])
    if list(dims[-2:]) != space or kwargs.get("real_dim") != space[-1]:
        raise ValueError(f"the reference takes the two trailing dims with "
                         f"the last one real, got dim={space} of {dims}")
    if kwargs.get("true_phase", True) or kwargs.get("lag") is not None:
        raise ValueError("the reference covers true_phase=False, lag=None")


def spacing(values: np.ndarray) -> float:
    """|x[1] - x[0]| of the ascending grid: the spacing as xrft reads it."""
    v = np.sort(np.asarray(values))
    return float(abs(v[1] - v[0]))


def _name(d: str) -> str:
    return d[len(PREFIX):] if d.startswith(PREFIX) else PREFIX + d


def out_dtype(in_dtype: torch.dtype, kwargs) -> torch.dtype:
    return torch.float64 if in_dtype == torch.complex128 else torch.float32


def _sizes(dims, coords, kwargs):
    fy, fx = (np.asarray(coords[d]) for d in kwargs["dim"])
    return fy.size, 2 * (fx.size - 1)


def labels(dims, coords, kwargs):
    _check(dims, kwargs)
    space = list(kwargs["dim"])
    n = _sizes(dims, coords, kwargs)
    shift = kwargs.get("shift", True)
    out = {c: np.asarray(v) for c, v in coords.items() if c not in space}
    for d, nd in zip(space, n):
        grid = np.fft.fftfreq(nd, spacing(coords[d]))
        out[_name(d)] = np.fft.fftshift(grid) if shift else grid
    return tuple(_name(d) if d in space else d for d in dims), out


def values(x: torch.Tensor, coords, dims, kwargs,
           precision: str = "float64") -> torch.Tensor:
    """The inverse of the half spectra ``x`` (fields, fy, fx), in the
    ``precision``'s real dtype."""
    _check(dims, kwargs)
    real, cplx = dtypes(precision)
    fy = np.asarray(coords[kwargs["dim"][0]])
    order = np.argsort(fy, kind="stable")
    x = x.index_select(-2, torch.as_tensor(order, device=x.device))
    ny, nx = _sizes(dims, coords, kwargs)
    x = rounded(x.to(cplx), precision)
    x = torch.fft.ifftshift(x, dim=-2)
    out = rounded(torch.fft.irfft2(x, s=(ny, nx)), precision)
    if not kwargs.get("shift", True):
        out = torch.fft.ifftshift(out, dim=(-2, -1))
    if kwargs.get("true_amplitude", True):
        dfy, dfx = (spacing(coords[d]) for d in kwargs["dim"])
        # the output spacings are 1 / (n df)
        out = rounded(out * (ny * dfy * nx * dfx), precision)
    return out.to(real)
