"""Plain reference of xrft's ``power_spectrum`` of a (fields, y, x) stack
over its two trailing dims: least-squares plane removed, periodic Hann
window, full complex 2-D DFT, |F|^2 with the density scaling and
``true_amplitude``, both axes fftshifted (two-sided; the frequency dims
``freq_<dim>``).  Every number is worked out again from the data and the
coordinates handed to the program: spacings from the coordinates' first
differences, as xrft takes them, the window from its closed form, the plane
by solving its normal equations.  Plain torch and numpy; nothing of the
program is imported.
"""

from __future__ import annotations

import numpy as np
import torch

from ._precision import dtypes, rounded


def _check(dims, kwargs):
    space = list(kwargs["dim"])
    if list(dims[-len(space):]) != space or len(space) != 2:
        raise ValueError(f"the reference takes the two trailing dims, got "
                         f"dim={space} of {dims}")
    if kwargs.get("window") != "hann" or kwargs.get("detrend") != "linear":
        raise ValueError("the reference covers window='hann', "
                         "detrend='linear'")
    unknown = set(kwargs) - {"dim", "window", "detrend", "engine"}
    if unknown:
        raise ValueError(f"the reference does not cover {sorted(unknown)}")


def spacing(values: np.ndarray) -> float:
    """|x[1] - x[0]|: the grid spacing as xrft reads it."""
    return float(abs(values[1] - values[0]))


def out_dtype(in_dtype: torch.dtype, kwargs) -> torch.dtype:
    """float64 on the float64 path (``engine="hp"``), else the input's real
    precision (float32 data give a float32 spectrum)."""
    if kwargs.get("engine") == "hp" or in_dtype == torch.float64:
        return torch.float64
    return torch.float32


def labels(dims, coords, kwargs):
    """(dims, coords) of the output: the transform dims renamed
    ``freq_<dim>`` with fftshifted frequency grids, other coords kept."""
    _check(dims, kwargs)
    space = list(kwargs["dim"])
    out_dims = tuple(f"freq_{d}" if d in space else d for d in dims)
    out = {c: np.asarray(v) for c, v in coords.items() if c not in space}
    for d in space:
        v = np.asarray(coords[d])
        out[f"freq_{d}"] = np.fft.fftshift(np.fft.fftfreq(v.size,
                                                           spacing(v)))
    return out_dims, out


def hann(n: int) -> np.ndarray:
    """The periodic Hann window, 0.5 - 0.5 cos(2 pi k / n)."""
    return 0.5 - 0.5 * np.cos(2.0 * np.pi * np.arange(n) / n)


def _plane_removed(x: torch.Tensor, real: torch.dtype,
                   precision: str) -> torch.Tensor:
    """x less its least-squares plane a + b*i + c*j per field, from the
    3x3 normal equations in centered index coordinates."""
    ny, nx = x.shape[-2:]
    ci = torch.arange(ny, dtype=real, device=x.device) - (ny - 1) / 2.0
    cj = torch.arange(nx, dtype=real, device=x.device) - (nx - 1) / 2.0
    basis = [torch.ones(ny, nx, dtype=real, device=x.device),
             ci[:, None].expand(ny, nx), cj[None, :].expand(ny, nx)]
    gram = torch.stack([torch.stack([(a * b).sum() for b in basis])
                        for a in basis])
    rhs = torch.stack([(x * b).sum(dim=(-2, -1)) for b in basis], dim=-1)
    coef = torch.linalg.solve(gram, rhs.unsqueeze(-1)).squeeze(-1)
    plane = (coef[:, 0, None, None] + coef[:, 1, None, None] * ci[:, None]
             + coef[:, 2, None, None] * cj[None, :])
    return rounded(x - plane, precision)


def values(x: torch.Tensor, coords, dims, kwargs,
           precision: str = "float64") -> torch.Tensor:
    """The power spectrum of the fields ``x`` (fields, y, x), in the
    ``precision``'s real dtype."""
    _check(dims, kwargs)
    real, _ = dtypes(precision)
    space = list(kwargs["dim"])
    dy, dx = (spacing(np.asarray(coords[d])) for d in space)
    ny, nx = x.shape[-2:]
    x = rounded(x.to(real), precision)
    x = _plane_removed(x, real, precision)
    wy, wx = (torch.as_tensor(hann(n), device=x.device) for n in (ny, nx))
    w = rounded((wy[:, None] * wx[None, :]).to(real), precision)
    x = rounded(x * w, precision)
    f = rounded(torch.fft.fft2(x), precision)
    p = rounded(f.real ** 2 + f.imag ** 2, precision)
    # true_amplitude's (dy dx)^2 and the density's 1 / (ny dy nx dx)
    scale = (dy * dx) ** 2 / (ny * dy * nx * dx)
    p = rounded(p * scale, precision)
    return torch.fft.fftshift(p, dim=(-2, -1))

