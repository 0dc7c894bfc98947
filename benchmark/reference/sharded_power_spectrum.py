"""Plain reference of xrft's ``power_spectrum`` over any number of transform
dims (``dim``), for an output too large to gather: it works out one plane
of the two-sided spectrum, at one index of one transform dim and of every
other dim, from the whole input, made again slab by slab (``slab(k)``, index
k along the input's ``slab_axis``) and streamed in chunks, so that it fits
on the card beside nothing else.

The same steps as ``power_spectrum.py``: the least-squares hyperplane
removed (the normal equations are diagonal in centered index coordinates
over a whole grid, so the fit is the field's mean and its first moment
along each dim), the periodic Hann window along each dim, the DFT, |F|^2
with the density scaling and ``true_amplitude``, every transform dim
fftshifted.  The plane's dim is taken by a direct sum against its phase
factors as the chunks stream past; the others by an FFT of the result.
Two passes over the input: the moments, then the sum.  Plain torch and
numpy; nothing of the program is imported.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from ._precision import dtypes, rounded

CHUNK_BYTES = 1 << 28      # float64 working set of one streamed chunk


def _check(dims, kwargs):
    space = list(kwargs["dim"])
    if not space or not set(space) <= set(dims):
        raise ValueError(f"dim={space} is not a list of the dims {dims}")
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
    """float64 on the float64 path (``engine="hp"``), else float32."""
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


class _Field:
    """The compared field (one index of every non-transform axis) over the
    transform axes ``axes``, read in chunks along ``stream``: the slab axis
    where it is a transform axis, else the first transform axis of the one
    slab that holds the field."""

    def __init__(self, slab, shape, slab_axis, axes, fixed):
        self.slab, self.slab_axis, self.axes = slab, slab_axis, axes
        self.fixed = fixed
        self.n = [shape[a] for a in axes]
        if slab_axis in axes:
            self.stream = axes.index(slab_axis)
            self.whole = None
        else:
            self.stream = 0
            self.whole = self._select(slab(fixed[slab_axis]))

    def _select(self, t: torch.Tensor) -> torch.Tensor:
        """A slab (the global axes less the slab axis) at the fixed
        indices: the remaining axes are transform axes, in order."""
        for a in sorted(self.fixed, reverse=True):
            if a != self.slab_axis:
                t = t.select(a - (a > self.slab_axis), self.fixed[a])
        return t

    def part(self, lo: int, hi: int) -> torch.Tensor:
        if self.whole is not None:
            return self.whole.narrow(self.stream, lo, hi - lo)
        return torch.stack([self._select(self.slab(k))
                            for k in range(lo, hi)], dim=self.stream)

    def chunks(self):
        per_index = math.prod(self.n) // self.n[self.stream]
        step = max(1, CHUNK_BYTES // (8 * per_index))
        for lo in range(0, self.n[self.stream], step):
            hi = min(lo + step, self.n[self.stream])
            yield lo, hi, self.part(lo, hi)


def _along(v: torch.Tensor, k: int, ndim: int) -> torch.Tensor:
    """``v`` shaped to broadcast along axis k of an ndim-d tensor."""
    shape = [1] * ndim
    shape[k] = -1
    return v.reshape(shape)


def plane(slab, shape, slab_axis: int, dims, coords, kwargs, at: dict,
          precision: str = "float64") -> torch.Tensor:
    """The two-sided power spectrum at the indices ``at`` (every axis but
    the transform axes, and one transform axis), over the other transform
    axes in order, in the ``precision``'s real dtype.  ``slab(k)`` gives
    index k along ``slab_axis`` of the global input, the global shape
    ``shape`` less that axis."""
    _check(dims, kwargs)
    real, cplx = dtypes(precision)
    axes = sorted(dims.index(d) for d in kwargs["dim"])
    (axis,) = [a for a in at if a in axes]
    field = _Field(slab, shape, slab_axis, axes,
                   {a: i for a, i in at.items() if a not in axes})
    nd, s, k = len(axes), field.stream, axes.index(axis)
    device = (field.whole if field.whole is not None
              else field.slab(0)).device
    centred = [torch.arange(n, dtype=real, device=device) - (n - 1) / 2.0
               for n in field.n]

    def view(j, v, lo=None, hi=None):
        return _along(v[lo:hi] if j == s else v, j, nd)

    # pass 1: the moments that fit the hyperplane
    total = math.prod(field.n)
    s0 = torch.zeros((), dtype=real, device=device)
    s1 = [torch.zeros((), dtype=real, device=device) for _ in axes]
    for lo, hi, x in field.chunks():
        x = rounded(x.to(real), precision)
        s0 += x.sum()
        for j in range(nd):
            s1[j] += (x * view(j, centred[j], lo, hi)).sum()
    mean = s0 / total
    slope = [s1[j] / ((total // field.n[j]) * (centred[j] ** 2).sum())
             for j in range(nd)]

    # pass 2: detrend, window, and the sum along the plane's axis
    windows = [torch.as_tensor(hann(n), dtype=real, device=device)
               for n in field.n]
    m = (at[axis] - field.n[k] // 2) % field.n[k]      # unshifted index
    turns = torch.as_tensor((m * np.arange(field.n[k])) % field.n[k]
                            / field.n[k] * 2.0 * np.pi, dtype=real,
                            device=device)
    cos, sin = torch.cos(turns), torch.sin(turns)
    rest = [n for j, n in enumerate(field.n) if j != k]
    g = torch.zeros(rest, dtype=cplx, device=device)
    for lo, hi, x in field.chunks():
        x = rounded(x.to(real), precision)
        trend = mean + sum(view(j, slope[j] * centred[j], lo, hi)
                           for j in range(nd))
        w = math.prod(view(j, windows[j], lo, hi) for j in range(nd))
        p = rounded(rounded(x - trend, precision) * rounded(w, precision),
                    precision)
        re = (p * view(k, cos, lo, hi)).sum(dim=k)
        im = -(p * view(k, sin, lo, hi)).sum(dim=k)
        part = torch.complex(re, im)
        if k == s:
            g += part
        else:
            g.narrow(s - (s > k), lo, hi - lo).copy_(part)
    g = rounded(g, precision)
    f = rounded(torch.fft.fftn(g), precision)
    p = rounded(f.real ** 2 + f.imag ** 2, precision)
    d = [spacing(np.asarray(coords[dims[a]])) for a in axes]
    # true_amplitude's (prod d)^2 and the density's 1 / prod(n d)
    scale = math.prod(d) ** 2 / math.prod(n * dd for n, dd in zip(field.n, d))
    p = rounded(p * scale, precision)
    return torch.fft.fftshift(p).to(real)
