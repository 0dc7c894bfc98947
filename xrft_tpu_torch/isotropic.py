"""Isotropic (azimuthally averaged) spectra and log-log slope fitting.

Counterpart of ``xrft_tpu/isotropic.py`` (xrft's ``xrft/xrft.py:948-1214``).
The radial bin of each wavenumber is a pure function of the static
frequency grid, so the codes, the radial coordinate and the sorted plan are
built once on the host (:mod:`.ops.binning`) and kept in a small cache keyed
by the coordinate values and the bin count; the per-bin sums run on the
data's device through kernel K3 (``config.binned_sum_impl == "kernel"``) or
its plain version, batched over every other dim.

A sharded spectrum is binned on each rank's block by the same route, K3
included: with the whole plan when its spectral dims are resident (the
pencil chain parks the sharding on a batch dim), else with the plan of the
rank's stretch of the grid (built once per stretch and kept with the
plan), the partial sums then added across its ranks in one all_reduce per
mesh axis.
"""

from __future__ import annotations

import warnings
from functools import lru_cache

import numpy as np

from .config import BINNED_SUM_IMPLS, config
from .labeled import Coord, LabeledArray
from .ops import shards
from .ops.binning import (BinPlan, binned_mean_np, binned_sum,
                          binned_sum_plain, cut_codes)
from .spectra import cross_spectrum, power_spectrum

__all__ = [
    "isotropize",
    "isotropic_power_spectrum",
    "isotropic_cross_spectrum",
    "fit_loglog",
]


@lru_cache(maxsize=4)
def _radial_plan(axes: tuple, perm: tuple, nfactor) -> tuple:
    """(BinPlan over the grid in the array's dim order, the per-bin mean
    radius) for the frequency axes ``axes`` (``(dtype str, bytes)`` of each
    coordinate, in the array's dim order).  ``perm[i]`` is the array-order
    position of the i-th axis of reversed(fftdim).

    The radius, the codes and the per-bin mean are computed over the
    reversed(fftdim) grid exactly as ``xrft_tpu/isotropic.py:52-60`` does,
    so the radial coordinate is bit-identical; the codes are then transposed
    to the array's order, so the data flatten without a copy."""
    coords = [np.frombuffer(b, dtype=dt) for dt, b in axes]
    rev_coords = [coords[p] for p in perm]
    nbins = int(min(c.size for c in coords) / nfactor)
    grids = np.meshgrid(*rev_coords, indexing="ij", sparse=True)
    freq_r = np.sqrt(sum(g**2 for g in grids))
    codes, nbins_eff = cut_codes(freq_r, nbins)
    kr = binned_mean_np(freq_r, codes, nbins_eff)
    # rev-order axis i sits at array position perm[i]: transpose back
    to_array = np.argsort(perm)
    codes = codes.reshape(freq_r.shape).transpose(to_array)
    return BinPlan(np.ascontiguousarray(codes).ravel(), nbins_eff), kr


def _binned(data, plan):
    impl = config.binned_sum_impl
    if impl not in BINNED_SUM_IMPLS:
        raise ValueError(f"unknown binned_sum_impl {impl!r}; expected one of "
                         f"{BINNED_SUM_IMPLS}")
    return (binned_sum if impl == "kernel" else binned_sum_plain)(data, plan)


def _binned_blocks(x, n_other: int, plan: BinPlan):
    """Per-bin sums of ``x`` (other dims first, then the spectral dims in
    the plan's order), sharded like ``x``'s other dims.  :func:`_binned`
    (K3 on a CUDA block) runs on the local block with the plan of this
    rank's stretch of the grid (the whole plan when the spectral dims are
    resident, or sharded over mesh axes of one rank); the partial sums are
    then added across the ranks that hold the other stretches (nothing to
    add for unsharded data)."""
    spectral = range(n_other, x.ndim)
    sub = plan.restrict(x.shape[n_other:],
                        [shards.local_range(x, a) for a in spectral])
    xl = shards.local(x)
    block = _binned(
        xl.reshape(tuple(xl.shape[:n_other]) + (sub.size,)).contiguous(), sub)
    shards.all_sum(x, block, spectral)
    if not shards.is_sharded(x):
        return block
    return shards.wrap(x.device_mesh, block,
                       {a: m for a, m in shards.axis_map(x).items()
                        if a < n_other},
                       tuple(x.shape[:n_other]) + (plan.nbins,))


def isotropize(ps: LabeledArray, fftdim, nfactor=4, truncate=True,
               complx=False) -> LabeledArray:
    """Isotropize an N-D (cross) spectrum by an azimuthal (2-D) or
    spherical-shell (3-D+) sum over radial wavenumber bins, as
    ``xrft_tpu.isotropize``.

    The radial coordinate of each bin is the per-bin *mean* of
    ``freq_r = sqrt(k^2 + l^2 + ...)``; the value is the per-bin *sum*.
    With ``truncate=True`` the radial coordinate is NaN for bins beyond the
    smallest axis Nyquist and no data are dropped; otherwise a
    super-Nyquist FutureWarning is emitted.  ``complx`` keeps complex
    values (cross spectra); otherwise the real part is returned.

    The data are flattened in the array's own dim order rather than
    reversed(fftdim): each bin sums the same terms in another order
    (ROADMAP.md, Queue 3).
    """
    fftdim = list(fftdim)
    rev = list(reversed(fftdim))
    own = [d for d in ps.dims if d in fftdim]
    axes = tuple((c.dtype.str, c.tobytes()) for c in
                 (np.ascontiguousarray(ps.coords[d].values) for d in own))
    plan, kr = _radial_plan(axes, tuple(own.index(d) for d in rev), nfactor)

    if truncate:
        kmax = min(np.asarray(ps.coords[d].values).max() for d in rev)
        kr = np.where(kr <= kmax, kr, np.nan)
    else:
        kr = kr.copy()  # the cached plan's array stays private
        warnings.warn(
            "Isotropic wavenumber larger than the Nyquist wavenumber may "
            "result.",
            FutureWarning,
        )

    other = [d for d in ps.dims if d not in fftdim]
    ordered = ps.transpose(*(other + own))
    iso = _binned_blocks(ordered.data, len(other), plan)
    if not complx and iso.is_complex():
        iso = shards.like(iso, shards.local(iso).real.contiguous())

    out_coords = {
        c: ps.coords[c].copy()
        for c in ps.coords
        if not any(d in fftdim for d in ps.coords[c].dims)
        and c not in fftdim
    }
    out_coords["freq_r"] = Coord(("freq_r",), kr, None, "freq_r")
    return LabeledArray(iso, dims=other + ["freq_r"], coords=out_coords,
                        name=ps.name)


def isotropic_power_spectrum(
    da: LabeledArray,
    spacing_tol=1e-3,
    dim=None,
    shift=True,
    detrend=None,
    scaling="density",
    window=None,
    window_correction=False,
    nfactor=4,
    truncate=False,
    **kwargs,
) -> LabeledArray:
    """Azimuthally averaged power spectrum of 2-D data, spherical shells
    for 3-D+ (``xrft_tpu.isotropic_power_spectrum``)."""
    if "density" in kwargs:
        density = kwargs.pop("density")
        scaling = "density" if density else "false_density"

    if dim is None:
        dim = list(da.dims)
    if len(dim) < 2:
        raise ValueError("The Fourier transform should be two dimensional")

    ps = power_spectrum(
        da,
        spacing_tol=spacing_tol,
        dim=dim,
        shift=shift,
        detrend=detrend,
        scaling=scaling,
        window_correction=window_correction,
        window=window,
        **kwargs,
    )

    fftdim = ["freq_" + d for d in dim]
    return isotropize(ps, fftdim, nfactor=nfactor, truncate=truncate)


def isotropic_cross_spectrum(
    da1: LabeledArray,
    da2: LabeledArray,
    spacing_tol=1e-3,
    dim=None,
    shift=True,
    detrend=None,
    scaling="density",
    window=None,
    window_correction=False,
    nfactor=4,
    truncate=False,
    **kwargs,
) -> LabeledArray:
    """Azimuthally averaged cross spectrum of 2-D data, spherical shells
    for 3-D+ (``xrft_tpu.isotropic_cross_spectrum``); complex values."""
    if "density" in kwargs:
        density = kwargs.pop("density")
        scaling = "density" if density else "false_density"

    if dim is None:
        dim = list(da1.dims)
        dim2 = list(da2.dims)
        if dim != dim2:
            raise ValueError("The two datasets have different dimensions")
    if len(dim) < 2:
        raise ValueError("The Fourier transform should be two dimensional")

    cs = cross_spectrum(
        da1,
        da2,
        spacing_tol=spacing_tol,
        dim=dim,
        shift=shift,
        detrend=detrend,
        scaling=scaling,
        window_correction=window_correction,
        window=window,
        **kwargs,
    )

    fftdim = ["freq_" + d for d in dim]
    return isotropize(cs, fftdim, nfactor=nfactor, truncate=truncate,
                      complx=True)


def fit_loglog(x, y):
    """Fit a line to data in log-log space; returns (y_fit, slope,
    intercept) (``xrft_tpu.fit_loglog``)."""
    p = np.polyfit(np.log2(x), np.log2(y), 1)
    y_fit = 2 ** (np.log2(x) * p[0] + p[1])
    return y_fit, p[0], p[1]
