"""Generalized Lomb-Scargle periodogram for unevenly sampled data.

Counterpart of ``xrft_tpu/lombscargle.py``, with
``scipy.signal.lombscargle``'s generalized (Zechmeister & Kürster 2009)
formulation: a per-frequency weighted least-squares fit
``y(w) = a*cos(w*t) + b*sin(w*t) [+ c]`` with optional sample weights and a
floating mean, and scipy's three ``normalize`` modes (``False``/``'power'``,
``True``/``'normalize'``, ``'amplitude'``).

What depends only on the sample times, the weights and the frequencies —
the trig matrices, the tau rotation that diagonalizes the normal equations,
the CC/SS/C/S moments and scipy's division guard — is computed in float64
on the data's device (the host for CPU data), frequency block by frequency
block so that no float64 ``[N, F]`` temporary outgrows a block; the
rotated basis lands in one ``[N, 2F]`` matrix of the data's dtype.  The
projections of the data are then one ``[..., N] x [N, 2F]`` product at full
float32 grade (``config.full_fp32``), batched over every other dim, and
O(F) elementwise combines.

The sample times are the dim's coordinate, which may be arbitrarily
non-uniform; datetime64/cftime coordinates become float seconds since
their first sample.
"""

from __future__ import annotations

import numpy as np
import torch

from . import coords as ce
from .config import full_fp32
from .dtypes import float_dtype
from .labeled import Coord, LabeledArray
from .spectra import _norm_1d_dim
from .utils import along

__all__ = ["lombscargle"]

# float64 elements of one frequency block's [N, block] temporaries
_BLOCK_ELEMENTS = 1 << 27


def _times_seconds(coord: Coord) -> np.ndarray:
    """Sample times as host float64 — numeric coords as-is; datetime64 /
    cftime coords as seconds since their first sample (phase in the
    ``'amplitude'`` mode is referenced to that origin)."""
    values = np.asarray(coord.values)
    if ce._is_cftime(values):
        import cftime  # optional dependency, gated like the reference

        calendar = values.flat[0].calendar
        dec = np.asarray(
            cftime.date2num(values, ce._CFTIME_UNITS, calendar),
            dtype=np.float64)
        return dec - dec.flat[0]
    if np.issubdtype(values.dtype, np.datetime64):
        ns = values.astype("datetime64[ns]")
        return (ns - ns.flat[0]).astype("timedelta64[ns]").astype("f8") / 1e9
    if not np.issubdtype(values.dtype, np.number):
        raise ValueError(
            "lombscargle: coordinate "
            f"{coord.name or coord.dims[0]!r} must be numeric or "
            "datetime-like to provide sample times")
    return np.asarray(values, dtype=np.float64)


def _basis(t, freqs, w, floating_mean, rdt):
    """The rotated basis [cos(w_f (t - tau_f)) | sin(...)] as one [N, 2F]
    matrix of ``rdt``, and the float64 moments (CC, SS, C, S, cos tau,
    sin tau) of scipy.signal.lombscargle's vectorized implementation, the
    guard included.
    ``t``, ``freqs`` and ``w`` (normalized weights) are float64 tensors on
    one device."""
    n, nf = t.numel(), freqs.numel()
    M = torch.empty((n, 2 * nf), dtype=rdt, device=t.device)
    moments = torch.empty((6, nf), dtype=torch.float64, device=t.device)
    step = max(1, _BLOCK_ELEMENTS // n)
    for lo in range(0, nf, step):
        hi = min(nf, lo + step)
        wt = t[:, None] * freqs[None, lo:hi]         # [N, block] phases
        c, s = torch.cos(wt), torch.sin(wt)
        CC = w @ (c * c)
        SS = 1.0 - CC
        CS = w @ (c * s)
        if floating_mean:
            C, S = w @ c, w @ s
            CC, SS, CS = CC - C * C, SS - S * S, CS - C * S
        tau = 0.5 * torch.atan2(2.0 * CS, CC - SS)
        wt -= tau
        c, s = torch.cos(wt), torch.sin(wt)
        del wt
        CC = w @ (c * c)
        SS = 1.0 - CC
        if floating_mean:
            C, S = w @ c, w @ s
            CC, SS = CC - C * C, SS - S * S
        else:
            C = S = torch.zeros_like(CC)
        # scipy's division-by-zero guard, in float64 as scipy applies it
        epsneg = float(np.finfo(np.float64).epsneg)
        moments[:, lo:hi] = torch.stack([
            CC.clamp_min(epsneg), SS.clamp_min(epsneg), C, S,
            torch.cos(tau), torch.sin(tau)])
        M[:, lo:hi] = c
        M[:, nf + lo:nf + hi] = s
    return M, moments


def lombscargle(da, freqs, dim=None, normalize=False, weights=None,
                floating_mean=False):
    """Generalized Lomb-Scargle periodogram along ``dim`` (default: last
    dim) at angular frequencies ``freqs`` — ``scipy.signal.lombscargle``:
    the weighted least-squares power of the best-fit sinusoid at each
    frequency, for unevenly sampled data.

    The dim's coordinate gives the sample times (evenly spaced or not;
    datetime64/cftime coords become seconds since their first sample).
    ``normalize`` is scipy's: ``False`` / ``'power'`` (default) scales a
    unit-amplitude harmonic to ``N/4``; ``True`` / ``'normalize'`` is the
    [0, 1] power fraction of the weighted residuals around zero;
    ``'amplitude'`` returns the complex best-fit amplitude and phase.
    ``weights`` are per-sample nonnegative weights (host array, length N);
    ``floating_mean`` fits a per-frequency offset.  Real input only;
    batched over all other dims in one product.

    The output replaces ``dim`` by ``freq_<dim>`` carrying ``freqs``
    (angular frequency, rad per coordinate unit; no ``spacing`` attr)."""
    dim = _norm_1d_dim(da, dim, "lombscargle")
    ax = da.dims.index(dim)
    n = da.sizes[dim]
    if da.data.is_complex():
        raise ValueError("lombscargle: input must be real "
                         "(scipy.signal.lombscargle semantics)")
    if dim not in da.coords:
        raise ValueError(
            f"lombscargle: dim {dim!r} has no coordinate to provide the "
            "sample times")
    t = _times_seconds(da.coords[dim])
    if t.shape != (n,):
        raise ValueError(
            f"lombscargle: coordinate on {dim!r} must be 1-D of length "
            f"{n}, got shape {t.shape}")

    freqs = np.asarray(freqs, dtype=np.float64)
    if not (freqs.ndim == 1 and freqs.size > 0):
        raise ValueError(
            "Parameter freqs must be a 1-D array of non-zero length!")
    if weights is None:
        w = np.ones(n, dtype=np.float64)
    else:
        w = np.asarray(getattr(weights, "values", weights),
                       dtype=np.float64)
        if w.shape != (n,):
            raise ValueError(
                "Parameters x, y, weights must be 1-D arrays of equal "
                "non-zero length!")
    if not (np.all(w >= 0) and np.sum(w) > 0):
        raise ValueError(
            "Parameter weights must have only non-negative entries "
            "which sum to a positive value!")
    if isinstance(normalize, bool):
        normalize = "normalize" if normalize else "power"
    if normalize not in ("power", "normalize", "amplitude"):
        raise ValueError(
            "Normalize must be: False (or 'power'), True (or "
            "'normalize'), or 'amplitude'.")

    dev = da.data.device
    rdt = float_dtype(da.data.dtype, "float64")
    w = w / w.sum()
    f64 = dict(dtype=torch.float64, device=dev)
    M, moments = _basis(torch.as_tensor(t, **f64),
                        torch.as_tensor(freqs, **f64),
                        torch.as_tensor(w, **f64), floating_mean, rdt)
    CC, SS, C, S, cos_tau, sin_tau = moments.to(rdt)
    nf = freqs.shape[0]

    # the device product: one [..., N] x [N, 2F] contraction
    y = da.data.to(rdt)
    wy = y * along(w, y, ax)
    with full_fp32():
        proj = torch.tensordot(wy, M, dims=([ax], [0]))
    YC, YS = proj[..., :nf], proj[..., nf:]
    if floating_mean:
        Y = wy.sum(dim=ax)[..., None]        # [..., 1]
        YC = YC - Y * C
        YS = YS - Y * S
    a = YC / CC
    b = YS / SS

    if normalize == "amplitude":
        # (a + ib) * exp(i*tau)
        out = torch.complex(a * cos_tau - b * sin_tau,
                            a * sin_tau + b * cos_tau)
    else:
        out = 2.0 * (a * YC + b * YS)
        if normalize == "power":
            out = out * (n / 4.0)
        else:  # 'normalize': the power fraction of the weighted residuals
            YY = (wy * y).sum(dim=ax)[..., None]
            if floating_mean:
                YY = YY - wy.sum(dim=ax)[..., None] ** 2
            out = out * (0.5 / YY)

    out = out.movedim(-1, ax)
    fdim = ce.freq_dim_name(dim)
    out_dims = [fdim if d == dim else d for d in da.dims]
    coords = {k: c.copy() for k, c in da.coords.items()
              if dim not in c.dims}
    coords[fdim] = Coord((fdim,), freqs, {}, fdim)
    return LabeledArray(out, dims=out_dims, coords=coords,
                        attrs=dict(da.attrs), name=da.name)
