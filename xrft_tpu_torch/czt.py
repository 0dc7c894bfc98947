"""Chirp-Z transform and zoom FFT (scipy.signal namesakes).

Counterpart of ``xrft_tpu/czt.py``, with ``scipy.signal.czt`` /
``scipy.signal.zoom_fft``'s semantics: ``X[k] = sum_n x[n] a^{-n} w^{nk}``
for ``k = 0..m-1``, the ``m`` samples of the z-transform on the spiral
``z_k = a * w^{-k}``; ``zoom_fft`` restricts it to a band ``[f1, f2]`` of the
unit circle.

Bluestein's identity ``nk = (n^2 + k^2 - (k-n)^2) / 2`` makes it one
circular convolution,

    X = c3 * ifft(fft(x * c1, L) * V)[:m],

whose chirps ``c1``, ``c3`` and kernel spectrum ``V`` are host complex128
constants, balanced in dynamic range and rounded to the data's complex
dtype on its device; ``L`` is the next power of two >= ``n + m - 1``.  The
one FFT pair goes through :mod:`.ops.fft_core` (cuFFT, K2/K4 or the matmul
engine, by ``config.fft_impl``).

``zoom_fft`` is coordinate-aware beyond scipy: ``fs`` defaults to
``1/spacing`` of the dim's coordinate (scipy's ``fs=2`` applies only to a
dim without one), and the output carries the frequency coordinate
``freq_<dim>`` with a ``spacing`` attr.
"""

from __future__ import annotations

import warnings

import numpy as np
import torch
import torch.nn.functional as F

from . import coords as ce
from .config import engine_impl
from .dtypes import float_dtype
from .labeled import Coord, LabeledArray
from .ops import fft_core
from .spectra import _norm_1d_dim
from .utils import along

__all__ = ["czt", "zoom_fft"]

_COMPLEX = {torch.float32: torch.complex64, torch.float64: torch.complex128}


def _cconst(vals_c128: np.ndarray, like: torch.Tensor, ax: int,
            rdt: torch.dtype) -> torch.Tensor:
    """A host complex constant along ``ax`` of ``like``, on its device in
    the complex dtype of the real dtype ``rdt``."""
    return along(vals_c128, like, ax, _COMPLEX[rdt])


def _real_dtype(x: torch.Tensor) -> torch.dtype:
    """The real dtype a transform of ``x`` computes in: float64 for double
    and integer data, float32 for single precision and less (float16 and
    complex32 included)."""
    return float_dtype(x.dtype, "float64").to_real()


def _czt_data(x, ax, n, m, w: complex, a: complex):
    """Bluestein CZT of the tensor ``x`` along ``ax`` (host chirps; one
    fft/ifft pair at the next power of two)."""
    rdt = _real_dtype(x)
    x = x.to(_COMPLEX[rdt] if x.is_complex() else rdt)
    k2 = np.arange(max(n, m), dtype=np.float64) ** 2 / 2.0
    logw_mag = np.log(np.abs(w))
    argw = np.angle(w)
    loga_mag = np.log(np.abs(a))
    arga = np.angle(a)

    def wpow(e):  # w**e elementwise for float64 exponents
        return np.exp(e * logw_mag) * np.exp(1j * e * argw)

    nn = np.arange(n, dtype=np.float64)
    c1 = np.exp(-nn * loga_mag) * np.exp(-1j * nn * arga) * wpow(k2[:n])
    c3 = wpow(k2[:m])
    L = 1 << int(np.ceil(np.log2(max(n + m - 1, 1))))
    v = np.zeros(L, dtype=np.complex128)
    v[:m] = wpow(-k2[:m])
    v[L - n + 1:] = wpow(-k2[1:n][::-1])
    V = np.fft.fft(v)

    # Balance the dynamic range across the three constant factors: the
    # convolution theorem is invariant under c1 <- c1/s1, V <- V/sV,
    # c3 <- c3*(s1*sV).  Off-circle spirals make |V| (and |c1| for |a| > 1)
    # huge while the matching ifft outputs are tiny; with max|c1| = max|V|
    # = 1 the intermediates are bounded by the signal's own FFT, and a
    # float32 product fft(x*c1) * V cannot overflow.
    s1 = float(np.abs(c1).max())
    sV = float(np.abs(V).max())
    comp = s1 * sV
    if (logw_mag != 0.0 or loga_mag != 0.0) and np.isfinite(comp) and comp:
        c1 = c1 / s1
        V = V / sV
        c3 = c3 * comp

    # Off-circle spirals need a relative dynamic range exp(E) with
    # E = max(n,m)^2/2 * |log|w|| + n * |log|a||: the answer lives in
    # convolution outputs exp(-E) below the intermediate FFT's rounding
    # floor once exp(E) exceeds 1/eps of the compute dtype.
    eps = torch.finfo(rdt).eps
    exp_range = (max(n, m) ** 2 / 2.0) * abs(logw_mag) + n * abs(loga_mag)
    if exp_range > -np.log(eps):
        warnings.warn(
            f"czt: the chirp dynamic range exp({exp_range:.1f}) exceeds "
            f"{str(rdt).removeprefix('torch.')}'s relative precision "
            f"(1/eps = exp({-np.log(eps):.1f})); results "
            "will lose most or all accuracy. Keep |w| and |a| closer to "
            "1 at this length, or compute in float64 on a f64 backend.")
    u = x * _cconst(c1, x, ax, rdt)
    u = F.pad(u, [0, 0] * (u.ndim - 1 - ax) + [0, L - n])
    U = fft_core.fftn(u, [ax]) * _cconst(V, u, ax, rdt)
    y = fft_core.ifftn(U, [ax]).narrow(ax, 0, m)
    return y * _cconst(c3, y, ax, rdt)


def czt(da, dim=None, m=None, w=None, a=1 + 0j, engine=None):
    """Chirp-Z transform along ``dim`` (default: last dim) —
    ``scipy.signal.czt``: ``m`` samples of the z-transform on the spiral
    ``z_k = a * w^{-k}``; ``w`` defaults to ``exp(-2j*pi/m)`` (the DFT
    circle, so ``czt(x)`` == ``fft(x)`` values).  Real or complex input;
    complex output.  The transformed dim keeps its name with an integer
    sample index as its coordinate; other dims/coords pass through."""
    dim = _norm_1d_dim(da, dim, "czt")
    ax = da.dims.index(dim)
    n = da.sizes[dim]
    m = int(m) if m is not None else n
    if m < 1:
        raise ValueError("czt: m must be a positive integer")
    w = complex(w) if w is not None else np.exp(-2j * np.pi / m)
    if w == 0:
        raise ValueError("czt: w must be nonzero")
    with engine_impl(engine):
        y = _czt_data(da.data, ax, n, m, w, complex(a))
    coords = {k: c.copy() for k, c in da.coords.items()
              if dim not in c.dims}
    coords[dim] = Coord((dim,), np.arange(m), name=dim)
    return LabeledArray(y, dims=list(da.dims), coords=coords,
                        attrs=dict(da.attrs), name=da.name)


def zoom_fft(da, fn, m=None, dim=None, fs=None, endpoint=False,
             engine=None):
    """Band-limited DFT along ``dim`` — ``scipy.signal.zoom_fft``: the
    spectrum on ``m`` frequencies spanning ``fn = f1`` (band ``[0, f1]``)
    or ``fn = [f1, f2]``, without the full transform — the CZT with ``a``
    and ``w`` on the unit circle.  ``fs`` defaults to ``1/spacing`` of the
    dim's coordinate when it has one (else scipy's ``fs=2``), and the
    output dim is renamed ``freq_<dim>`` carrying the frequency grid with a
    ``spacing`` attr."""
    dim = _norm_1d_dim(da, dim, "zoom_fft")
    ax = da.dims.index(dim)
    n = da.sizes[dim]
    fn = np.atleast_1d(np.asarray(fn, dtype=np.float64))
    if fn.size == 1:
        f1, f2 = 0.0, float(fn[0])
    elif fn.size == 2:
        f1, f2 = float(fn[0]), float(fn[1])
    else:
        raise ValueError("zoom_fft: fn must be a scalar or a length-2 "
                         "sequence [f1, f2]")
    if fs is None:
        if dim in da.coords:
            fs = 1.0 / ce.get_coordinate_spacing(da.coords[dim], 1e-3)
        else:
            fs = 2.0  # scipy's normalized-frequency default
    fs = float(fs)
    m = int(m) if m is not None else n
    if m < 1:
        raise ValueError("zoom_fft: m must be a positive integer")
    step = (f2 - f1) / (m - 1 if endpoint and m > 1 else m)
    w = np.exp(-2j * np.pi * step / fs)
    a = np.exp(2j * np.pi * f1 / fs)
    with engine_impl(engine):
        y = _czt_data(da.data, ax, n, m, complex(w), complex(a))
    fdim = ce.freq_dim_name(dim)
    out_dims = [fdim if d == dim else d for d in da.dims]
    coords = {k: c.copy() for k, c in da.coords.items()
              if dim not in c.dims}
    coords[fdim] = Coord((fdim,), f1 + np.arange(m) * step,
                         {"spacing": step}, fdim)
    return LabeledArray(y, dims=out_dims, coords=coords,
                        attrs=dict(da.attrs), name=da.name)
