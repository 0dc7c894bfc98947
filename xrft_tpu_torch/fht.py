"""Fast Hankel transform (FFTLog) along a named dim.

Counterpart of ``xrft_tpu/fht.py``, with ``scipy.fft.fht`` / ``ifht`` /
``fhtoffset``'s semantics: the discrete Hankel transform
``A(k) = ∫ a(r) J_mu(kr) k dr`` of a logarithmically spaced periodic
sequence by FFTLog (Talman 1978; Hamilton 2000, MNRAS 312, 257), with the
power-law bias and the low-ringing offset helper.

The FFTLog kernel ``u_m = (k_c r_c)^{-2πim/(n dln)} U_mu(q + 2πim/(n dln))``,
``U_mu(x) = 2^x Γ((mu+1+x)/2)/Γ((mu+1-x)/2)``, is evaluated on the host in
complex128 (``scipy.special.loggamma``), as are the bias factors; the
inverse's division is a host reciprocal.  The device work is one
``rfftn``/``irfftn`` pair (even n) or ``fftn``/``ifftn`` pair (odd n) through
:mod:`.ops.fft_core` around a complex multiply, and a flip.  Under
``fft_impl="matmul"`` the even route's irfft is the pair engine's packed
half-length inverse.

Coordinate-aware beyond scipy: ``dln`` defaults to the dim's log-spacing
(checked uniform in log), and the output carries the conjugate grid
``k_j = exp(offset)/r_{n-1-j}`` on a renamed ``freq_<dim>`` (``fht``) or
de-prefixed (``ifht``) dim.
"""

from __future__ import annotations

import warnings

import numpy as np

from . import coords as ce
from .config import engine_impl
from .czt import _cconst, _real_dtype
from .labeled import Coord, LabeledArray
from .ops import fft_core
from .spectra import _norm_1d_dim
from .utils import along

__all__ = ["fht", "ifht", "fhtoffset"]

_LN2 = np.log(2.0)


def _fht_coeff(n: int, dln: float, mu: float, offset: float, bias: float,
               inverse: bool) -> np.ndarray:
    """FFTLog kernel u_m (Hamilton 2000 eqs. 16-19) on the rfft grid, host
    complex128, with scipy.fft.fhtcoeff's singular cases and warnings."""
    from scipy.special import loggamma, poch

    q = bias
    xp = (mu + 1 + q) / 2
    xm = (mu + 1 - q) / 2
    y = np.linspace(0.0, np.pi * (n // 2) / (n * dln), n // 2 + 1)
    # log u_m = q ln2 + lnΓ(xp+iy) − lnΓ(xm−iy) + 2iy(ln2 − lnkr)
    with np.errstate(invalid="ignore", divide="ignore"):
        lg = (loggamma(xp + 1j * y) - loggamma(xm - 1j * y)
              + q * _LN2 + 2j * y * (_LN2 - offset))
        u = np.exp(lg)
    if n % 2 == 0:
        u.imag[-1] = 0.0  # Nyquist coefficient is real
    if not np.isfinite(u[0]):
        # u_0 = 2^q Γ(xp)/Γ(xm); poch resolves the negative-integer poles
        u[0] = 2.0 ** q * poch(xm, xp - xm)
    if np.isinf(u[0]) and not inverse:
        warnings.warn("singular transform; consider changing the bias",
                      stacklevel=4)
        u[0] = 0.0
    elif u[0] == 0 and inverse:
        warnings.warn(
            "singular inverse transform; consider changing the bias",
            stacklevel=4)
        u[0] = np.inf
    return u


def fhtoffset(dln, mu, initial=0.0, bias=0.0) -> float:
    """Optimal low-ringing offset for :func:`fht` near ``initial`` —
    ``scipy.fft.fhtoffset`` (Hamilton 2000 eq. 20): shifts ``ln(k_c r_c)``
    so the Nyquist-frequency kernel phase is a multiple of π.  Host math."""
    from scipy.special import loggamma

    q = bias
    xp = (mu + 1 + q) / 2
    xm = (mu + 1 - q) / 2
    y = np.pi / (2 * dln)
    arg = ((_LN2 - initial) / dln
           + (loggamma(xp + 1j * y).imag + loggamma(xm + 1j * y).imag)
           / np.pi)
    return initial + (arg - np.round(arg)) * dln


def _log_spacing(coord: Coord, caller: str) -> float:
    values = np.asarray(coord.values, dtype=np.float64)
    if values.ndim != 1 or values.size < 2 or np.any(values <= 0):
        raise ValueError(
            f"{caller}: coordinate {coord.name or coord.dims[0]!r} must "
            "be a positive 1-D grid to derive the logarithmic spacing; "
            "pass dln= explicitly otherwise")
    dlns = np.diff(np.log(values))
    if not np.allclose(dlns, dlns[0], rtol=1e-6):
        raise ValueError(
            f"{caller}: coordinate {coord.name or coord.dims[0]!r} is "
            "not uniformly logarithmically spaced")
    return float(dlns[0])


def _fht_like(da, dln, mu, offset, bias, dim, engine, inverse, caller):
    dim = _norm_1d_dim(da, dim, caller)
    ax = da.dims.index(dim)
    n = da.sizes[dim]
    if da.data.is_complex():
        raise ValueError(f"{caller}: input must be real "
                         "(scipy.fft semantics)")
    if dln is None:
        if dim not in da.coords:
            raise ValueError(
                f"{caller}: dim {dim!r} has no coordinate; pass dln=")
        dln = _log_spacing(da.coords[dim], caller)
    dln = float(dln)
    mu, offset, bias = float(mu), float(offset), float(bias)

    rdt = _real_dtype(da.data)
    x = da.data.to(rdt)
    j_c = (n - 1) / 2.0
    j = np.arange(n, dtype=np.float64)
    if bias != 0.0:
        # power-law bias of the input sequence (Hamilton 2000 section 3):
        # forward: a_q(r) = a(r) (r/r_c)^{-q}; inverse: A_q(k) =
        # A(k) (k/k_c)^q (k_c r_c)^q
        pre = (np.exp(bias * ((j - j_c) * dln + offset)) if inverse
               else np.exp(-bias * (j - j_c) * dln))
        x = x * along(pre, x, ax, rdt)

    u = _fht_coeff(n, dln, mu, offset, bias, inverse)
    if inverse:
        # scipy's A /= conj(u) as a host reciprocal
        with np.errstate(divide="ignore", invalid="ignore"):
            u = 1.0 / np.conj(u)
        u[~np.isfinite(u)] = 0.0  # singular-inverse ∞ → annihilated bin
    with engine_impl(engine):
        if n % 2 == 0:
            # one-sided: irfftn reconstructs even n
            X = fft_core.rfftn(x, [ax])
            y = fft_core.irfftn(X * _cconst(u, X, ax, rdt), [ax])
        else:
            # odd n: the full transform with the Hermitian-mirrored kernel
            # (real input -> real output, so only the real part survives)
            u_full = np.concatenate([u, np.conj(u[1:][::-1])])
            X = fft_core.fftn(x, [ax])
            y = fft_core.ifftn(X * _cconst(u_full, X, ax, rdt), [ax]).real
    y = y.flip(ax)

    if bias != 0.0:
        post = (np.exp(bias * (j - j_c) * dln) if inverse
                else np.exp(-bias * ((j - j_c) * dln + offset)))
        y = y * along(post, y, ax, rdt)

    # conjugate-grid coordinate: k_j = exp(offset) / r_{n-1-j}
    out_dim = (ce.freq_dim_name(dim) if not inverse
               else (dim[len("freq_"):] if dim.startswith("freq_")
                     else dim))
    out_dims = [out_dim if d == dim else d for d in da.dims]
    coords = {k: c.copy() for k, c in da.coords.items()
              if dim not in c.dims}
    if dim in da.coords:
        r = np.asarray(da.coords[dim].values, dtype=np.float64)
        if r.ndim == 1 and r.size == n and np.all(r > 0):
            coords[out_dim] = Coord((out_dim,), np.exp(offset) / r[::-1],
                                    {}, out_dim)
    return LabeledArray(y, dims=out_dims, coords=coords,
                        attrs=dict(da.attrs), name=da.name)


def fht(da, dln=None, mu=0.0, offset=0.0, bias=0.0, dim=None, engine=None):
    """Fast Hankel transform along ``dim`` (default: last dim) —
    ``scipy.fft.fht``: the discrete ``A(k) = ∫ a(r) J_mu(kr) k dr`` of a
    log-spaced periodic sequence by FFTLog.  ``dln`` defaults to the dim's
    uniform log-spacing (scipy requires it); ``mu`` is the Bessel order,
    ``offset`` the output-grid offset ``ln(k_c r_c)`` (see
    :func:`fhtoffset`), ``bias`` the power-law bias exponent.  Real
    input/output, batched over the other dims.  The output dim is renamed
    ``freq_<dim>`` carrying ``k_j = exp(offset)/r_{n-1-j}`` when the input
    dim has a positive, log-uniform coordinate."""
    return _fht_like(da, dln, mu, offset, bias, dim, engine,
                     inverse=False, caller="fht")


def ifht(da, dln=None, mu=0.0, offset=0.0, bias=0.0, dim=None, engine=None):
    """Inverse fast Hankel transform along ``dim`` — ``scipy.fft.ifht``:
    the discrete ``a(r) = ∫ A(k) J_mu(kr) r dk``, inverting :func:`fht`
    with the same ``dln``/``mu``/``offset``/``bias``.  A ``freq_`` prefix
    on the dim is stripped; the output carries
    ``r_j = exp(offset)/k_{n-1-j}`` when the input dim has a coordinate."""
    return _fht_like(da, dln, mu, offset, bias, dim, engine,
                     inverse=True, caller="ifht")
