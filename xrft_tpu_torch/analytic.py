"""Analytic signal (Hilbert transform) and amplitude envelope.

Counterpart of ``xrft_tpu/analytic.py``, with ``scipy.signal.hilbert``'s
semantics: the analytic signal

    xa[n] = x[n] + i * H(x)[n] = ifft(fft(x) * h),
    h = [1, 2, ..., 2, 1, 0, ..., 0]   (even N; the lone 1 at Nyquist)
        [1, 2, ..., 2,    0, ..., 0]   (odd N)

The mask ``h`` is a host constant rounded to the data's real dtype, and the
transform pair goes through :mod:`.ops.fft_core` (cuFFT, K2/K4 or the
matmul engine, by ``config.fft_impl``).  The transformer is index-based,
like scipy's: dims, coords and attrs pass through and no spacing is checked.
"""

from __future__ import annotations

import numpy as np
import torch

from .config import engine_impl
from .ops import fft_core
from .spectra import _norm_1d_dim
from .utils import along

__all__ = ["hilbert", "hilbert2", "envelope"]


def _as_float(x: torch.Tensor) -> torch.Tensor:
    """Integer and bool data promote as ``jnp.fft`` promotes them under
    x64: 64-bit integers to float64, narrower ones to float32."""
    if x.is_floating_point() or x.is_complex():
        return x
    return x.to(torch.float64 if x.element_size() == 8 else torch.float32)


def _analytic_mask(n: int) -> np.ndarray:
    h = np.zeros(n)
    h[0] = 1.0
    if n % 2 == 0:
        h[1:n // 2] = 2.0
        h[n // 2] = 1.0
    else:
        h[1:(n + 1) // 2] = 2.0
    return h


def _mask2(n: int) -> np.ndarray:
    """scipy's 2-D single-orthant mask: for even N the unpaired Nyquist bin
    is zeroed (1 + s_N(p) with s_N(N/2) = -1), not kept at 1 as in 1-D."""
    h = np.zeros(n)
    h[0] = 1.0
    h[1:(n + 1) // 2] = 2.0
    return h


def hilbert(da, dim=None, engine=None):
    """Analytic signal ``x + i*H(x)`` along ``dim`` (default: last dim) —
    ``scipy.signal.hilbert``.  Input must be real (float or integer); the
    output is complex with the input's dims/coords/attrs unchanged.  The
    imaginary part is the Hilbert transform; :func:`envelope` is its
    magnitude.  There is no ``N=``: zero-pad with :func:`~.padding.pad`.
    """
    dim = _norm_1d_dim(da, dim, "hilbert")
    if da.data.is_complex():
        raise ValueError("hilbert: input must be real (scipy convention)")
    ax = da.dims.index(dim)
    with engine_impl(engine):
        ft = fft_core.fftn(_as_float(da.data), [ax])
        ft = ft * along(_analytic_mask(da.sizes[dim]), ft, ax)
        xa = fft_core.ifftn(ft, [ax])
    out = da.copy(data=xa)
    out.name = f"{da.name}_analytic" if da.name else None
    return out


def hilbert2(da, dim=None, engine=None):
    """2-D analytic signal along two dims — ``scipy.signal.hilbert2``:
    ``ifft2(fft2(x) * (h1 ⊗ h2))``, so only the (+,+) frequency quadrant
    survives.  ``dim`` defaults to the last two dims.  Input must be real;
    the output is complex with dims/coords/attrs unchanged."""
    if dim is None:
        if len(da.dims) < 2:
            raise ValueError("hilbert2: input must have at least 2 dims")
        dims = list(da.dims[-2:])
    elif isinstance(dim, str):
        raise ValueError("hilbert2: dim must name exactly 2 dims "
                         f"(got {dim!r})")
    else:
        dims = list(dim)
    if len(dims) != 2:
        raise ValueError(f"hilbert2: dim must name exactly 2 dims "
                         f"(got {dims!r})")
    bad = [d for d in dims if d not in da.dims]
    if bad:
        raise ValueError(f"hilbert2: dims {bad} not found in {da.dims}")
    if da.data.is_complex():
        raise ValueError("hilbert2: input must be real (scipy convention)")
    axes = [da.dims.index(d) for d in dims]
    with engine_impl(engine):
        ft = fft_core.fftn(_as_float(da.data), axes)
        # the mask h1 ⊗ h2 built on the device from its two factors (its
        # values 0, 1, 2 and 4 are exact in any float dtype)
        h1, h2 = (along(_mask2(da.shape[ax]), ft, ax) for ax in axes)
        xa = fft_core.ifftn(ft * (h1 * h2), axes)
    out = da.copy(data=xa)
    out.name = f"{da.name}_analytic2" if da.name else None
    return out


def envelope(da, dim=None, engine=None):
    """Amplitude envelope ``|hilbert(da)|`` — the instantaneous amplitude
    of the analytic signal (``np.abs(scipy.signal.hilbert(x))``)."""
    xa = hilbert(da, dim=dim, engine=engine)
    out = xa.copy(data=xa.data.abs())
    out.name = f"{da.name}_envelope" if da.name else None
    return out
