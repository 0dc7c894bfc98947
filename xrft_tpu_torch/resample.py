"""Fourier-domain resampling along a named dim.

Counterpart of ``xrft_tpu/resample.py``, with ``scipy.signal.resample``'s
semantics: transform, truncate or zero-pad the spectrum to ``num`` bins
(with scipy's Nyquist-bin split or fold for even lengths),
inverse-transform, scale by ``num/n``.  The spectrum surgery is slicing and
concatenation with a zero block, the optional spectral window a host
constant in fftfreq order, and the fft/ifft pair goes through
:mod:`.ops.fft_core` (cuFFT, K2/K4 or the matmul engine, by
``config.fft_impl``).

Coordinate-aware beyond scipy: a dim coordinate is rebuilt as
``x0 + arange(num) * (dx * n / num)`` (scipy's ``new_t``), keeping the sign
of the spacing.
"""

from __future__ import annotations

import numpy as np
import torch

from . import coords as ce
from .config import engine_impl
from .labeled import Coord, LabeledArray
from .ops import fft_core
from .spectra import _norm_1d_dim
from .utils import along

__all__ = ["resample"]


def _spectral_window(window, n: int) -> np.ndarray:
    """scipy.signal.resample's window resolution: callable -> evaluated on
    fftfreq(n); array -> as-is (length n, fftfreq order); str/tuple ->
    fftshift(get_window(window, n)) so it is centred on the zero bin."""
    if callable(window):
        return np.asarray(window(np.fft.fftfreq(n)), dtype=np.float64)
    if isinstance(window, np.ndarray):
        if window.shape != (n,):
            raise ValueError(
                f"resample: window array must have shape ({n},), got "
                f"{window.shape}")
        return window.astype(np.float64)
    import scipy.signal as sps

    return np.fft.fftshift(
        np.asarray(sps.get_window(window, n, fftbins=True),
                   dtype=np.float64))


def resample(da, num, dim=None, window=None, domain="time", engine=None):
    """Resample to ``num`` points along ``dim`` (default: last dim) with
    the FFT — ``scipy.signal.resample``: exact for signals whose spectrum
    fits in ``min(num, n)`` bins.  Real input gives real output, complex
    input complex.  ``window`` (a scipy window name/tuple, a callable of
    the fftfreq grid, or a length-``n`` array in fftfreq order) multiplies
    the spectrum before the surgery; ``domain="freq"`` declares the input
    already transformed.  The dim's coordinate, if any, is rebuilt with
    spacing ``dx * n / num`` from the same origin."""
    if domain not in ("time", "freq"):
        raise ValueError(
            f"resample: domain must be 'time' or 'freq', got {domain!r}")
    dim = _norm_1d_dim(da, dim, "resample")
    ax = da.dims.index(dim)
    n = da.sizes[dim]
    num = int(num)
    if num < 1:
        raise ValueError("resample: num must be a positive integer")

    real_input = domain == "time" and not da.data.is_complex()
    with engine_impl(engine):
        X = da.data if domain == "freq" else fft_core.fftn(da.data, [ax])
        if window is not None:
            X = X * along(_spectral_window(window, n), X, ax)

        # Spectrum surgery (scipy.signal.resample's two-sided bin
        # bookkeeping): keep the lowest min(num, n) bins; for even N the
        # unpaired Nyquist bin is split in half (upsampling, landing at
        # +N/2 and num-N/2) or the +N/2 / -N/2 pair is folded into one bin
        # (downsampling).
        N = min(num, n)
        nyq = N // 2 + 1  # positive bins incl. Nyquist when N even

        def seg(lo, hi):
            return X.narrow(ax, lo, hi - lo)

        if N % 2 == 0 and num > n:
            # split: Y[+N/2] = X[N/2]/2 and Y[num-N/2] = X[N/2]/2, with the
            # zero block one bin shorter to make room for the extra half
            half = seg(N // 2, N // 2 + 1) * 0.5
            pos = torch.cat([seg(0, N // 2), half], dim=ax)
            negs = [half] + ([seg(n - (N - nyq), n)] if N > 2 else [])
            zeros_len = num - N - 1
        elif N % 2 == 0 and num < n:
            # fold: Y[N/2] = X[+N/2] + X[n-N/2]  (num == N here)
            folded = seg(N // 2, N // 2 + 1) + \
                seg(n - N // 2, n - N // 2 + 1)
            pos = torch.cat([seg(0, N // 2), folded], dim=ax)
            negs = [seg(n - (N - nyq), n)] if N > 2 else []
            zeros_len = 0
        else:  # N odd, or num == n (a pure copy)
            pos = seg(0, nyq)
            negs = [seg(n - (N - nyq), n)] if N > nyq else []
            zeros_len = num - N
        parts = [pos]
        if zeros_len:
            zshape = list(X.shape)
            zshape[ax] = zeros_len
            parts.append(X.new_zeros(zshape))
        Y = torch.cat(parts + negs, dim=ax)

        y = fft_core.ifftn(Y, [ax]) * (float(num) / n)
    if real_input:
        y = y.real

    coords = {k: c.copy() for k, c in da.coords.items()
              if dim not in c.dims}
    if dim in da.coords and ce.is_valid_fft_coord(da.coords[dim]):
        old = np.asarray(da.coords[dim].values)
        dx = ce.first_diff(da.coords[dim])  # signed spacing
        coords[dim] = Coord((dim,), old.flat[0] + np.arange(num)
                            * (dx * n / num),
                            dict(da.coords[dim].attrs), dim)
    return LabeledArray(y, dims=list(da.dims), coords=coords,
                        attrs=dict(da.attrs), name=da.name)
