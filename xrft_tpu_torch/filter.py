"""FIR design and polyphase resampling: firwin / upfirdn / resample_poly /
decimate / savgol_coeffs / savgol_filter (scipy.signal namesakes).

Counterpart of ``xrft_tpu/filter.py``, with scipy.signal's semantics:

* :func:`firwin`, :func:`savgol_coeffs` and the Savitzky-Golay edge-fit
  matrices are host numpy (a filter is a function of its static
  parameters); the taps become tensors of the data's dtype on its device.
* :func:`upfirdn` — zero-stuff (a reshape and a pad), the FFT convolution
  of :func:`.convolve._fft_convolve` (cuFFT, K2/K4 or the matmul engine, by
  ``config.fft_impl``), a strided slice.
* :func:`resample_poly` — gcd reduction, a kaiser lowpass and scipy's
  centred-delay bookkeeping around :func:`upfirdn`.
* :func:`decimate` — FIR decimation through :func:`resample_poly`
  (zero-phase) or a causal :func:`upfirdn`.  ``ftype="iir"`` raises, as in
  xrft_tpu: scipy's default Chebyshev ``sosfiltfilt`` is a sequential
  recursion along the dim.
* :func:`savgol_filter` — one FFT convolution with the least-squares taps;
  under ``mode="interp"`` the edges are two products with the host edge-fit
  matrices at full float32 grade (``config.full_fp32``).

Coordinate-aware beyond scipy: :func:`resample_poly` / :func:`decimate`
rebuild an evenly spaced dim coordinate as ``x0 + arange(n_out) *
(dx * down / up)``; :func:`upfirdn` is index-based and drops it.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

from . import coords as ce
from .config import engine_impl, full_fp32
from .dtypes import promote
from .convolve import _fft_convolve
from .labeled import Coord, LabeledArray
from .padding import _pad_constant
from .spectra import _norm_1d_dim
from .utils import along

__all__ = ["firwin", "upfirdn", "resample_poly", "decimate",
           "savgol_coeffs", "savgol_filter"]


# ---------------------------------------------------------------------------
# firwin: host window-method FIR design (scipy.signal.firwin)
# ---------------------------------------------------------------------------


def _kaiser_beta(a):
    """scipy.signal.kaiser_beta: empirical attenuation->beta map."""
    if a > 50:
        return 0.1102 * (a - 8.7)
    if a > 21:
        return 0.5842 * (a - 21) ** 0.4 + 0.07886 * (a - 21)
    return 0.0


def _kaiser_atten(numtaps, width):
    """scipy.signal.kaiser_atten: attenuation of a numtaps kaiser filter
    with normalized transition width `width`."""
    return 2.285 * (numtaps - 1) * np.pi * width + 7.95


def firwin(numtaps, cutoff, width=None, window="hamming", pass_zero=True,
           scale=True, fs=None) -> np.ndarray:
    """Window-method FIR filter design — ``scipy.signal.firwin``: the
    ``numtaps`` coefficients of a linear-phase filter whose passbands are
    delimited by ``cutoff`` (in units of ``fs/2``, or of ``fs`` when
    given).  ``pass_zero`` in {True, False, 'lowpass', 'highpass',
    'bandpass', 'bandstop'}; ``width`` selects a kaiser window by
    transition width.  Host numpy; feed the taps to :func:`upfirdn`,
    :func:`resample_poly` or :func:`~.convolve.convolve`."""
    nyq = 0.5 * (2.0 if fs is None else float(fs))
    cutoff = np.atleast_1d(np.asarray(cutoff, dtype=np.float64)) / nyq
    if cutoff.ndim > 1:
        raise ValueError("The cutoff argument must be at most "
                         "one-dimensional.")
    if cutoff.size == 0:
        raise ValueError("At least one cutoff frequency must be given.")
    if cutoff.min() <= 0 or cutoff.max() >= 1:
        raise ValueError("Invalid cutoff frequency: frequencies must be "
                         "greater than 0 and less than fs/2.")
    if np.any(np.diff(cutoff) <= 0):
        raise ValueError("Invalid cutoff frequencies: the frequencies "
                         "must be strictly increasing.")

    if width is not None:
        window = ("kaiser",
                  _kaiser_beta(_kaiser_atten(numtaps, float(width) / nyq)))

    if pass_zero in ("bandstop", "lowpass"):
        if pass_zero == "lowpass" and cutoff.size != 1:
            raise ValueError("cutoff must have one element if "
                             f"pass_zero=='lowpass', got {cutoff.shape}")
        if pass_zero == "bandstop" and cutoff.size <= 1:
            raise ValueError("cutoff must have at least two elements if "
                             f"pass_zero=='bandstop', got {cutoff.shape}")
        pass_zero = True
    elif pass_zero in ("bandpass", "highpass"):
        if pass_zero == "highpass" and cutoff.size != 1:
            raise ValueError("cutoff must have one element if "
                             f"pass_zero=='highpass', got {cutoff.shape}")
        if pass_zero == "bandpass" and cutoff.size <= 1:
            raise ValueError("cutoff must have at least two elements if "
                             f"pass_zero=='bandpass', got {cutoff.shape}")
        pass_zero = False
    elif pass_zero is not True and pass_zero is not False:
        raise ValueError(
            f"Parameter pass_zero={pass_zero!r} not in (True, False, "
            "'bandpass', 'lowpass', 'highpass', 'bandstop')")

    pass_nyquist = (cutoff.size % 2 == 0) == pass_zero
    if pass_nyquist and numtaps % 2 == 0:
        raise ValueError("A filter with an even number of coefficients "
                         "must have zero response at the Nyquist "
                         "frequency.")

    bands = np.concatenate([
        np.zeros(int(pass_zero)), cutoff, np.ones(int(pass_nyquist))
    ]).reshape(-1, 2)

    m = np.arange(numtaps, dtype=np.float64) - 0.5 * (numtaps - 1)
    h = np.zeros(numtaps)
    for left, right in bands:
        h += right * np.sinc(right * m) - left * np.sinc(left * m)

    import scipy.signal as sps

    h *= np.asarray(sps.get_window(window, numtaps, fftbins=False),
                    dtype=np.float64)

    if scale:
        left, right = bands[0]
        scale_frequency = (0.0 if left == 0
                           else 1.0 if right == 1
                           else 0.5 * (left + right))
        h /= np.sum(h * np.cos(np.pi * m * scale_frequency))
    return h


# ---------------------------------------------------------------------------
# upfirdn: zero-stuff -> FFT-convolve -> strided slice
# ---------------------------------------------------------------------------


def _output_len(len_h, in_len, up, down):
    """scipy.signal.upfirdn's output length."""
    return ((in_len - 1) * up + len_h - 1) // down + 1


def _zero_stuff(x, ax, up):
    """Insert ``up - 1`` zeros after every sample along ``ax`` (a reshape
    and a pad; no scatter)."""
    if up == 1:
        return x
    shape = list(x.shape)
    stuffed = F.pad(x.unsqueeze(ax + 1), [0, 0] * (x.ndim - 1 - ax)
                    + [0, up - 1])
    return stuffed.reshape(shape[:ax] + [shape[ax] * up] + shape[ax + 1:])


def upfirdn(h, da, up=1, down=1, dim=None, mode="constant", cval=0,
            engine=None):
    """Upsample by ``up`` (zero-stuffing), apply the FIR filter ``h`` (a
    1-D host array of taps), downsample by ``down`` —
    ``scipy.signal.upfirdn`` along ``dim`` (default: last dim).  Output
    length is ``((n-1)*up + len(h) - 1) // down + 1``.  Index-based like
    scipy's: the dim's coordinate is dropped.  Only scipy's default
    boundary (``mode='constant', cval=0``) is supported."""
    if mode != "constant" or cval != 0:
        raise NotImplementedError(
            "upfirdn: only mode='constant' with cval=0 is supported; "
            "pre-pad the signal explicitly with xrft_tpu_torch.pad for "
            "other boundaries")
    up, down = int(up), int(down)
    if up < 1 or down < 1:
        raise ValueError("upfirdn: up and down must be >= 1")
    h = np.asarray(h, dtype=np.float64)
    if h.ndim != 1 or h.size == 0:
        raise ValueError("upfirdn: h must be a non-empty 1-D array of "
                         "filter taps")
    dim = _norm_1d_dim(da, dim, "upfirdn")
    ax = da.dims.index(dim)
    n = da.sizes[dim]

    x = _zero_stuff(promote(da.data, "float64"), ax, up)
    with engine_impl(engine):
        y = _fft_convolve(x, along(h, x, ax), [ax], [n * up], [h.size])
    n_out = _output_len(h.size, n, up, down)
    y = y.narrow(ax, 0, (n_out - 1) * down + 1)
    y = y[(slice(None),) * ax + (slice(None, None, down),)]
    if not da.data.is_complex():
        y = y.real

    coords = {k: c.copy() for k, c in da.coords.items()
              if dim not in c.dims}
    return LabeledArray(y, dims=list(da.dims), coords=coords,
                        attrs=dict(da.attrs), name=da.name)


# ---------------------------------------------------------------------------
# resample_poly / decimate
# ---------------------------------------------------------------------------


def _rebuilt_coord(da, dim, n_out, up, down):
    """Output coordinate x0 + arange(n_out) * dx*down/up (signed dx)."""
    coords = {k: c.copy() for k, c in da.coords.items()
              if dim not in c.dims}
    if dim in da.coords and ce.is_valid_fft_coord(da.coords[dim]):
        old = np.asarray(da.coords[dim].values)
        dx = ce.first_diff(da.coords[dim])
        coords[dim] = Coord((dim,), old.flat[0] + np.arange(n_out)
                            * (dx * down / up),
                            dict(da.coords[dim].attrs), dim)
    return coords


def _median(x, ax):
    """numpy's median along ``ax`` (the mean of the two middle values for
    an even count; torch.median takes the lower one)."""
    s = x.sort(dim=ax).values
    n = x.shape[ax]
    mid = s.narrow(ax, (n - 1) // 2, 2 - n % 2)
    return mid.mean(dim=ax, keepdim=True)


def _background(x, ax, padtype):
    if padtype == "mean":
        return x.mean(dim=ax, keepdim=True)
    if padtype == "median":
        return _median(x, ax)
    if padtype == "minimum":
        return x.amin(dim=ax, keepdim=True)
    return x.amax(dim=ax, keepdim=True)


def resample_poly(da, up, down, dim=None, window=("kaiser", 5.0),
                  padtype="constant", cval=None, engine=None):
    """Polyphase resampling by the rational factor ``up/down`` along
    ``dim`` — ``scipy.signal.resample_poly``: gcd-reduce the ratio, design
    a kaiser lowpass at ``1/max(up, down)`` (or take ``window`` as explicit
    taps), zero-stuff/filter/downsample with the filter delay centred,
    output length ``ceil(n * up / down)``.  ``padtype`` in {'constant'
    (zeros, scipy's default), 'mean', 'median', 'minimum', 'maximum'}: the
    statistic padtypes subtract the per-dim background before filtering
    and add it back, as scipy does.  The dim's coordinate, if any, is
    rebuilt with spacing ``dx * down / up`` from the same origin."""
    up, down = int(up), int(down)
    if up < 1 or down < 1:
        raise ValueError("resample_poly: up and down must be >= 1")
    if cval is not None and padtype != "constant":
        raise ValueError("cval has no effect when padtype is "
                         f"{padtype!r}")
    if cval not in (None, 0):
        raise NotImplementedError(
            "resample_poly: nonzero cval is unsupported; pre-pad "
            "explicitly with xrft_tpu_torch.pad")
    dim = _norm_1d_dim(da, dim, "resample_poly")
    ax = da.dims.index(dim)
    g = math.gcd(up, down)
    up //= g
    down //= g
    n_in = da.sizes[dim]
    n_out = n_in * up // down + bool(n_in * up % down)
    if up == down == 1:
        return da.copy()

    if isinstance(window, (list, np.ndarray)):
        h = np.asarray(window, dtype=np.float64)
        if h.ndim != 1:
            raise ValueError("window must be 1-D")
        half_len = (h.size - 1) // 2
    else:
        max_rate = max(up, down)
        half_len = 10 * max_rate
        h = firwin(2 * half_len + 1, 1.0 / max_rate, window=window)
    h = h * up

    # centre the output samples: pre/post zero-pad the taps so the first
    # kept output is the filter's group-delay-compensated sample 0
    n_pre_pad = down - half_len % down
    n_post_pad = 0
    n_pre_remove = (half_len + n_pre_pad) // down
    while _output_len(h.size + n_pre_pad + n_post_pad, n_in,
                      up, down) < n_out + n_pre_remove:
        n_post_pad += 1
    h = np.concatenate([np.zeros(n_pre_pad), h, np.zeros(n_post_pad)])

    background = None
    x = da
    if padtype in ("mean", "median", "minimum", "maximum"):
        data = promote(da.data, "float64")
        if data.is_complex():
            background = torch.complex(_background(data.real, ax, padtype),
                                       _background(data.imag, ax, padtype))
        else:
            background = _background(data, ax, padtype)
        x = da.copy(data=data - background)
    elif padtype != "constant":
        raise NotImplementedError(
            f"resample_poly: padtype {padtype!r} is unsupported; use "
            "'constant'/'mean'/'median'/'minimum'/'maximum' or pre-pad "
            "explicitly with xrft_tpu_torch.pad")

    y = upfirdn(h, x, up, down, dim=dim, engine=engine)
    data = y.data.narrow(ax, n_pre_remove, n_out)
    if background is not None:
        data = data + background

    coords = _rebuilt_coord(da, dim, n_out, up, down)
    return LabeledArray(data, dims=list(da.dims), coords=coords,
                        attrs=dict(da.attrs), name=da.name)


def decimate(da, q, n=None, ftype="fir", dim=None, zero_phase=True,
             engine=None):
    """Downsample by the integer factor ``q`` after an anti-aliasing FIR
    filter — ``scipy.signal.decimate(..., ftype='fir')``: a
    ``firwin(n+1, 1/q, window='hamming')`` lowpass (default order
    ``n = 20*q``), applied zero-phase through :func:`resample_poly`
    (default) or causally through :func:`upfirdn` (``zero_phase=False``;
    the result then lags by the filter's group delay, as scipy's does).

    **Deviation from scipy**, as in xrft_tpu: ``ftype`` defaults to
    ``'fir'`` and ``'iir'`` raises.  The dim's coordinate, if any, is
    rebuilt with spacing ``dx * q`` from the same origin."""
    q = int(q)
    if q < 1:
        raise ValueError("decimate: q must be a positive integer")
    if ftype == "iir":
        raise NotImplementedError(
            "decimate: ftype='iir' (scipy's default sosfiltfilt Chebyshev "
            "cascade) is a sequential recursion along the dim and is not "
            "implemented on this backend; use ftype='fir' (matches "
            "scipy.signal.decimate(..., ftype='fir') exactly)")
    if ftype != "fir":
        raise ValueError("decimate: ftype must be 'fir'")
    if n is None:
        n = 20 * q
    b = firwin(int(n) + 1, 1.0 / q, window="hamming")
    dim = _norm_1d_dim(da, dim, "decimate")
    if zero_phase:
        res = resample_poly(da, 1, q, dim=dim, window=b, engine=engine)
    else:
        n_in = da.sizes[dim]
        n_out = n_in // q + bool(n_in % q)
        y = upfirdn(b, da, 1, q, dim=dim, engine=engine)
        res = LabeledArray(y.data.narrow(da.dims.index(dim), 0, n_out),
                           dims=list(da.dims),
                           coords=_rebuilt_coord(da, dim, n_out, 1, q),
                           attrs=dict(da.attrs), name=da.name)
    res.name = f"{da.name}_decimated" if da.name else None
    return res


# ---------------------------------------------------------------------------
# Savitzky-Golay smoothing: host design, one FFT convolution, host edge-fit
# matrices
# ---------------------------------------------------------------------------


def savgol_coeffs(window_length, polyorder, deriv=0, delta=1.0, pos=None,
                  use="conv") -> np.ndarray:
    """Savitzky-Golay FIR coefficients — ``scipy.signal.savgol_coeffs``:
    the least-squares polynomial-smoothing (or ``deriv``-th derivative)
    filter of length ``window_length`` evaluated at ``pos`` (default: the
    centre).  Host numpy."""
    if polyorder >= window_length:
        raise ValueError("polyorder must be less than window_length.")
    halflen, rem = divmod(window_length, 2)
    if pos is None:
        pos = halflen - 0.5 if rem == 0 else halflen
    if not 0 <= pos < window_length:
        raise ValueError("pos must be nonnegative and less than "
                         "window_length.")
    if use not in ("conv", "dot"):
        raise ValueError("`use` must be 'conv' or 'dot'")
    if deriv > polyorder:
        return np.zeros(window_length)
    x = np.arange(-pos, window_length - pos, dtype=np.float64)
    if use == "conv":
        x = x[::-1]
    A = x ** np.arange(polyorder + 1, dtype=np.float64)[:, None]
    y = np.zeros(polyorder + 1)
    y[deriv] = math.factorial(deriv) / (delta ** deriv)
    coeffs, _, _, _ = np.linalg.lstsq(A, y, rcond=None)
    return coeffs


def _edge_fit_matrix(window_length, polyorder, deriv, delta, interp_idx):
    """The linear map from the ``window_length`` edge samples to the
    polyfit-interpolated values at local positions ``interp_idx`` (scipy's
    ``_fit_edge`` is linear in the data: polyfit, polyder and polyval
    compose into one host matrix)."""
    t = np.arange(window_length, dtype=np.float64)
    V = np.vander(t, polyorder + 1)  # highest power first, like polyfit
    P = np.linalg.pinv(V)  # samples -> poly coeffs (p+1, w)
    # polyder (highest-first convention), deriv times
    D = np.eye(polyorder + 1)
    for _ in range(deriv):
        k = D.shape[0] - 1
        if k == 0:
            D = np.zeros((1, polyorder + 1)) @ D
            break
        D = (np.arange(k, 0, -1)[:, None] * np.eye(k, k + 1)) @ D
    i = np.asarray(interp_idx, dtype=np.float64)
    Veval = np.vander(i, D.shape[0])
    return (Veval @ D @ P) / (delta ** deriv)


def _pad_axis(x, ax, lo, hi, mode, cval):
    """numpy's pad of one axis on the data's device: a constant fill, or
    the element index numpy's index modes gather."""
    if mode == "constant":
        widths = [(0, 0)] * x.ndim
        widths[ax] = (lo, hi)
        return _pad_constant(x, widths, cval)
    idx = np.pad(np.arange(x.shape[ax]), (lo, hi), mode=mode)
    return x.index_select(ax, torch.as_tensor(idx, device=x.device))


def savgol_filter(da, window_length, polyorder, deriv=0, delta=1.0,
                  dim=None, mode="interp", cval=0.0, engine=None):
    """Savitzky-Golay smoothing/differentiation along ``dim`` (default:
    last dim) — ``scipy.signal.savgol_filter``: one FIR convolution with
    the host least-squares taps; ``mode`` in {'interp' (scipy's default:
    the ``window_length // 2`` edge samples are replaced by a polynomial
    fitted to the first/last ``window_length`` samples, here a host
    edge-fit matrix applied in one product), 'mirror', 'nearest',
    'constant', 'wrap'}.  Same-length output; index-based, so dims/coords
    pass through (``delta`` carries the sample spacing, as in scipy).
    Real input only."""
    if mode not in ("mirror", "constant", "nearest", "interp", "wrap"):
        raise ValueError("mode must be 'mirror', 'constant', 'nearest' "
                         "'wrap' or 'interp'.")
    dim = _norm_1d_dim(da, dim, "savgol_filter")
    if da.data.is_complex():
        raise ValueError("savgol_filter: input must be real")
    ax = da.dims.index(dim)
    n = da.sizes[dim]
    w = int(window_length)
    halflen = w // 2
    coeffs = savgol_coeffs(w, polyorder, deriv=deriv, delta=delta)

    x = promote(da.data, "float64")
    if mode == "interp" and w > n:
        raise ValueError("If mode is 'interp', window_length must be "
                         "less than or equal to the size of x.")
    # ndimage.convolve1d centres an even-length kernel at w//2, so the LEFT
    # extension is w-1-halflen and the RIGHT is halflen
    pmode = {"interp": "constant", "mirror": "reflect", "nearest": "edge",
             "wrap": "wrap", "constant": "constant"}[mode]
    xp = _pad_axis(x, ax, w - 1 - halflen, halflen, pmode,
                   cval if mode == "constant" else 0)

    # 'valid' correlation with the (already conv-reversed) taps ==
    # ndimage.convolve1d's aligned output: full conv, keep [w-1, w-1+n)
    with engine_impl(engine):
        y = _fft_convolve(xp, along(coeffs, xp, ax), [ax], [n + w - 1], [w])
    y = y.narrow(ax, w - 1, n).real

    if mode == "interp" and halflen > 0:
        El = _edge_fit_matrix(w, polyorder, deriv, delta, np.arange(halflen))
        Er = _edge_fit_matrix(w, polyorder, deriv, delta,
                              np.arange(w - halflen, w))
        xm = x.movedim(ax, -1)
        El, Er = (torch.as_tensor(E, dtype=xm.dtype, device=xm.device)
                  for E in (El, Er))
        with full_fp32():
            head = torch.matmul(xm[..., :w], El.T)
            tail = torch.matmul(xm[..., n - w:], Er.T)
        ym = y.movedim(ax, -1)
        y = torch.cat([head, ym[..., halflen:n - halflen], tail],
                      dim=-1).movedim(-1, ax)

    out = da.copy(data=y)
    out.name = f"{da.name}_savgol" if da.name else None
    return out
