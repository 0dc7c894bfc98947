"""The float64 precision path: ``engine="hp"``, ``fft64`` and ``ifft64``.

Counterpart of ``xrft_tpu/highprec.py``.  The JAX package carries float64
on the TPU as double-word float32 planes (``DF64``/``CDF64``) through an
int8-limb or df64 DFT, and takes native float64 on backends that have it
(``_hp_native``, ``highprec.py:492-525``).  A CUDA card has FP64 units, so
this module is that native branch alone: every stage (the promotion of
float32 input, detrend, window, the transform, the host-float64 phase and
the scale factors) runs on float64/complex128 tensors on the input's
device.  The transforms go through :mod:`.ops.fft_core`, so
``fft_impl="torch"`` runs cuFFT in complex128 and ``"kernel"`` the K4
recursion (:mod:`.ops.dft64`).  Results are float64 (power spectra, irfft)
or complex128 tensors.

Where the JAX package's hp functions differ from its float32 path, this
module keeps the difference: ``power_spectrum_hp`` takes the full complex
transform (no one-sided transform and mirror) and only defaults
``true_amplitude``; ``ifft_hp`` warns about ``lag=None`` only when a phase
is applied with a non-zero lag, and its output coordinates carry the
frequency coordinates' ``spacing`` attr; ``fft64``/``ifft64`` apply no
detrend or window and never warn.
"""

from __future__ import annotations

import warnings

import numpy as np
import scipy.signal as sps
import torch

from . import coords as ce
from . import telemetry
from .labeled import LabeledArray
from .ops import shards
from .spectra import _doubling_vector
from .transform import (_LAG_NONE_WARNING, _direct_lags, _explicit_lags,
                        _ifft_dims, _ifft_resolved, _norm_dim,
                        _stack_segments, fft)

__all__ = ["fft_hp", "ifft_hp", "power_spectrum_hp", "cross_spectrum_hp",
           "fft64", "ifft64"]


def _promote(da: LabeledArray, complex_out=False) -> LabeledArray:
    """``da`` with its data in float64, or complex128 where the data are
    complex or ``complex_out`` asks for it (``_promote_quad``,
    ``highprec.py:528-540``)."""
    x = da.data
    dtype = torch.complex128 if complex_out or x.is_complex() \
        else torch.float64
    with telemetry.span("prologue"):
        return da.copy(data=x.to(dtype))


def fft_hp(da: LabeledArray, spacing_tol: float = 1e-3, dim=None,
           real_dim: str | None = None, shift: bool = True,
           detrend: str | None = None, window: str | None = None,
           true_phase: bool = True, true_amplitude: bool = True,
           prefix: str = "freq_", chunks_to_segments: bool = False,
           segment_overlap=None, engine=None) -> LabeledArray:
    """:func:`~xrft_tpu_torch.fft` in float64/complex128
    (``xrft_tpu/highprec.py::fft_hp``): the data are cut into segments
    (``chunks_to_segments``) and promoted first, then detrended, windowed
    and transformed at that precision.  ``engine`` is None or the pencil
    engine of the sharded path, which moves the complex128 data through
    its chain."""
    dim = _norm_dim(da, dim)
    if segment_overlap is not None and not chunks_to_segments:
        raise ValueError("segment_overlap requires chunks_to_segments=True")
    if chunks_to_segments:
        da = _stack_segments(da, dim, overlap=segment_overlap)
    out = fft(_promote(da), spacing_tol, dim=dim, real_dim=real_dim,
              shift=shift, detrend=detrend, window=window,
              true_phase=true_phase, true_amplitude=true_amplitude,
              prefix=prefix, engine=engine)
    # the window and mean steps of ``fft`` drop the name; the JAX
    # package's hp transform keeps it
    out.name = da.name
    return out


def ifft_hp(daft: LabeledArray, spacing_tol: float = 1e-3, dim=None,
            real_dim: str | None = None, shift: bool = True,
            true_phase: bool = True, true_amplitude: bool = True,
            prefix: str = "freq_", lag=None,
            chunks_to_segments: bool = False) -> LabeledArray:
    """:func:`~xrft_tpu_torch.ifft` in complex128
    (``xrft_tpu/highprec.py::ifft_hp``); an irfft gives float64.  It keeps
    the input's name and the frequency coordinates' ``spacing`` attrs (not
    under ``chunks_to_segments``: the segments carry neither, as in
    ``xrft_tpu``), and warns about ``lag=None`` only where a non-zero lag is
    applied."""
    dim = _ifft_dims(daft, _norm_dim(daft, dim), real_dim)
    if lag is None:
        lag = _direct_lags(daft, dim)
        if true_phase and any(l != 0.0 for l in lag):
            warnings.warn(_LAG_NONE_WARNING, FutureWarning)
    else:
        lag = _explicit_lags(daft, dim, lag, warn=not true_phase)
    out = _ifft_resolved(_promote(daft, complex_out=True), spacing_tol, dim,
                         real_dim, shift, true_phase, true_amplitude, prefix,
                         lag, chunks_to_segments)
    if chunks_to_segments:
        return out
    for d in dim:
        if d in daft.coords and "spacing" in daft.coords[d].attrs:
            out.coords[ce.freq_dim_name(d, prefix)].attrs["spacing"] = \
                daft.coords[d].attrs["spacing"]
    out.name = daft.name
    return out


def fft64(da: LabeledArray, spacing_tol: float = 1e-3, dim=None,
          shift: bool = True, true_phase: bool = True,
          true_amplitude: bool = True, prefix: str = "freq_") -> LabeledArray:
    """``xrft_tpu.fft64``: :func:`fft_hp` with no detrend and no window;
    complex128 out."""
    return fft_hp(da, spacing_tol, dim, None, shift, None, None, true_phase,
                  true_amplitude, prefix)


def ifft64(daft: LabeledArray, spacing_tol: float = 1e-3, dim=None,
           shift: bool = True, true_phase: bool = True,
           true_amplitude: bool = True, prefix: str = "freq_",
           lag=None) -> LabeledArray:
    """``xrft_tpu.ifft64``: the complex128 inverse with no warnings; the
    frequency coordinates are sorted before the centering check."""
    dim = _ifft_dims(daft, _norm_dim(daft, dim), None)
    lag = _direct_lags(daft, dim) if lag is None \
        else _explicit_lags(daft, dim, lag)
    out = _ifft_resolved(_promote(daft, complex_out=True), spacing_tol, dim,
                         None, shift, true_phase, true_amplitude, prefix, lag)
    out.name = daft.name
    return out


def _hp_scale(da, dim, updated, coords, scaling, window_correction,
              window, strict=True) -> float:
    """The float64 scalar of the hp spectra (``highprec.py:692-716``): the
    window correction as the product over dims of each 1-D window's mean
    square (density) or squared mean, times prod(df) (density) or its
    square.  ``strict=False`` takes the square for any scaling but
    "density", as ``cross_spectrum_hp`` does."""
    scale = 1.0
    if scaling == "false_density":
        return scale
    if window_correction:
        if window is None:
            raise ValueError(
                "window_correction can only be applied when windowing is "
                "turned on."
            )
        wfun = getattr(sps.windows, "hann" if window is True else window)
        corr = 1.0
        for d in dim:
            w = np.asarray(wfun(da.sizes[d], sym=False), np.float64)
            corr *= float(np.mean(w**2)) if scaling == "density" \
                else float(np.mean(w)) ** 2
        scale /= corr
    fs = float(np.prod([np.float64(coords[d].attrs["spacing"])
                        for d in updated]))
    if scaling == "density":
        return scale * fs
    if scaling == "spectrum" or not strict:
        return scale * fs**2
    raise ValueError(f"Unknown {scaling} scaling flag")


def _one_sided(x, daft, da, real_dim, updated, kwargs):
    """x times the one-sided doubling along the real freq axis; the Nyquist
    parity is the segment length's under ``chunks_to_segments``
    (``xrft_tpu/highprec.py:636-645``)."""
    fr = next(d for d in updated if d.endswith(real_dim))
    ax = daft.get_axis_num(fr)
    shape = [1] * x.ndim
    shape[ax] = -1
    n = da.sizes[real_dim]
    if kwargs.get("chunks_to_segments"):
        n = (da.attrs.get("_chunks") or {}).get(real_dim, n)
    lo, hi = shards.local_range(x, ax)
    f = telemetry.to_device(_doubling_vector(n)[lo:hi],
                            dtype=torch.float64, device=x.device)
    return shards.like(x, shards.local(x) * f.reshape(shape))


def power_spectrum_hp(da: LabeledArray, dim=None,
                      real_dim: str | None = None, scaling: str = "density",
                      window_correction: bool = False,
                      **kwargs) -> LabeledArray:
    """``xrft_tpu.power_spectrum(..., engine="hp")``: |F|^2 of the full
    complex128 transform (one-sided along ``real_dim`` only) in float64,
    with every scalar factor computed in host float64."""
    kwargs.setdefault("true_amplitude", True)
    kwargs["true_phase"] = False
    daft = fft_hp(da, dim=dim, real_dim=real_dim, **kwargs)
    dim = _norm_dim(da, dim)
    updated = [d for d in daft.dims
               if d not in da.dims and "segment" not in d]

    with telemetry.span("epilogue"):
        ps = daft.data.real ** 2 + daft.data.imag ** 2
        if real_dim is not None:
            ps = _one_sided(ps, daft, da, real_dim, updated, kwargs)
        scale = _hp_scale(da, dim, updated, daft.coords, scaling,
                          window_correction, kwargs.get("window"))
        if scale != 1.0:
            ps = ps * scale
    with telemetry.span("coords"):
        return LabeledArray(
            ps, dims=daft.dims,
            coords={c: v.copy() for c, v in daft.coords.items()},
            name=da.name)


def cross_spectrum_hp(da1: LabeledArray, da2: LabeledArray, dim=None,
                      real_dim: str | None = None, scaling: str = "density",
                      window_correction: bool = False,
                      **kwargs) -> LabeledArray:
    """``xrft_tpu.cross_spectrum(..., engine="hp")``: F(da1) * conj(F(da2))
    in complex128 with the scaling of :func:`power_spectrum_hp`; named
    ``<name1>_<name2>`` when both inputs are named."""
    if tuple(da1.dims) != tuple(da2.dims):
        raise ValueError("da1 and da2 must have the same dimensions!")
    kwargs.setdefault("true_amplitude", True)
    kwargs.setdefault("true_phase", True)
    daft1 = fft_hp(da1, dim=dim, real_dim=real_dim, **kwargs)
    daft2 = fft_hp(da2, dim=dim, real_dim=real_dim, **kwargs)
    dim = _norm_dim(da1, dim)
    updated = [d for d in daft1.dims
               if d not in da1.dims and "segment" not in d]

    with telemetry.span("epilogue"):
        cs = daft1.data * daft2.data.conj()
        if real_dim is not None:
            cs = _one_sided(cs, daft1, da1, real_dim, updated, kwargs)
        scale = _hp_scale(da1, dim, updated, daft1.coords, scaling,
                          window_correction, kwargs.get("window"),
                          strict=False)
        if scale != 1.0:
            cs = cs * scale
    name = f"{da1.name}_{da2.name}" if da1.name and da2.name else None
    with telemetry.span("coords"):
        return LabeledArray(
            cs, dims=daft1.dims,
            coords={c: v.copy() for c, v in daft1.coords.items()},
            name=name)
