"""Optional xarray interop.

Counterpart of ``xrft_tpu/xarray_compat.py``.  When xarray is installed,
:func:`from_xarray` / :func:`to_xarray` convert between ``xarray.DataArray``
and :class:`~xrft_tpu_torch.labeled.LabeledArray` losslessly (dims, 1-D and
multi-dim coords, attrs, name): the DataArray's values land on the CUDA
device unless the caller asks for another (``device=``), and come back to
the host.  :func:`xr_boundary` lets every public function take and return
DataArrays, and :class:`XrftAccessor` is the ``da.xrft.<method>``
accessor.  xarray is not a dependency of this package; the converters raise
a clear ImportError without it.
"""

from __future__ import annotations

import functools

import numpy as np

from .labeled import Coord, LabeledArray, resolve_device

__all__ = ["from_xarray", "to_xarray", "is_dataarray", "xr_boundary",
           "XrftAccessor", "register_accessor"]


def _require_xarray():
    try:
        import xarray
    except ImportError as e:
        raise ImportError(
            "xarray is required for from_xarray/to_xarray; install it or "
            "construct LabeledArray directly."
        ) from e
    return xarray


def from_xarray(da, device=None) -> LabeledArray:
    """Convert an ``xarray.DataArray`` to a :class:`LabeledArray` whose data
    lie on ``device`` (default: the CUDA device, see
    :func:`~xrft_tpu_torch.labeled.resolve_device`)."""
    _require_xarray()
    coords = {
        name: Coord(tuple(c.dims), np.asarray(c.values), dict(c.attrs), name)
        for name, c in da.coords.items()
    }
    return LabeledArray(
        np.asarray(da.values),
        dims=tuple(da.dims),
        coords=coords,
        attrs=dict(da.attrs),
        name=da.name,
        device=resolve_device(device),
    )


def to_xarray(la: LabeledArray):
    """Convert a :class:`LabeledArray` to an ``xarray.DataArray`` holding
    its values on the host."""
    xr = _require_xarray()
    coords = {}
    for name, c in la.coords.items():
        coords[name] = xr.DataArray(
            c.values, dims=c.dims, attrs=dict(c.attrs), name=name
        )
    return xr.DataArray(
        la.values,
        dims=la.dims,
        coords=coords,
        attrs=dict(la.attrs),
        name=la.name,
    )


def is_dataarray(obj) -> bool:
    """Duck-typed check for ``xarray.DataArray`` without importing xarray
    (works with any module exposing the DataArray surface we consume)."""
    t = type(obj)
    if t.__module__.split(".")[0] not in ("xarray",):
        return False
    return all(hasattr(obj, a) for a in ("dims", "coords", "attrs", "values"))


def xr_boundary(fn):
    """Wrap a public function so it accepts and returns
    ``xarray.DataArray`` (``xrft_tpu/xarray_compat.py:74-110``): DataArray
    arguments are converted via :func:`from_xarray`; if the first array
    argument was a DataArray, LabeledArray results (alone or in a tuple)
    convert back via :func:`to_xarray`.  When a DataArray is among the
    arguments, a ``device=`` keyword names the device its data go to, and
    is not passed on."""

    @functools.wraps(fn)
    def wrapper(*args, **kwargs):
        # the "first array argument" is the first positional that is a
        # DataArray or LabeledArray: upfirdn(h, da) keys off da, not the
        # numpy taps
        was_xr = False
        for a in args:
            if is_dataarray(a):
                was_xr = True
                break
            if isinstance(a, LabeledArray):
                break
        if was_xr or any(is_dataarray(a) for a in args) or \
                any(is_dataarray(v) for v in kwargs.values()):
            device = kwargs.pop("device", None)
            args = tuple(from_xarray(a, device) if is_dataarray(a) else a
                         for a in args)
            kwargs = {k: from_xarray(v, device) if is_dataarray(v) else v
                      for k, v in kwargs.items()}
        out = fn(*args, **kwargs)
        if was_xr:
            if isinstance(out, LabeledArray):
                return to_xarray(out)
            if isinstance(out, tuple):
                return tuple(to_xarray(o) if isinstance(o, LabeledArray)
                             else o for o in out)
        return out

    wrapper.__wrapped_la__ = fn
    return wrapper


class XrftAccessor:
    """``da.xrft.<method>`` accessor on xarray DataArrays, mirroring the
    package namespace (fft/ifft, spectra, isotropic estimators, pad/unpad,
    detrend, high-precision variants); the methods are those of
    ``xrft_tpu_torch``."""

    _METHODS = (
        "fft", "ifft", "dft", "idft", "power_spectrum", "cross_spectrum",
        "cross_phase", "coherence", "spectrogram", "welch", "csd",
        "periodogram", "stft", "istft", "hilbert", "hilbert2", "envelope",
        "dct", "idct", "dst", "idst", "dctn", "idctn", "dstn", "idstn",
        "czt", "zoom_fft", "resample", "resample_poly", "decimate",
        "convolve", "fftconvolve", "oaconvolve", "correlate", "lombscargle",
        "fht", "ifht",
        "isotropize",
        "isotropic_power_spectrum", "isotropic_cross_spectrum",
        "pad", "unpad", "detrend", "fft64", "ifft64",
    )

    def __init__(self, da):
        self._da = da

    def __getattr__(self, name):
        if name not in self._METHODS:
            raise AttributeError(name)
        import xrft_tpu_torch

        fn = getattr(xrft_tpu_torch, name)

        def method(*args, **kwargs):
            return fn(self._da, *args, **kwargs)

        method.__name__ = name
        return method


def register_accessor(xarray_module=None) -> bool:
    """Register the ``.xrft`` DataArray accessor; returns True on success.
    Called at package import; a no-op when xarray is absent."""
    try:
        xr = xarray_module
        if xr is None:
            import xarray as xr
    except ImportError:
        return False
    try:
        xr.register_dataarray_accessor("xrft")(XrftAccessor)
    except Exception:
        return False
    return True
