"""Coordinate engine: host-side static metadata math.

A copy of ``xrft_tpu/coords.py`` (numpy only) so that this package never
imports the JAX package.  All functions here run eagerly on host numpy, as
coordinates always do in xrft (``xrft/xrft.py:139-234,269-304``).  Their
outputs (spacings, lags, frequency grids, flip/shift decisions) steer the
torch ops on the bulk data.

Covers: uniform-spacing extraction for numeric / datetime64 / cftime
coordinates, lag (grid midpoint) computation, forward and inverse frequency
grid construction (fftfreq / rfftfreq / irfftfreq), freq-dim naming, and
coordinate validation.
"""

from __future__ import annotations

import numpy as np

from .labeled import Coord, LabeledArray

__all__ = [
    "diff_coord",
    "first_diff",
    "lag_coord",
    "get_coordinate_spacing",
    "freq_grids",
    "ifreq_grids",
    "freq_dim_name",
    "is_valid_fft_coord",
    "check_valid_fft_coords",
]

# Epoch for cftime decoding, matching the reference convention
# (xrft/xrft.py:203).
_CFTIME_UNITS = "seconds since 1800-01-01 00:00:00"


def _is_cftime(values: np.ndarray) -> bool:
    if values.dtype != object or values.size == 0:
        return False
    return getattr(values.flat[0], "calendar", None) is not None


def diff_coord(coord: Coord) -> np.ndarray:
    """First differences of a coordinate, in seconds for time-like coords.

    Numeric coords: plain ``np.diff``.  ``datetime64`` coords: nanosecond
    differences converted to float seconds.  cftime coords (optional dep):
    decoded via ``cftime.date2num`` against a fixed 1800-01-01 epoch.
    Reference behaviour: ``xrft/xrft.py:195-212``.
    """
    values = np.asarray(coord.values)
    if _is_cftime(values):
        import cftime  # optional dependency, gated like the reference

        calendar = values.flat[0].calendar
        decoded = np.asarray(cftime.date2num(values, _CFTIME_UNITS, calendar))
        return np.diff(decoded)
    if np.issubdtype(values.dtype, np.datetime64):
        diff = np.diff(values).astype("timedelta64[ns]").astype("f8")
        return diff / 1e9
    return np.diff(values)


def first_diff(coord: Coord):
    """``diff_coord(coord)[0]`` from the first two elements only, without
    differencing a long coordinate."""
    return diff_coord(coord.copy(values=np.asarray(coord.values)[:2]))[0]


def lag_coord(coord: Coord) -> float:
    """The 'lag' of a coordinate: the middle element of the ascending grid.

    For a length-N coordinate sorted ascending this is element ``N // 2`` —
    the grid point that ``ifftshift`` moves to position zero.  Decreasing
    coordinates are flipped first.  Time-like coords are converted to float
    seconds.  Reference behaviour: ``xrft/xrft.py:215-234``
    (note the reference converts datetime64 lag with seconds truncation,
    ``.astype('timedelta64[s]')``; we preserve that).
    """
    values = np.asarray(coord.values)
    if values[-1] > values[0]:
        data = values
    else:
        data = np.flip(values, axis=-1)
    lag = data[len(data) // 2]
    if _is_cftime(values):
        import cftime

        return float(cftime.date2num(lag, _CFTIME_UNITS, values.flat[0].calendar))
    if np.issubdtype(values.dtype, np.datetime64):
        return float(np.asarray(lag).astype("timedelta64[s]").astype("f8"))
    return lag


def get_coordinate_spacing(coord: Coord, spacing_tol: float) -> float:
    """Uniform spacing |Δx| of a coordinate, validated within spacing_tol.

    Raises ValueError for unevenly spaced or zero-spaced coordinates
    (reference ``xrft/xrft.py:291-304``).
    """
    diff = diff_coord(coord)
    delta = np.abs(diff[0])
    if not np.allclose(diff, diff[0], rtol=spacing_tol):
        raise ValueError(
            "Can't take Fourier transform because "
            f"coordinate {coord.name or coord.dims[0]} is not evenly spaced"
        )
    if delta == 0.0:
        raise ValueError(
            "Can't take Fourier transform because spacing in coordinate "
            f"{coord.name or coord.dims[0]} is zero"
        )
    return delta


def _irfftfreq(n: int, d: float) -> np.ndarray:
    # The frequency grid of the inverse of an rfft output of length n:
    # a full fftfreq grid of size 2*(n-1).  Not in standard numpy
    # (reference xrft/xrft.py:164-166).
    return np.fft.fftfreq(2 * (n - 1), d)


def freq_grids(N, delta_x, real_dim_last: bool, shift: bool):
    """Forward-transform frequency grids, one per transformed axis.

    ``rfftfreq`` on the last axis when the real transform is taken there;
    optional fftshift.  Reference ``xrft/xrft.py:139-155``.
    """
    fns = [np.fft.fftfreq] * len(N)
    if real_dim_last:
        fns[-1] = np.fft.rfftfreq
    k = [fn(n, d) for fn, n, d in zip(fns, N, delta_x)]
    if shift:
        k = [np.fft.fftshift(f) for f in k]
    return k


def ifreq_grids(N, delta_x, real_dim_last: bool, shift: bool):
    """Inverse-transform output coordinate grids
    (reference ``xrft/xrft.py:158-175``)."""
    fns = [np.fft.fftfreq] * len(N)
    if real_dim_last:
        fns[-1] = _irfftfreq
    k = [fn(n, d) for fn, n, d in zip(fns, N, delta_x)]
    if shift:
        k = [np.fft.fftshift(f) for f in k]
    return k


def freq_dim_name(dim: str, prefix: str = "freq_") -> str:
    """Map a dim name to its transformed name: add the prefix, or strip it
    if already present (round-trip naming, reference
    ``xrft/xrft.py:186``)."""
    if dim[: len(prefix)] != prefix:
        return prefix + dim
    return dim[len(prefix):]


def is_valid_fft_coord(coord: Coord) -> bool:
    """A coordinate is transformable if numeric, datetime64, or cftime
    (reference ``xrft/xrft.py:269-274``)."""
    values = np.asarray(coord.values)
    if np.issubdtype(values.dtype, np.number):
        return True
    if np.issubdtype(values.dtype, np.datetime64):
        return True
    if values.size and bool(getattr(values.flat[0], "calendar", False)):
        return True
    return False


def check_valid_fft_coords(da: LabeledArray, dim) -> None:
    for d in dim:
        if d not in da.coords:
            continue  # dims without coords are allowed (integer grid assumed)
        if not is_valid_fft_coord(da.coords[d]):
            raise ValueError(
                "All transformed dimensions coordinates must be numerical or "
                "datetime."
            )
