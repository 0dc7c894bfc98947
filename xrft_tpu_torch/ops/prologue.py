"""K6: the detrend-and-window prologue (``csrc/prologue.cu``).

Launched only by :func:`xrft_tpu_torch.detrend.detrend_and_window`, which
decides by dtype, device and axes which stacks it takes and keeps the plain
version, ``detrend._detrended`` followed by ``ops/window.apply_window``, for
the rest (and as its oracle).  :class:`Plan` holds the host's part: the
block's geometry, which trend parts are fitted in which order, and the
sums of squares of the centred coordinates, as the plain version computes
them; :func:`trend_code` turns the order into the kernel's trend.  One
pair of kernels takes one, two or three trailing axes: fewer axes are
the case of one plane (and one row).
"""

from __future__ import annotations

import ctypes
import math
from typing import NamedTuple

import numpy as np
import torch

__all__ = ["Plan", "plan", "chunking", "trend_code", "detrend_window"]

_SUFFIX = {torch.float32: "f32", torch.float64: "f64"}
# the most columns of a row one warp takes: a longer row is cut into chunks
# of it, so a few long rows still spread over the card's SMs (a 4096- or
# 4320-column row stays whole)
_CHUNK = 8192


class Plan(NamedTuple):
    """K6's view of a block as ``x[batch, nz, ny, nx]``, detrended over its
    ``naxes`` trailing axes: ``nz = 1`` unless over three, ``ny = 1`` over
    the trailing axis alone; ``cz0``, ``cy0``, ``cx0`` the centred
    coordinates of the block's first plane, row and column (0 where that
    axis is not detrended); ``order`` the plain version's trend parts, its
    fitted axes in the order it subtracts them, 2 bits each from the lowest
    (1 z, 2 y, 3 x; 0 the mean alone), the first part carrying the mean;
    ``n_el`` the values of a field; ``css_z``, ``css_y``,
    ``css_x`` the fit's sums of squares (0 where that axis is not fitted);
    ``wlast`` the window factor multiplied last, that of the first
    detrended axis (0 z, 1 y, 2 x), as the plain version's product of the
    1-D factors takes it; 0 over fewer than three axes, z's factor being
    1 there."""
    batch: int
    nz: int
    ny: int
    nx: int
    cz0: float
    cy0: float
    cx0: float
    order: int
    n_el: float
    css_z: float
    css_y: float
    css_x: float
    naxes: int
    wlast: int

    @property
    def moments(self) -> int:
        """The moments a field: S, Y, X, and Z over three axes."""
        return 4 if self.naxes == 3 else 3


def _css(n: int, n_el: int) -> float:
    """The plain version's sum of squares of axis n's centred coordinate
    over a field of n_el values."""
    c64 = np.arange(n) - (n - 1) / 2.0
    return float(np.sum(c64 ** 2)) * (n_el / n)


def plan(shape, local_shape, axes, linear: bool, lo) -> Plan:
    """The plan of a detrend over ``axes`` (the trailing axis, or the two
    or three trailing ones in any order) of data of global ``shape`` whose
    block here has ``local_shape`` and starts at global index ``lo[a]`` of
    each axis ``a`` in ``axes``."""
    nd, k = len(shape), len(axes)
    plane, row, col = nd - 3, nd - 2, nd - 1
    n_el = math.prod(shape[a] for a in axes)
    fitted = [a for a in axes if shape[a] > 1] if linear else []
    code = {plane: 1, row: 2, col: 3}

    def c0(a):
        return lo[a] - (shape[a] - 1) / 2.0 if a in axes else 0.0

    def css(a):
        return _css(shape[a], n_el) if a in fitted else 0.0

    return Plan(
        batch=math.prod(local_shape[:nd - k]),
        nz=local_shape[plane] if k == 3 else 1,
        ny=local_shape[row] if k >= 2 else 1, nx=local_shape[col],
        cz0=c0(plane), cy0=c0(row), cx0=c0(col),
        order=sum(code[a] << 2 * i for i, a in enumerate(fitted)),
        n_el=float(n_el), css_z=css(plane), css_y=css(row), css_x=css(col),
        naxes=k, wlast=code[axes[0]] - 1 if k == 3 else 0)


def chunking(nx: int) -> tuple[int, int]:
    """(chunks a row, columns a chunk) of rows of ``nx`` columns: whole
    rows up to _CHUNK columns, longer ones cut into chunks of _CHUNK, the
    last shorter."""
    return -(-nx // _CHUNK), min(nx, _CHUNK)


# the kernel's trend shapes (``Trend::kind``): the fitted axes in the order
# subtracted, x the column's slope, r a row's z or y term
_KINDS = ("", "r", "rr", "x", "xr", "xrr", "rx", "rxr", "rrx")


def trend_code(order: int) -> tuple[int, int]:
    """The apply kernel's trend of a :class:`Plan`'s ``order``, the one
    place it is decoded: ``(kind, zfirst)``, ``kind`` the index of its shape
    in ``_KINDS`` (0 the mean alone), ``zfirst`` 1 where its first row term
    is z's (else y's, and the second, if any, z's)."""
    axes = []
    while order:
        axes.append(order & 3)
        order >>= 2
    rows = [a for a in axes if a != 3]
    kind = _KINDS.index("".join("x" if a == 3 else "r" for a in axes))
    return kind, int(rows[:1] == [1])


_P, _I, _D, _L = (ctypes.c_void_p, ctypes.c_int, ctypes.c_double,
                  ctypes.c_longlong)
_ARGS = {
    # x, part, mom, B, NZ, NY, NX, nchunks, cw, nmom, cz0, cy0, cx0, stream
    "k6_moments": [_P, _P, _P, _L, _I, _I, _I, _I, _I, _I, _D, _D, _D, _P],
    # x, out, mom, wz, wy, wx, B, NZ, NY, NX, nchunks, cw, cz0, cy0, cx0,
    # kind, zfirst, wlast, n_el, css_z, css_y, css_x, vec, stream
    "k6_apply": [_P, _P, _P, _P, _P, _P, _L, _I, _I, _I, _I, _I, _D, _D, _D,
                 _I, _I, _I, _D, _D, _D, _D, _I, _P],
}
_fns: dict = {}


def _fn(name: str):
    fn = _fns.get(name)
    if fn is None:
        from ._build import load

        fn = getattr(load("prologue"), name)
        fn.argtypes = _ARGS[name.rsplit("_", 1)[0]]
        fn.restype = ctypes.c_int
        _fns[name] = fn
    return fn


def _check(err: int, what: str):
    if err:
        raise RuntimeError(f"K6 {what} launch failed: CUDA error {err}")


def _ptr(w):
    return None if w is None else w.data_ptr()


def detrend_window(x: torch.Tensor, p: Plan, wz=None, wy=None, wx=None,
                   reduce=None) -> torch.Tensor:
    """K6 on the block ``x`` (CUDA, float32 or float64, contiguous, viewed
    as ``[p.batch, p.nz, p.ny, p.nx]``): the trend of ``p`` removed and the
    window's factors ``wz[p.nz]``, ``wy[p.ny]``, ``wx[p.nx]`` (x's dtype, or
    None) applied, in x's dtype.  ``reduce(mom)`` sums the float64 moments
    ``[3, B]`` (``[4, B]`` over three axes) in place over the ranks that
    hold the field's other blocks, between the moments (two launches) and
    the subtraction (one)."""
    if x.device.type != "cuda" or x.dtype not in _SUFFIX \
            or not x.is_contiguous():
        raise ValueError(f"K6 takes a contiguous float32/float64 CUDA "
                         f"tensor, got {x.dtype} on {x.device}")
    sfx = _SUFFIX[x.dtype]
    out = torch.empty_like(x, memory_format=torch.contiguous_format)
    batch, rows = p.batch, p.batch * p.nz * p.ny
    nchunks, cw = chunking(p.nx)
    launch = rows * p.nx > 0
    stream = torch.cuda.current_stream(x.device).cuda_stream
    with torch.cuda.device(x.device):
        mom = (torch.empty if launch else torch.zeros)(
            (p.moments, batch), dtype=torch.float64, device=x.device)
        if launch:
            part = torch.empty((rows * nchunks, 2), dtype=torch.float64,
                               device=x.device)
            _check(_fn(f"k6_moments_{sfx}")(
                x.data_ptr(), part.data_ptr(), mom.data_ptr(), batch, p.nz,
                p.ny, p.nx, nchunks, cw, p.moments, p.cz0, p.cy0, p.cx0,
                stream), "moments")
            detrend_window.launches += 2
            del part
        if reduce is not None:
            reduce(mom)
        if launch:
            vec = int(x.data_ptr() % 16 == out.data_ptr() % 16)
            _check(_fn(f"k6_apply_{sfx}")(
                x.data_ptr(), out.data_ptr(), mom.data_ptr(), _ptr(wz),
                _ptr(wy), _ptr(wx), batch, p.nz, p.ny, p.nx, nchunks, cw,
                p.cz0, p.cy0, p.cx0, *trend_code(p.order), p.wlast, p.n_el,
                p.css_z, p.css_y, p.css_x, vec, stream), "apply")
            detrend_window.launches += 1
    return out


detrend_window.launches = 0
