"""K6: the detrend-and-window prologue (``csrc/prologue.cu``).

Launched only by :func:`xrft_tpu_torch.detrend.detrend_and_window`, which
decides by dtype, device and axes which stacks it takes and keeps the plain
version, ``detrend._detrended`` followed by ``ops/window.apply_window``, for
the rest (and as its oracle).  :class:`Plan` holds the host's part: the
block's geometry, which trend parts are fitted in which order, and the
sums of squares of the centred coordinates, as the plain version computes
them.
"""

from __future__ import annotations

import ctypes
import math
from typing import NamedTuple

import numpy as np
import torch

__all__ = ["Plan", "plan", "chunking", "detrend_window"]

_SUFFIX = {torch.float32: "f32", torch.float64: "f64"}
# the most columns of a row one warp takes: a longer row is cut into chunks
# of it, so a few long rows still spread over the card's SMs (a 4096- or
# 4320-column row stays whole)
_CHUNK = 8192


class Plan(NamedTuple):
    """K6's view of a block as ``x[batch, ny, nx]``: ``ny = 1`` for a
    detrend over the trailing axis alone; ``cy0``, ``cx0`` the centred coordinates of
    the block's first row and column; ``parts`` the kernel's code of the
    plain version's trend parts (0 the mean; 1 and 2 the mean with the row's
    or the column's slope; 3 the row's first, 4 the column's first);
    ``n_el`` the values of a field; ``css_y``, ``css_x`` the fit's sums of
    squares (0 where that axis is not fitted)."""
    batch: int
    ny: int
    nx: int
    cy0: float
    cx0: float
    parts: int
    n_el: float
    css_y: float
    css_x: float


def _css(n: int, n_el: int) -> float:
    """The plain version's sum of squares of axis n's centred coordinate
    over a field of n_el values."""
    c64 = np.arange(n) - (n - 1) / 2.0
    return float(np.sum(c64 ** 2)) * (n_el / n)


def plan(shape, local_shape, axes, linear: bool, lo) -> Plan:
    """The plan of a detrend over ``axes`` (the trailing axis, or the two
    trailing ones in either order) of data of global ``shape`` whose block
    here has ``local_shape`` and starts at global index ``lo[a]`` of each
    axis ``a`` in ``axes``."""
    nd = len(shape)
    row, col = nd - 2, nd - 1
    two = len(axes) == 2
    n_el = math.prod(shape[a] for a in axes)
    fitted = [a for a in axes if shape[a] > 1] if linear else []
    parts = {(): 0, (row,): 1, (col,): 2, (row, col): 3,
             (col, row): 4}[tuple(fitted)]
    return Plan(
        batch=math.prod(local_shape[:row if two else col]),
        ny=local_shape[row] if two else 1, nx=local_shape[col],
        cy0=lo[row] - (shape[row] - 1) / 2.0 if two else 0.0,
        cx0=lo[col] - (shape[col] - 1) / 2.0,
        parts=parts, n_el=float(n_el),
        css_y=_css(shape[row], n_el) if row in fitted else 0.0,
        css_x=_css(shape[col], n_el) if col in fitted else 0.0)


def chunking(nx: int) -> tuple[int, int]:
    """(chunks a row, columns a chunk) of rows of ``nx`` columns: whole
    rows up to _CHUNK columns, longer ones cut into chunks of _CHUNK, the
    last shorter."""
    return -(-nx // _CHUNK), min(nx, _CHUNK)


_P, _I, _D = ctypes.c_void_p, ctypes.c_int, ctypes.c_double
# x, part, mom, B, NY, NX, nchunks, cw, cy0, cx0, stream
_MOMENTS_ARGS = [_P, _P, _P, ctypes.c_longlong, _I, _I, _I, _I, _D, _D, _P]
# x, out, mom, wy, wx, B, NY, NX, nchunks, cw, cy0, cx0, parts, n_el,
# css_y, css_x, vec, stream
_APPLY_ARGS = [_P, _P, _P, _P, _P, ctypes.c_longlong, _I, _I, _I, _I, _D, _D,
               _I, _D, _D, _D, _I, _P]
_fns: dict = {}


def _fn(name: str):
    fn = _fns.get(name)
    if fn is None:
        from ._build import load

        fn = getattr(load("prologue"), name)
        fn.argtypes = _MOMENTS_ARGS if name.startswith("k6_moments") \
            else _APPLY_ARGS
        fn.restype = ctypes.c_int
        _fns[name] = fn
    return fn


def _check(err: int, what: str):
    if err:
        raise RuntimeError(f"K6 {what} launch failed: CUDA error {err}")


def detrend_window(x: torch.Tensor, p: Plan, wy=None, wx=None,
                   reduce=None) -> torch.Tensor:
    """K6 on the block ``x`` (CUDA, float32 or float64, contiguous, viewed
    as ``[p.batch, p.ny, p.nx]``): the trend of ``p`` removed and the window's
    factors ``wy[p.ny]``, ``wx[p.nx]`` (x's dtype, or None) applied, in x's
    dtype.  ``reduce(mom)`` sums the float64 moments ``[3, B]`` in place
    over the ranks that hold the field's other blocks, between the moments
    (two launches) and the subtraction (one)."""
    if x.device.type != "cuda" or x.dtype not in _SUFFIX \
            or not x.is_contiguous():
        raise ValueError(f"K6 takes a contiguous float32/float64 CUDA "
                         f"tensor, got {x.dtype} on {x.device}")
    sfx = _SUFFIX[x.dtype]
    out = torch.empty_like(x, memory_format=torch.contiguous_format)
    batch, rows = p.batch, p.batch * p.ny
    nchunks, cw = chunking(p.nx)
    launch = rows * p.nx > 0
    stream = torch.cuda.current_stream(x.device).cuda_stream
    with torch.cuda.device(x.device):
        if launch:
            mom = torch.empty((3, batch), dtype=torch.float64,
                              device=x.device)
            part = torch.empty((rows * nchunks, 2), dtype=torch.float64,
                               device=x.device)
            _check(_fn(f"k6_moments_{sfx}")(
                x.data_ptr(), part.data_ptr(), mom.data_ptr(), batch, p.ny,
                p.nx, nchunks, cw, p.cy0, p.cx0, stream), "moments")
            detrend_window.launches += 2
            del part
        else:
            mom = torch.zeros((3, batch), dtype=torch.float64,
                              device=x.device)
        if reduce is not None:
            reduce(mom)
        if launch:
            vec = int(x.data_ptr() % 16 == out.data_ptr() % 16)
            _check(_fn(f"k6_apply_{sfx}")(
                x.data_ptr(), out.data_ptr(), mom.data_ptr(),
                None if wy is None else wy.data_ptr(),
                None if wx is None else wx.data_ptr(), batch, p.ny, p.nx,
                nchunks, cw, p.cy0, p.cx0, p.parts, p.n_el, p.css_y, p.css_x,
                vec, stream), "apply")
            detrend_window.launches += 1
    return out


detrend_window.launches = 0
