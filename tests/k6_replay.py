"""K6's arithmetic (``xrft_tpu_torch/csrc/prologue.cu``) replayed in torch
on the host, for the CPU tests of its wrapper: the plan and metadata of
``detrend._k6``, with the kernel's launch replaced by :func:`k6_replay`.
Imports torch and xrft_tpu_torch only, so the gloo ranks of
``torch_dist_cases`` can install it too (:func:`install`)."""

import importlib

import torch

from xrft_tpu_torch.ops import prologue

F64 = torch.float64


def _trend(v, p, mom, cz, cy, cx):
    """v (float64, [B, nz, ny, nx]) less the trend of ``p``: the kernel's
    float64 operations in its order, each rounded on its own, from the
    trend ``prologue.trend_code`` derives from ``p.order`` (a sum of
    squares of 0: that axis is not fitted)."""
    kind, zfirst = prologue.trend_code(p.order)

    def field(m):
        return m[:, None, None, None]

    def slope(m, css):
        return field(mom[m] / css) if css else 0.0

    mean = field(mom[0] / p.n_el)
    tz, ty = slope(3, p.css_z) * cz, slope(1, p.css_y) * cy
    ax = slope(2, p.css_x) * cx
    ra, rb = (tz, ty) if zfirst else (ty, tz)
    m0, mx = mean + ra, mean + ax
    return [lambda: v - mean, lambda: v - m0, lambda: (v - m0) - rb,
            lambda: v - mx, lambda: (v - mx) - ra,
            lambda: ((v - mx) - ra) - rb, lambda: (v - m0) - ax,
            lambda: ((v - m0) - ax) - rb,
            lambda: ((v - m0) - rb) - ax][kind]()


def k6_replay(x, p, wz=None, wy=None, wx=None, reduce=None):
    """K6 on the host, for :func:`~xrft_tpu_torch.ops.prologue.
    detrend_window`'s arguments: the moments in float64 in another order
    than the plain version's, then, per value, the kernel's float64
    operations in its order, each rounded on its own, one rounding to x's
    dtype, and the window's product in it: the factors of the last two
    axes first, that of the first (``p.wlast``) last, a missing factor 1."""
    v = x.reshape(p.batch, p.nz, p.ny, p.nx).double()
    cz = p.cz0 + torch.arange(p.nz, dtype=F64)[:, None, None]
    cy = p.cy0 + torch.arange(p.ny, dtype=F64)[:, None]
    cx = p.cx0 + torch.arange(p.nx, dtype=F64)
    rows = v.sum(3, keepdim=True)
    mom = torch.stack([rows.sum((1, 2, 3)), (rows * cy).sum((1, 2, 3)),
                       (v * cx).sum((1, 2, 3)), (rows * cz).sum((1, 2, 3))])
    mom = mom[:p.moments].contiguous()
    if reduce is not None:
        reduce(mom)
    r = _trend(v, p, mom, cz, cy, cx).to(x.dtype)
    if wx is not None:
        one = torch.ones((), dtype=x.dtype)
        wz = one if wz is None else wz[:, None, None]
        wy = one if wy is None else wy[:, None]
        first, last = {0: (wy * wx, wz), 1: (wz * wx, wy),
                       2: (wz * wy, wx)}[p.wlast]
        r = r * (first * last)
    k6_replay.launches += 3
    return r.reshape(x.shape)


k6_replay.launches = 0


def install(setattr_):
    """Route the prologue through K6's wrapper on the CPU: ``k6_takes``
    asked as for a CUDA tensor, the kernel's launch replaced by
    :func:`k6_replay`; ``setattr_(obj, name, value)`` installs each (a
    monkeypatch's, or a plain one that the caller undoes)."""
    det = importlib.import_module("xrft_tpu_torch.detrend")
    real = det.k6_takes
    setattr_(det, "k6_takes",
             lambda dtype, device, *a: real(dtype, "cuda", *a))
    setattr_(prologue, "detrend_window", k6_replay)
    k6_replay.launches = 0
    return k6_replay
