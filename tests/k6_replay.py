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
    float64 operations in its order, each rounded on its own.  The fitted
    axes come in ``p.order``, 2 bits each (1 z, 2 y, 3 x), the first part
    with the mean."""
    mean = (mom[0] / p.n_el)[:, None, None, None]
    terms = []
    code = p.order
    while code:
        m, css, c = {1: (3, p.css_z, cz), 2: (1, p.css_y, cy),
                     3: (2, p.css_x, cx)}[code & 3]
        terms.append((mom[m] / css)[:, None, None, None] * c)
        code >>= 2
    if not terms:
        return v - mean
    d = v - (mean + terms[0])
    for t in terms[1:]:
        d = d - t
    return d


def k6_replay(x, p, wz=None, wy=None, wx=None, reduce=None):
    """K6 on the host, for :func:`~xrft_tpu_torch.ops.prologue.
    detrend_window`'s arguments: the moments in float64 in another order
    than the plain version's, then, per value, the kernel's float64
    operations in its order, each rounded on its own, one rounding to x's
    dtype, and the window's product in it."""
    v = x.reshape(p.batch, p.nz, p.ny, p.nx).double()
    cz = p.cz0 + torch.arange(p.nz, dtype=F64)[:, None, None]
    cy = p.cy0 + torch.arange(p.ny, dtype=F64)[:, None]
    cx = p.cx0 + torch.arange(p.nx, dtype=F64)
    rows = v.sum(3, keepdim=True)
    mom = torch.stack([rows.sum((1, 2, 3)), (rows * cy).sum((1, 2, 3)),
                       (v * cx).sum((1, 2, 3)), (rows * cz).sum((1, 2, 3))])
    mom = mom[:4 if p.naxes == 3 else 3].contiguous()
    if reduce is not None:
        reduce(mom)
    r = _trend(v, p, mom, cz, cy, cx).to(x.dtype)
    if wx is not None:
        if p.naxes < 3:
            w = wx if wy is None else wy[:, None] * wx
        else:
            wz, wy = wz[:, None, None], wy[:, None]
            first, last = {0: (wy * wx, wz), 1: (wz * wx, wy),
                           2: (wz * wy, wx)}[p.wlast]
            w = first * last
        r = r * w
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
