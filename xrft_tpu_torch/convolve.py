"""N-D convolution and cross-correlation along named dims.

Counterpart of ``xrft_tpu/convolve.py``, with ``scipy.signal``'s semantics:
linear convolution with ``full``/``same``/``valid`` output cropping,
real-in/real-out, correlation as convolution with the conjugate-reversed
second operand, and the method dispatch of ``scipy.signal.convolve``.

* **FFT route** (:func:`fftconvolve`): both operands are zero-padded to the
  next power of two >= ``n1 + n2 - 1`` per dim, transformed with one N-D
  :mod:`.ops.fft_core` FFT each (cuFFT, K2/K4 or the matmul engine, by
  ``config.fft_impl``), multiplied and inverse-transformed.
* **Overlap-add** (:func:`oaconvolve`): one long dim cut into blocks that
  are transformed at a small size as a batch axis; real data take
  ``rfftn``/``irfftn``.
* **Direct route** (``method="direct"``): one ``torch.nn.functional.conv``
  over the batch folded into N with one channel, the kernel flipped for
  convolution and conjugated for correlation, inside ``config.full_fp32``
  (cuDNN runs float32 convolutions in TF32 by default).  Up to three dims
  that is one cuDNN call; a fourth or later leading dim is a sum over the
  kernel's first axis of the convolutions of one dim fewer.

Coordinate-aware beyond scipy: when both operands carry equispaced
coordinates of matching spacing on a transform dim, the output carries the
support ``x0 + y0 + k*dx`` (convolution) or the lag
``x0 - y0 + (k - (n2-1))*dx`` (correlation).
"""

from __future__ import annotations

import time

import numpy as np
import torch
import torch.nn.functional as F

from . import coords as ce
from .config import config, engine_impl, full_fp32
from .dtypes import promote
from .labeled import Coord, LabeledArray
from .ops import fft_core

__all__ = ["convolve", "fftconvolve", "oaconvolve", "correlate",
           "choose_conv_method"]


def _norm_dims(da, db, dims, caller):
    if dims is None:
        out = [d for d in da.dims if d in db.dims]
        if not out:
            raise ValueError(f"{caller}: the operands share no dims")
        return out
    if isinstance(dims, str):
        dims = [dims]
    dims = list(dims)
    for d in dims:
        if d not in da.dims or d not in db.dims:
            raise ValueError(
                f"{caller}: dim {d!r} must be present in both operands")
    return dims


def _align_second(da, db, caller):
    """db's data permuted and reshaped to da's dim order (size-1 axes for
    dims db lacks).  Extra dims in db are not allowed."""
    extra = [d for d in db.dims if d not in da.dims]
    if extra:
        raise ValueError(
            f"{caller}: second operand has dims {extra} not present in "
            "the first; transpose/rename it first")
    perm = [db.dims.index(d) for d in da.dims if d in db.dims]
    data = db.data.permute(perm)
    return data.reshape([db.sizes[d] if d in db.dims else 1
                         for d in da.dims])


def _crop_window(mode, n1, n2, caller):
    """Start offset and length of the mode crop of the full (n1+n2-1)
    linear result, per scipy.signal conventions."""
    full = n1 + n2 - 1
    if mode == "full":
        return 0, full
    if mode == "same":
        return (full - n1) // 2, n1
    if mode == "valid":
        return min(n1, n2) - 1, max(n1, n2) - min(n1, n2) + 1
    raise ValueError(
        f"{caller}: mode must be 'full', 'same' or 'valid', got {mode!r}")


def _pad_end(x, widths):
    """Zero-pad ``x`` at the end of each axis by ``widths[axis]``."""
    return F.pad(x, [w for a in reversed(widths) for w in (0, a)])


def _next_pow2(n: int) -> int:
    return 1 << int(np.ceil(np.log2(max(n, 1))))


def _fft_convolve(u, v, axes, sizes1, sizes2):
    """ifft(fft(u)*fft(v)) zero-padded to the next power of two >=
    n1+n2-1 per axis; returns the padded result (the caller crops)."""
    pad_u = [0] * u.ndim
    pad_v = [0] * v.ndim
    for ax, n1, n2 in zip(axes, sizes1, sizes2):
        L = _next_pow2(n1 + n2 - 1)
        pad_u[ax] = L - n1
        pad_v[ax] = L - v.shape[ax]
    U = fft_core.fftn(_pad_end(u, pad_u), axes)
    V = fft_core.fftn(_pad_end(v, pad_v), axes)
    return fft_core.ifftn(U * V, axes)


def _single(*das):
    """The operands with data of less than single precision (float16,
    complex32) in float32 or complex64, before any operation."""
    return [d.copy(data=promote(d.data, "numpy"))
            if d.data.is_floating_point() or d.data.is_complex() else d
            for d in das]


def _reversed_kernel(v, axes):
    """The correlation's second operand: reversed along ``axes`` and
    conjugated (a physical conjugate: the kernels read raw memory)."""
    v = v.flip(axes)
    return v.conj_physical() if v.is_complex() else v


def _conv_like(da, db, dims, mode, engine, caller, reverse):
    da, db = _single(da, db)
    dims = _norm_dims(da, db, dims, caller)
    axes = [da.dims.index(d) for d in dims]
    sizes1 = [da.sizes[d] for d in dims]
    sizes2 = [db.sizes[d] for d in dims]
    for d, n in zip(dims, sizes2):
        if d in db.coords and db.coords[d].values.shape[0] != n:
            raise ValueError(f"{caller}: inconsistent coord on {d!r}")
    for d in da.dims:
        if d in db.dims and d not in dims and da.sizes[d] != db.sizes[d]:
            raise ValueError(
                f"{caller}: non-transform dim {d!r} has mismatched sizes "
                f"{da.sizes[d]} != {db.sizes[d]}")
    if mode == "valid" and not (all(a >= b for a, b in zip(sizes1, sizes2))
                                or all(b >= a
                                       for a, b in zip(sizes1, sizes2))):
        raise ValueError(
            f"{caller}: for mode='valid' one operand must be at least as "
            "large as the other in every transform dim")

    real_out = not da.data.is_complex() and not db.data.is_complex()
    v = _align_second(da, db, caller)
    if reverse:
        v = _reversed_kernel(v, axes)
    with engine_impl(engine):
        y = _fft_convolve(da.data, v, axes, sizes1, sizes2)

    starts = {}
    for ax, d, n1, n2 in zip(axes, dims, sizes1, sizes2):
        start, length = _crop_window(mode, n1, n2, caller)
        y = y.narrow(ax, start, length)
        starts[d] = (start, length)
    if real_out:
        y = y.real

    coords = _conv_coords(da, db, dims, sizes2, starts, reverse)
    return LabeledArray(y, dims=list(da.dims), coords=coords,
                        attrs=dict(da.attrs), name=da.name)


def _conv_coords(da, db, dims, sizes2, starts, reverse):
    """Output coords: pass-through off-transform coords plus, where both
    operands carry matching-spacing numeric grids, the physical support
    (convolution) or lag (correlation) grid."""
    coords = {k: c.copy() for k, c in da.coords.items()
              if not any(d in c.dims for d in dims)}
    for d, n2 in zip(dims, sizes2):
        start, length = starts[d]
        ca, cb = da.coords.get(d), db.coords.get(d)
        if (ca is not None and cb is not None
                and ce.is_valid_fft_coord(ca) and ce.is_valid_fft_coord(cb)
                and np.issubdtype(np.asarray(ca.values).dtype, np.number)
                and np.issubdtype(np.asarray(cb.values).dtype, np.number)):
            # a single-point operand has no spacing of its own: it lies on
            # any grid, so the other operand's spacing rules
            na = np.asarray(ca.values).shape[0]
            nb = np.asarray(cb.values).shape[0]
            dxa = ce.first_diff(ca) if na > 1 else None
            dxb = ce.first_diff(cb) if nb > 1 else None
            dx = dxa if dxa is not None else dxb
            if dx is not None and (dxa is None or dxb is None
                                   or np.isclose(dxa, dxb, rtol=1e-6)):
                x0 = np.asarray(ca.values).flat[0]
                y0 = np.asarray(cb.values).flat[0]
                if reverse:  # correlation lag: x grid minus y grid
                    origin = x0 - y0 - (n2 - 1) * dx
                else:  # convolution support: sum of the grids' origins
                    origin = x0 + y0
                coords[d] = Coord(
                    (d,), origin + (start + np.arange(length)) * dx,
                    {"spacing": dx}, d)
    return coords


def fftconvolve(da, db, dims=None, mode="full", engine=None):
    """N-D linear convolution of ``da`` with ``db`` along ``dims``
    (default: all shared dims) — ``scipy.signal.fftconvolve``.  ``db``'s
    dims must be a subset of ``da``'s; missing dims broadcast.  ``mode`` is
    scipy's ``full`` / ``same`` / ``valid``.  Real inputs give real output.
    With matching-spacing coordinates on a dim the output coordinate is the
    support grid ``x0 + y0 + k*dx``; otherwise the dim is index-based."""
    return _conv_like(da, db, dims, mode, engine, "fftconvolve",
                      reverse=False)


def oaconvolve(da, db, dims=None, mode="full", engine=None):
    """Overlap-add linear convolution of ``da`` with ``db`` along ONE dim —
    ``scipy.signal.oaconvolve``: the values of :func:`fftconvolve`, with
    the long signal split into blocks of ``step = nfft - (n2-1)`` samples,
    each transformed at the small size ``nfft`` as a batch axis, the
    kernel's spectrum computed once, and the overlap-add two slices and an
    add.  Real operands take ``rfftn``/``irfftn`` (under ``"matmul"`` the
    stacked rfft and the pair engine's packed irfft).  Falls back to :func:`fftconvolve`'s
    single transform when the kernel is not much shorter than the signal."""
    da, db = _single(da, db)
    dims_l = _norm_dims(da, db, dims, "oaconvolve")
    if len(dims_l) != 1:
        raise ValueError(
            "oaconvolve blocks a single long dim; got "
            f"dims={dims_l!r} (use fftconvolve for N-D convolution)")
    d = dims_l[0]
    ax = da.dims.index(d)
    n1, n2 = da.sizes[d], db.sizes[d]
    # validate before any device work, as _conv_like does
    _crop_window(mode, n1, n2, "oaconvolve")
    if d in db.coords and db.coords[d].values.shape[0] != n2:
        raise ValueError(f"oaconvolve: inconsistent coord on {d!r}")
    for dd in da.dims:
        if dd in db.dims and dd != d and da.sizes[dd] != db.sizes[dd]:
            raise ValueError(
                f"oaconvolve: non-transform dim {dd!r} has mismatched "
                f"sizes {da.sizes[dd]} != {db.sizes[dd]}")

    full = n1 + n2 - 1
    nfft = _next_pow2(max(8 * (n2 - 1), 256))
    if n2 <= 1 or nfft >= _next_pow2(full):
        # kernel not much shorter than the signal (or trivial): the single
        # full-size transform is cheaper, as scipy falls back
        return _conv_like(da, db, dims_l, mode, engine, "oaconvolve",
                          reverse=False)
    step = nfft - (n2 - 1)
    nb = -(-n1 // step)

    real_out = not da.data.is_complex() and not db.data.is_complex()
    fwd, inv = ((fft_core.rfftn, fft_core.irfftn) if real_out
                else (fft_core.fftn, fft_core.ifftn))
    x = da.data.movedim(ax, -1)
    v = _align_second(da, db, "oaconvolve").movedim(ax, -1)
    v = F.pad(v, [0, nfft - n2]).unsqueeze(-2)          # [..., 1, nfft]
    # signal blocks [..., nb, step], zero-padded to [..., nb, nfft]
    x = F.pad(x, [0, nb * step - n1])
    x = F.pad(x.reshape(x.shape[:-1] + (nb, step)), [0, nfft - step])
    with engine_impl(engine):
        y = inv(fwd(x, [-1]) * fwd(v, [-1]), [-1])

    # overlap-add: block k's tail (n2-1 <= step wide) lands in block k+1's
    # head; a zero block after the last holds the final tail
    heads = F.pad(y[..., :step], [0, 0, 0, 1])
    tails = F.pad(y[..., step:], [0, step - (nfft - step), 1, 0])
    out = (heads + tails).reshape(y.shape[:-2] + ((nb + 1) * step,))

    start, length = _crop_window(mode, n1, n2, "oaconvolve")
    out = out.narrow(-1, start, length)
    if real_out:
        out = out.real
    out = out.movedim(-1, ax)
    coords = _conv_coords(da, db, [d], [n2], {d: (start, length)},
                          reverse=False)
    return LabeledArray(out, dims=list(da.dims), coords=coords,
                        attrs=dict(da.attrs), name=da.name)


def correlate(da, db, dims=None, mode="full", engine=None, method="fft"):
    """N-D cross-correlation ``sum da[t+k] * conj(db[t])`` along ``dims``
    — ``scipy.signal.correlate``: convolution with the conjugate-reversed
    second operand.  ``method`` is scipy's: ``'fft'`` (the default here),
    ``'direct'`` (one cuDNN convolution, see :func:`convolve`) or ``'auto'``
    (:func:`choose_conv_method`).  With matching-spacing coordinates the
    output carries the lag grid ``x0 - y0 + (k-(n2-1))*dx``."""
    return _method_dispatch(da, db, dims, mode, engine, method,
                            "correlate", reverse=True)


def _direct_eligible(da, db, dims, mode, sizes1, sizes2):
    """Static eligibility of the direct route (None, or why it is not)."""
    if any(d not in dims for d in db.dims):
        return "the kernel has non-transform (batch) dims"
    if any(n2 > n1 for n1, n2 in zip(sizes1, sizes2)):
        return "the kernel is larger than the data on a transform dim"
    return None


_CONV = {1: F.conv1d, 2: F.conv2d, 3: F.conv3d}


def _correlate_valid(u, v):
    """The 'valid' cross-correlation of every row of ``u`` (B, *spatial)
    with ``v`` (*kernel): one cuDNN convolution for up to three dims, and
    for more a sum over the kernel's first axis of the correlations of one
    dim fewer, that axis's windows folded into the batch."""
    if v.ndim <= 3:
        return _CONV[v.ndim](u.unsqueeze(1), v[None, None]).squeeze(1)
    span = u.shape[1] - v.shape[0] + 1
    out = 0
    for j in range(v.shape[0]):
        part = u.narrow(1, j, span)
        r = _correlate_valid(part.reshape((-1,) + part.shape[2:]), v[j])
        out = out + r.reshape(part.shape[:2] + r.shape[1:])
    return out


def _direct_conv(da, db, dims, mode, caller, reverse):
    """The mode-cropped linear convolution/correlation on the direct
    route (cross-correlation semantics: the kernel is flipped for
    convolution, conjugated for correlation).  The caller guarantees
    :func:`_direct_eligible`.  Integer and bool operands convolve in
    float64 (cuDNN has no integer convolution), exact while the sums stay
    below 2**53, and return in their dtype as numpy's direct convolution
    does: integers wrapped, bool as "any product"."""
    da, db = _single(da, db)
    exact = None
    if not any(d.data.is_floating_point() or d.data.is_complex()
               for d in (da, db)):
        exact = torch.result_type(da.data, db.data)
        da, db = (d.copy(data=d.data.double()) for d in (da, db))
    axes = [da.dims.index(d) for d in dims]
    sizes1 = [da.sizes[d] for d in dims]
    sizes2 = [db.sizes[d] for d in dims]
    for d, n in zip(dims, sizes2):
        if d in db.coords and db.coords[d].values.shape[0] != n:
            raise ValueError(f"{caller}: inconsistent coord on {d!r}")

    # per-axis (lo, hi) zero padding reproducing scipy's mode crops of the
    # full linear result: full -> (n2-1, n2-1); same -> the centred window
    # (lo = n2//2, so output k == full[k + (n2-1)//2]); valid -> none
    pads, starts = [], {}
    for d, n1, n2 in zip(dims, sizes1, sizes2):
        starts[d] = _crop_window(mode, n1, n2, caller)
        pads.append({"full": (n2 - 1, n2 - 1), "valid": (0, 0),
                     "same": (n2 // 2, (n2 - 1) // 2)}[mode])

    real_out = not da.data.is_complex() and not db.data.is_complex()
    v = db.data.permute([db.dims.index(d) for d in dims])
    if not reverse:
        v = v.flip(tuple(range(len(dims))))
    elif v.is_complex():
        v = v.conj_physical()

    # the batch dims first, folded into one; the transform dims after
    bperm = [q for q in range(da.data.ndim) if q not in axes] + axes
    inv = list(np.argsort(bperm))
    nb = len(bperm) - len(axes)
    flat_pads = [p for pair in reversed(pads) for p in pair]

    def conv1(u, w):
        ub = u.permute(bperm)
        bshape = ub.shape[:nb]
        lhs = F.pad(ub.reshape((-1,) + ub.shape[nb:]), flat_pads)
        o = _correlate_valid(lhs, w)
        return o.reshape(bshape + o.shape[1:]).permute(inv)

    u = da.data
    with full_fp32():
        y = conv1(u.real, v.real)
        if not real_out:   # complex: four (or two) real convolutions
            ui = u.imag if u.is_complex() else None
            vi = v.imag if v.is_complex() else None
            if ui is not None and vi is not None:
                y = y - conv1(ui, vi)
            im = [conv1(u.real, vi)] if vi is not None else []
            im += [conv1(ui, v.real)] if ui is not None else []
            y = torch.complex(y, sum(im))
    if exact is not None:
        y = y != 0 if exact == torch.bool else y.round().long().to(exact)

    coords = _conv_coords(da, db, dims, sizes2, starts, reverse)
    return LabeledArray(y, dims=list(da.dims), coords=coords,
                        attrs=dict(da.attrs), name=da.name)


def _method_dispatch(da, db, dims, mode, engine, method, caller, reverse):
    dims_l = _norm_dims(da, db, dims, caller)
    sizes1 = [da.sizes[d] for d in dims_l]
    sizes2 = [db.sizes[d] for d in dims_l]
    if method == "auto":
        method = choose_conv_method(da, db, dims=dims_l, mode=mode)
    if method == "direct":
        why = _direct_eligible(da, db, dims_l, mode, sizes1, sizes2)
        if why is not None:
            raise ValueError(
                f"{caller}: method='direct' is unavailable here ({why}); "
                "use method='fft'")
        return _direct_conv(da, db, dims_l, mode, caller, reverse)
    if method != "fft":
        raise ValueError(
            f"{caller}: method must be 'auto', 'direct' or 'fft', "
            f"got {method!r}")
    return _conv_like(da, db, dims_l, mode, engine, caller, reverse)


def choose_conv_method(da, db, dims=None, mode="full", measure=False):
    """Pick ``'direct'`` or ``'fft'`` for :func:`convolve` /
    :func:`correlate` — ``scipy.signal.choose_conv_method``: a kernel of at
    most ``config.direct_conv_max`` elements takes the direct route (the
    crossover measured on the card by ``chip_smoke.py``).  ``measure=True``
    times both methods on the actual operands (after a warm-up call, each
    ended by ``torch.cuda.synchronize()`` on a CUDA device) and returns the
    faster, as scipy does.  A pair the direct route cannot take returns
    ``'fft'``; any failure of a method raises."""
    dims_l = _norm_dims(da, db, dims, "choose_conv_method")
    sizes1 = [da.sizes[d] for d in dims_l]
    sizes2 = [db.sizes[d] for d in dims_l]
    if _direct_eligible(da, db, dims_l, mode, sizes1, sizes2) is not None:
        return "fft"
    if measure:
        sync = (torch.cuda.synchronize if da.data.is_cuda
                else (lambda: None))
        best, best_s = "fft", np.inf
        for m in ("fft", "direct"):
            def run(meth=m):
                _method_dispatch(da, db, dims_l, mode, None, meth,
                                 "choose_conv_method", False)
            run()
            sync()
            t0 = time.perf_counter()
            run()
            sync()
            s = time.perf_counter() - t0
            if s < best_s:
                best, best_s = m, s
        return best
    return "direct" if int(np.prod(sizes2)) <= config.direct_conv_max \
        else "fft"


def convolve(da, db, dims=None, mode="full", method="auto", engine=None):
    """N-D linear convolution along named dims with method dispatch —
    ``scipy.signal.convolve``: ``method='fft'`` is :func:`fftconvolve`;
    ``method='direct'`` computes the mode-cropped sum as one cuDNN
    convolution at full float32 grade (no padded transforms; the kernel
    must span only transform dims); ``method='auto'`` picks with
    :func:`choose_conv_method`.  Modes, kernel broadcasting over batch dims
    (fft method), real/complex kinds and coordinate-aware output grids
    match :func:`fftconvolve`."""
    return _method_dispatch(da, db, dims, mode, engine, method,
                            "convolve", reverse=False)
