"""Pad and unpad a regular grid, extrapolating its coordinates.

Counterpart of ``xrft_tpu/padding.py``: the data are padded with numpy's
pad modes, the evenly spaced coordinates are extrapolated on the host with
the same spacing, and each padded coordinate records its ``pad_width`` in
its attrs so that :func:`unpad` can invert the pad by slicing.

Every mode pads on the data's device, the CPU included, so the CPU tests
run the code the card runs.  ``"constant"`` is ``torch.nn.functional.pad``;
the modes that only repeat elements (``"edge"``, ``"wrap"``, and
``"reflect"``/``"symmetric"`` with the even reflect type) gather an index
that numpy pads on the host.  The others repeat ``numpy.pad``'s own steps
in torch, axis by axis as numpy pads (so the corners come out as
numpy's): ``"linear_ramp"`` with ``numpy.linspace``'s formula and working
dtype, the statistic modes (``"maximum"``, ``"mean"``, ``"median"``,
``"minimum"``) over ``stat_length`` edge elements with numpy's rounding of
integer data, and the odd reflect type as numpy's chunk by chunk
``2 * edge - reflected``.
"""

from __future__ import annotations

import numpy as np
import torch

from .labeled import Coord, LabeledArray
from .utils import get_spacing

__all__ = ["pad", "unpad"]

# modes whose padded values are copies of the data's own elements
_INDEX_MODES = ("edge", "reflect", "symmetric", "wrap")
_STAT_MODES = ("maximum", "mean", "median", "minimum")


def _either_dict_or_kwargs(pos, kw, fname):
    if pos is not None:
        if kw:
            raise ValueError(
                f"cannot specify both keyword and positional arguments to "
                f"{fname}"
            )
        return dict(pos)
    return dict(kw)


def pad(
    da: LabeledArray,
    pad_width=None,
    mode="constant",
    stat_length=None,
    constant_values=0,
    end_values=None,
    reflect_type=None,
    **pad_width_kwargs,
) -> LabeledArray:
    """Pad ``da`` and extrapolate its evenly spaced coordinates
    (``xrft_tpu.pad``).

    ``pad_width``: mapping {dim: pad} or {dim: (before, after)}.  ``mode``
    is one of numpy's pad modes; ``stat_length``, ``constant_values``,
    ``end_values`` and ``reflect_type`` take numpy's values, or a mapping
    {dim: value | (before, after)}.
    """
    pad_width = _either_dict_or_kwargs(pad_width, pad_width_kwargs, "pad")
    _check_bad_coords(da, pad_width.keys())

    norm = {}
    for d, w in pad_width.items():
        if d not in da.dims:
            raise ValueError(f"pad dim {d!r} not in array dims {da.dims}")
        norm[d] = (w, w) if isinstance(w, int) else tuple(w)
    widths = [norm.get(d, (0, 0)) for d in da.dims]

    def _per_axis(value, defaults):
        """A per-dim mapping as numpy's per-axis ((before, after), ...)."""
        if not isinstance(value, dict):
            return value
        unknown = set(value) - set(da.dims)
        if unknown:
            raise ValueError(
                f"per-dim pad argument has unknown dims {sorted(unknown)}"
            )
        out = []
        for d, dflt in zip(da.dims, defaults):
            v = value.get(d, dflt)
            out.append(tuple(v) if isinstance(v, (tuple, list)) else (v, v))
        return tuple(out)

    kw = {}
    if mode == "constant":
        kw["constant_values"] = _per_axis(constant_values,
                                          [0] * len(da.dims))
    elif mode == "linear_ramp":
        kw["end_values"] = _per_axis(
            end_values if end_values is not None else 0, [0] * len(da.dims))
    elif mode in _STAT_MODES:
        if stat_length is not None:
            kw["stat_length"] = _per_axis(
                stat_length, [da.sizes[d] for d in da.dims])
    elif mode in ("reflect", "symmetric"):
        if reflect_type is not None:
            kw["reflect_type"] = reflect_type

    data = da.data
    if mode in ("constant", "empty"):
        # "empty" leaves numpy's pad area undefined: zeros are as good
        padded = _pad_constant(data, widths, kw.get("constant_values", 0))
    elif mode in _INDEX_MODES and kw.get("reflect_type", "even") == "even":
        padded = data
        for axis, w in enumerate(widths):
            if any(w):
                idx = np.pad(np.arange(data.shape[axis]), w, mode=mode)
                padded = padded.index_select(
                    axis, torch.as_tensor(idx, device=data.device))
    elif mode in ("reflect", "symmetric"):
        padded = data
        for axis, w in enumerate(widths):
            padded = _pad_odd_reflect(padded, axis, w, mode == "symmetric")
    elif mode == "linear_ramp":
        padded = data
        ends = _as_pairs(kw["end_values"], data.ndim)
        for axis, (w, e) in enumerate(zip(widths, ends)):
            padded = _pad_linear_ramp(padded, axis, w, e)
    elif mode in _STAT_MODES:
        padded = data
        lengths = _as_pairs(kw.get("stat_length"), data.ndim, as_index=True)
        for axis, (w, n) in enumerate(zip(widths, lengths)):
            padded = _pad_stat(padded, axis, w, n, mode)
    else:
        raise ValueError(f"mode {mode!r} is not supported")

    new_coords = {}
    for cname, c in da.coords.items():
        if cname in norm:
            spacing = get_spacing(c)
            before, after = norm[cname]
            vals = c.values.astype(np.result_type(c.values.dtype, np.float64)) \
                if before or after else c.values
            ext = np.concatenate([
                vals[0] - spacing * np.arange(before, 0, -1),
                vals,
                vals[-1] + spacing * np.arange(1, after + 1),
            ])
            attrs = dict(c.attrs)
            attrs["pad_width"] = pad_width[cname]
            new_coords[cname] = Coord(c.dims, ext, attrs, cname)
        else:
            new_coords[cname] = c.copy()

    return LabeledArray(padded, dims=da.dims, coords=new_coords,
                        attrs=da.attrs, name=da.name)


def _pad_constant(data, widths, fill):
    """numpy's constant pad on the data's device: one call for a scalar
    fill, else axis by axis in order, so that a later axis's fill takes the
    corners as in ``numpy.pad``."""
    if np.ndim(fill) == 0:
        flat = [w for pair in reversed(widths) for w in pair]
        return torch.nn.functional.pad(data, flat, value=fill)
    fills = np.broadcast_to(np.asarray(fill), (data.ndim, 2))
    for axis, (before, after) in enumerate(widths):
        lead = [0, 0] * (data.ndim - 1 - axis)
        if before:
            data = torch.nn.functional.pad(data, lead + [before, 0],
                                           value=fills[axis, 0].item())
        if after:
            data = torch.nn.functional.pad(data, lead + [0, after],
                                           value=fills[axis, 1].item())
    return data


def _as_pairs(x, ndim, as_index=False):
    """numpy's ``_as_pairs``: ``x`` broadcast to ``ndim`` (before, after)
    pairs, with the same element types (numpy scalars, or Python numbers
    from a broadcast list), so that the working dtypes below follow
    numpy's promotion rules."""
    if x is None:
        return ((None, None),) * ndim
    x = np.array(x)
    if as_index:
        x = np.round(x).astype(np.intp, copy=False)
    if x.ndim < 3:
        if x.size == 1:
            x = x.ravel()
            if as_index and x < 0:
                raise ValueError("index can't contain negative values")
            return ((x[0], x[0]),) * ndim
        if x.size == 2 and x.shape != (2, 1):
            x = x.ravel()
            if as_index and (x[0] < 0 or x[1] < 0):
                raise ValueError("index can't contain negative values")
            return ((x[0], x[1]),) * ndim
    if as_index and x.min() < 0:
        raise ValueError("index can't contain negative values")
    return np.broadcast_to(x, (ndim, 2)).tolist()


def _np_dtype(dtype: torch.dtype) -> np.dtype:
    return torch.empty(0, dtype=dtype).numpy().dtype


def _torch_dtype(dtype: np.dtype) -> torch.dtype:
    return torch.from_numpy(np.empty(0, dtype=dtype)).dtype


def _integer(dtype: torch.dtype) -> bool:
    """numpy's integer kinds: ``numpy.pad`` rounds (a statistic) or floors
    (a ramp) for them, and casts bool data without either."""
    return not (dtype.is_floating_point or dtype.is_complex
                or dtype == torch.bool)


def _cat(parts, axis):
    return torch.cat([p for p in parts if p.shape[axis]], dim=axis)


def _ramp(end, edge, num, axis, dtype):
    """``numpy.linspace(end, edge, num, endpoint=False, dtype=dtype,
    axis=axis)`` for an ``edge`` of length 1 along ``axis``: computed in
    the dtype numpy promotes ``end`` and ``edge`` to, with its formula
    ``arange(num) * step + end`` (``arange(num) / num * delta + end``
    where a step is 0), floored for integer data, then cast."""
    dt = np.result_type(end, np.empty(0, _np_dtype(edge.dtype)))
    if not np.issubdtype(dt, np.inexact):
        dt = np.result_type(dt, np.float64)
    tdt = _torch_dtype(dt)
    start = torch.as_tensor(np.asarray(end, dtype=dt), device=edge.device)
    delta = edge.to(tdt) - start
    shape = [1] * edge.ndim
    shape[axis] = num
    # complex data: numpy's complex arange has zero imaginary parts, and it
    # divides by num + 0j as a product with the reciprocal 1/num; so each
    # of its complex operations is one real operation per component, which
    # runs here in the component dtype
    rdt = tdt.to_real() if tdt.is_complex else tdt
    y = torch.arange(num, dtype=rdt, device=edge.device).reshape(shape)
    # a tensor divisor: torch's CUDA kernels divide by a Python number as a
    # product with its reciprocal, which rounds apart from numpy's division
    div = torch.full((), num, dtype=rdt, device=edge.device)
    if tdt.is_complex:
        inv = 1 / div
        parts = (delta.real, delta.imag)
        steps = [d * inv for d in parts]
        y_div = y * inv
    else:
        parts, steps, y_div = (delta,), (delta / div,), y / div
    # numpy's branch on a zero step, taken on the device without a sync
    zero = torch.stack([s == 0 for s in steps]).all(0).any()
    ys = [torch.where(zero, y_div * d, y * s) for d, s in zip(parts, steps)]
    y = torch.complex(*ys) if tdt.is_complex else ys[0]
    y = y + start
    if _integer(dtype):
        y = torch.floor(y)
    return y.to(dtype)


def _pad_linear_ramp(data, axis, width, ends):
    """One axis of numpy's ``linear_ramp``: from each end value linearly
    to the edge, the end value included and the edge not."""
    before, after = width
    n = data.shape[axis]
    parts = [data]
    if before:
        parts.insert(0, _ramp(ends[0], data.narrow(axis, 0, 1), before, axis,
                              data.dtype))
    if after:
        parts.append(_ramp(ends[1], data.narrow(axis, n - 1, 1), after, axis,
                           data.dtype).flip(axis))
    return _cat(parts, axis) if len(parts) > 1 else data


def _complex_order(x, axis):
    """The indices that sort complex ``x`` along ``axis`` in numpy's order:
    lexicographic in (real, imaginary), then the NaNs, as
    ``R + nanj < nan + Rj < nan + nanj``."""
    re, im = x.real, x.imag
    nan_class = re.isnan().to(torch.int8) * 2 + im.isnan().to(torch.int8)
    order = im.argsort(dim=axis, stable=True)
    for key in (re, nan_class):      # stable sorts by the later keys first
        order = order.gather(axis, key.gather(axis, order).argsort(
            dim=axis, stable=True))
    return order


def _complex_extreme(chunk, axis, mode):
    """numpy's maximum or minimum of complex ``chunk`` along ``axis``:
    lexicographic in (real, imaginary), the extreme real part first, then
    the extreme imaginary part among its ties; the first element with a NaN
    part wins, as numpy's complex maximum and minimum propagate it."""
    pick, fill = (torch.amax, -torch.inf) if mode == "maximum" \
        else (torch.amin, torch.inf)
    re = pick(chunk.real, dim=axis, keepdim=True)
    im = pick(torch.where(chunk.real == re, chunk.imag, fill), dim=axis,
              keepdim=True)
    nan = chunk.real.isnan() | chunk.imag.isnan()
    first_nan = chunk.gather(axis, nan.to(torch.int8).argmax(
        dim=axis, keepdim=True))
    return torch.where(nan.any(dim=axis, keepdim=True), first_nan,
                       torch.complex(re, im))


def _stat(chunk, axis, mode, dtype):
    """numpy's statistic of ``chunk`` along ``axis`` (kept as length 1),
    rounded half to even for integer data as ``numpy.pad`` rounds it;
    complex data are ordered as numpy orders them (:func:`_complex_order`)."""
    inexact = dtype.is_floating_point or dtype.is_complex
    if mode in ("maximum", "minimum"):
        if chunk.is_complex():
            return _complex_extreme(chunk, axis, mode)
        if mode == "maximum":
            return chunk.amax(dim=axis, keepdim=True)
        return chunk.amin(dim=axis, keepdim=True)
    work = chunk if inexact else chunk.double()
    if mode == "mean":
        out = work.mean(dim=axis, keepdim=True)
    else:
        # numpy's median: the middle of the sorted values (the mean of the
        # two middles for even n); where a value is NaN, the last of them
        # (NaN, and for complex data the largest NaN in numpy's order)
        cplx = work.is_complex()
        srt = work.gather(axis, _complex_order(work, axis)) if cplx \
            else work.sort(dim=axis).values
        n = srt.shape[axis]
        out = srt.narrow(axis, n // 2, 1)
        if n % 2 == 0:
            out = (srt.narrow(axis, n // 2 - 1, 1) + out) / 2
        if work.is_floating_point() or cplx:
            last = srt.narrow(axis, n - 1, 1) if cplx \
                else torch.full_like(out, float("nan"))
            out = torch.where(work.isnan().any(dim=axis, keepdim=True),
                              last, out)
    return torch.round(out) if _integer(dtype) else out


def _pad_stat(data, axis, width, lengths, mode):
    """One axis of numpy's statistic modes: each side repeats the statistic
    of its ``stat_length`` nearest elements (all of them where the length
    is None or longer than the axis)."""
    before, after = width
    if not (before or after):
        return data
    n = data.shape[axis]
    left, right = (n if ln is None or n < ln else int(ln) for ln in lengths)
    if (left == 0 or right == 0) and mode in ("maximum", "minimum"):
        raise ValueError("stat_length of 0 yields no value for padding")
    lstat = _stat(data.narrow(axis, 0, left), axis, mode, data.dtype)
    rstat = lstat if left == right == n else \
        _stat(data.narrow(axis, n - right, right), axis, mode, data.dtype)

    def block(stat, w):
        shape = list(data.shape)
        shape[axis] = w
        return stat.to(data.dtype).expand(shape)

    return _cat([block(lstat, before), data, block(rstat, after)], axis)


def _pad_odd_reflect(data, axis, width, include_edge):
    """One axis of numpy's odd ``reflect``/``symmetric``: numpy's loop of
    reflected chunks, each ``2 * edge - chunk`` about the current edge, so
    that a pad wider than the axis comes out as numpy's."""
    before, after = width
    if not (before or after):
        return data
    n0 = data.shape[axis]
    if n0 == 1:
        return _cat([data.expand(*data.shape[:axis], before,
                                 *data.shape[axis + 1:]), data,
                     data.expand(*data.shape[:axis], after,
                                 *data.shape[axis + 1:])], axis)
    shape = list(data.shape)
    shape[axis] += before + after
    out = data.new_empty(shape)
    out.narrow(axis, before, n0).copy_(data)
    size = shape[axis]
    left, right = before, after
    while left > 0 or right > 0:
        old = size - left - right
        if include_edge:
            old, off = old // n0 * n0, 1
        else:
            old, off = (old - 1) // (n0 - 1) * (n0 - 1), 0
        if left > 0:
            k = min(old, left)
            stop = left - off              # chunk: out[stop + k : stop : -1]
            chunk = out.narrow(axis, stop + 1, k).flip(axis)
            chunk = 2 * out.narrow(axis, left, 1) - chunk
            out.narrow(axis, left - k, k).copy_(chunk)
            left -= k
        if right > 0:
            k = min(old, right)
            first = size - right + off - 1 - k   # out[-right+off-2 : ... : -1]
            chunk = out.narrow(axis, first, k).flip(axis)
            chunk = 2 * out.narrow(axis, size - right - 1, 1) - chunk
            out.narrow(axis, size - right, k).copy_(chunk)
            right -= k
    return out


def _check_bad_coords(da: LabeledArray, padding_dims):
    """Reject extra coordinates sharing a padded dim
    (``xrft_tpu/padding.py:142-158``)."""
    bad_coords = []
    for coord in padding_dims:
        if coord not in da.coords:
            continue
        d = da.coords[coord].dims[0]
        bad_coords += [
            c for c in da.coords if d in da.coords[c].dims and c != coord
        ]
    if bad_coords:
        listed = "'" + "', '".join(sorted(set(bad_coords))) + "'"
        raise ValueError(
            "Please, drop the following coordinates from the passed "
            f"DataArray before trying to pad it: {listed}."
        )


def unpad(da: LabeledArray, pad_width=None, **pad_width_kwargs
          ) -> LabeledArray:
    """Undo :func:`pad` by slicing the array and its coordinates; with no
    arguments the widths come from each coordinate's ``pad_width`` attr
    (``xrft_tpu.unpad``)."""
    if pad_width is None and not pad_width_kwargs:
        pad_width = {
            d: c.attrs["pad_width"]
            for d, c in da.coords.items()
            if "pad_width" in c.attrs
        }
        if not pad_width:
            raise ValueError(
                "The passed array doesn't seem to be a padded one: the "
                "'pad_width' attribute was missing on every one of its "
                "coordinates. "
            )
    else:
        pad_width = _either_dict_or_kwargs(pad_width, pad_width_kwargs, "pad")

    slices = {}
    for d, w in pad_width.items():
        w = (w, w) if isinstance(w, int) else tuple(w)
        slices[d] = slice(w[0], da.sizes[d] - w[1])
    out = da.isel(slices)
    for d in pad_width:
        if d in out.coords:
            out.coords[d].attrs.pop("pad_width", None)
    return out
