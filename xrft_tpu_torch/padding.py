"""Pad and unpad a regular grid, extrapolating its coordinates.

Counterpart of ``xrft_tpu/padding.py``: the data are padded with numpy's
pad modes, the evenly spaced coordinates are extrapolated on the host with
the same spacing, and each padded coordinate records its ``pad_width`` in
its attrs so that :func:`unpad` can invert the pad by slicing.  The
``"constant"`` mode pads on the data's device (``torch.nn.functional.pad``),
and so do the modes that only repeat elements (``"edge"``, ``"wrap"``, and
``"reflect"``/``"symmetric"`` with the even reflect type): numpy pads an
index per axis and the data are gathered with ``index_select``.  The other
modes (``"linear_ramp"``, the statistic modes, the odd reflect type) pad a
CPU tensor with ``numpy.pad`` and raise for a tensor on another device:
the data never leave the card unasked.
"""

from __future__ import annotations

import numpy as np
import torch

from .labeled import Coord, LabeledArray
from .utils import get_spacing

__all__ = ["pad", "unpad"]

# modes whose padded values are copies of the data's own elements
_INDEX_MODES = ("edge", "reflect", "symmetric", "wrap")


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
    elif mode in ("maximum", "mean", "median", "minimum"):
        if stat_length is not None:
            kw["stat_length"] = _per_axis(
                stat_length, [da.sizes[d] for d in da.dims])
    elif mode in ("reflect", "symmetric"):
        if reflect_type is not None:
            kw["reflect_type"] = reflect_type

    data = da.data
    if mode == "constant":
        padded = _pad_constant(data, widths, kw["constant_values"])
    elif mode in _INDEX_MODES and kw.get("reflect_type", "even") == "even":
        padded = data
        for axis, w in enumerate(widths):
            if any(w):
                idx = np.pad(np.arange(data.shape[axis]), w, mode=mode)
                padded = padded.index_select(
                    axis, torch.as_tensor(idx, device=data.device))
    elif data.device.type == "cpu":
        host = data.detach().resolve_conj().resolve_neg().numpy()
        padded = torch.from_numpy(np.pad(host, widths, mode=mode, **kw))
    else:
        raise NotImplementedError(
            f"pad mode {mode!r} (reflect_type={reflect_type!r}) runs only on "
            f"a CPU tensor; the data lie on {data.device}")

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
