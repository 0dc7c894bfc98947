"""LabeledArray on a torch tensor.

Counterpart of ``xrft_tpu/labeled.py``: bulk data is a ``torch.Tensor`` on
the device it was given; dims, coordinates and attrs are host-side metadata
(coordinates are always host numpy, as in the reference).  Only the subset
of the xarray.DataArray surface that the ported slice uses is here.
"""

from __future__ import annotations

import operator
from typing import Any, Sequence

import numpy as np
import torch

__all__ = ["Coord", "LabeledArray"]


class Coord:
    """A host-side coordinate: a numpy array with named dims and attrs."""

    __slots__ = ("dims", "values", "attrs", "name")

    def __init__(self, dims, values, attrs=None, name=None):
        if isinstance(dims, str):
            dims = (dims,)
        self.dims = tuple(dims)
        self.values = np.asarray(values)
        if self.values.ndim != len(self.dims):
            raise ValueError(
                f"coordinate has {self.values.ndim} axes but dims {self.dims}"
            )
        self.attrs = dict(attrs) if attrs else {}
        self.name = name

    @property
    def shape(self):
        return self.values.shape

    def __repr__(self):
        return f"Coord({self.name or ''}{self.dims}, {self.values!r})"

    def copy(self, values=None, attrs=None) -> "Coord":
        return Coord(
            self.dims,
            self.values if values is None else values,
            dict(self.attrs) if attrs is None else attrs,
            self.name,
        )


def _as_coord(name: str, value: Any, dims: Sequence[str]) -> Coord:
    """Normalize a user-provided coords dict entry into a Coord."""
    if isinstance(value, Coord):
        c = value.copy()
        c.name = name
        return c
    if isinstance(value, tuple) and len(value) in (2, 3) and not np.isscalar(value[0]):
        # (dims, values[, attrs]) xarray-style tuple
        cattrs = value[2] if len(value) == 3 else None
        return Coord(value[0], value[1], cattrs, name)
    arr = np.asarray(value)
    if name in dims:
        if arr.ndim != 1:
            raise ValueError(f"dimension coordinate {name!r} must be 1-D")
        return Coord((name,), arr, None, name)
    if arr.ndim == 0:
        return Coord((), arr, None, name)
    raise ValueError(
        f"cannot infer dims for coordinate {name!r}; pass a Coord or a "
        f"(dims, values) tuple"
    )


class LabeledArray:
    """An N-D torch tensor with named dims, host-side coords, and attrs.

    Arithmetic broadcasts by dim name, as xarray does.  A numpy array (or
    anything ``np.asarray`` takes) passed as ``data`` becomes a CPU tensor;
    a tensor stays on its device.
    """

    __slots__ = ("data", "dims", "coords", "attrs", "name")

    def __init__(self, data, dims=None, coords=None, attrs=None, name=None):
        if not isinstance(data, torch.Tensor):
            data = torch.as_tensor(np.asarray(data))
        if dims is None:
            dims = tuple(f"dim_{i}" for i in range(data.ndim))
        elif isinstance(dims, str):
            dims = (dims,)
        else:
            dims = tuple(dims)
        if len(dims) != data.ndim:
            raise ValueError(f"{len(dims)} dims for {data.ndim}-d data")
        self.data = data
        self.dims = dims
        self.coords = {cname: _as_coord(cname, cval, dims)
                       for cname, cval in (coords or {}).items()}
        self.attrs = dict(attrs) if attrs else {}
        self.name = name
        self._validate()

    def _validate(self):
        sizes = self.sizes
        for cname, c in self.coords.items():
            for d, n in zip(c.dims, c.shape):
                if d not in sizes:
                    raise ValueError(
                        f"coordinate {cname!r} has unknown dim {d!r}"
                    )
                if sizes[d] != n:
                    raise ValueError(
                        f"coordinate {cname!r} size {n} along {d!r} != {sizes[d]}"
                    )

    # ------------------------------------------------------------------ core
    @property
    def shape(self):
        return tuple(self.data.shape)

    @property
    def dtype(self):
        return self.data.dtype

    @property
    def device(self):
        return self.data.device

    @property
    def sizes(self) -> dict[str, int]:
        return dict(zip(self.dims, self.data.shape))

    @property
    def values(self) -> np.ndarray:
        """A host numpy copy of the data."""
        return self.data.detach().cpu().numpy()

    def get_axis_num(self, dim):
        if isinstance(dim, (list, tuple)):
            return [self.dims.index(d) for d in dim]
        return self.dims.index(dim)

    def __repr__(self):
        return (
            f"<LabeledArray {self.name or ''}{self.sizes} "
            f"dtype={self.data.dtype} device={self.data.device} "
            f"coords=[{', '.join(self.coords)}]>"
        )

    def copy(self, data=None) -> "LabeledArray":
        """Shallow copy of the metadata around ``data`` (default: the same
        tensor)."""
        out = LabeledArray.__new__(LabeledArray)
        out.data = self.data if data is None else data
        if out.data.ndim != len(self.dims):
            raise ValueError("replacement data has wrong rank")
        out.dims = self.dims
        out.coords = {k: c.copy() for k, c in self.coords.items()}
        out.attrs = dict(self.attrs)
        out.name = self.name
        return out

    # --------------------------------------------------------- manipulation
    def transpose(self, *dims) -> "LabeledArray":
        if not dims:
            dims = self.dims[::-1]
        if len(dims) == 1 and isinstance(dims[0], (list, tuple)):
            dims = tuple(dims[0])
        if set(dims) != set(self.dims) or len(dims) != len(self.dims):
            raise ValueError(f"transpose dims {dims} != array dims {self.dims}")
        out = self.copy(data=self.data.permute(
            [self.dims.index(d) for d in dims]))
        out.dims = tuple(dims)
        return out

    def assign_coords(self, coords=None, **kwargs) -> "LabeledArray":
        coords = dict(coords or {})
        coords.update(kwargs)
        out = self.copy()
        for cname, cval in coords.items():
            out.coords[cname] = _as_coord(cname, cval, out.dims)
        out._validate()
        return out

    # ----------------------------------------------------------- reductions
    def _reduce(self, fn, dim=None) -> "LabeledArray":
        if dim is None:
            dims = list(self.dims)
        elif isinstance(dim, str):
            dims = [dim]
        else:
            dims = list(dim)
        out = LabeledArray.__new__(LabeledArray)
        out.data = fn(self.data, dim=[self.dims.index(d) for d in dims])
        out.dims = tuple(d for d in self.dims if d not in dims)
        out.attrs = dict(self.attrs)
        out.name = self.name
        out.coords = {k: c.copy() for k, c in self.coords.items()
                      if not any(d in dims for d in c.dims)}
        return out

    def mean(self, dim=None):
        return self._reduce(torch.mean, dim)

    def sum(self, dim=None):
        return self._reduce(torch.sum, dim)

    # -------------------------------------------- dim-aligned binary ops
    def _binary(self, other, op, reflexive=False) -> "LabeledArray":
        if isinstance(other, LabeledArray):
            out_dims = list(self.dims) + [
                d for d in other.dims if d not in self.dims
            ]
            for d in self.dims:
                if d in other.dims and self.sizes[d] != other.sizes[d]:
                    raise ValueError(
                        f"conflicting sizes for dim {d!r}: "
                        f"{self.sizes[d]} vs {other.sizes[d]}"
                    )
            a = _expand_to(self, out_dims)
            b = _expand_to(other, out_dims)
            out = LabeledArray.__new__(LabeledArray)
            out.data = op(b, a) if reflexive else op(a, b)
            out.dims = tuple(out_dims)
            # user attrs and the name drop (xarray keep_attrs=False parity)
            out.attrs = {}
            out.name = None
            coords = {k: c.copy() for k, c in self.coords.items()}
            for k, c in other.coords.items():
                coords.setdefault(k, c.copy())
            out.coords = coords
            return out
        if isinstance(other, np.generic):
            other = other.item()
        if not isinstance(other, (int, float, complex, torch.Tensor)):
            raise TypeError(
                f"unsupported operand type {type(other).__name__}")
        data = op(other, self.data) if reflexive else op(self.data, other)
        out = self.copy(data=data)
        out.attrs = {}
        return out

    def __add__(self, o):
        return self._binary(o, operator.add)

    def __radd__(self, o):
        return self._binary(o, operator.add, reflexive=True)

    def __sub__(self, o):
        return self._binary(o, operator.sub)

    def __rsub__(self, o):
        return self._binary(o, operator.sub, reflexive=True)

    def __mul__(self, o):
        return self._binary(o, operator.mul)

    def __rmul__(self, o):
        return self._binary(o, operator.mul, reflexive=True)

    def __truediv__(self, o):
        return self._binary(o, operator.truediv)

    def __rtruediv__(self, o):
        return self._binary(o, operator.truediv, reflexive=True)

    def __pow__(self, o):
        return self._binary(o, operator.pow)


def _expand_to(da: LabeledArray, out_dims: Sequence[str]) -> torch.Tensor:
    """da.data permuted and unsqueezed to out_dims order (a view)."""
    own = [d for d in out_dims if d in da.dims]
    data = da.data.permute([da.dims.index(d) for d in own])
    return data.reshape([da.sizes[d] if d in da.dims else 1
                         for d in out_dims])
