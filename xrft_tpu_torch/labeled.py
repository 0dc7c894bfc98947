"""LabeledArray on a torch tensor.

Counterpart of ``xrft_tpu/labeled.py``: bulk data is a ``torch.Tensor`` on
the device it was given; dims, coordinates and attrs are host-side metadata
(coordinates are always host numpy, as in the reference).  The methods are
those of ``xrft_tpu``'s LabeledArray, without its JAX pytree hooks.

The data may be a sharded ``DTensor`` (:mod:`.parallel`): arithmetic,
reductions and ``sortby`` then work on each rank's local block
(:mod:`.ops.shards`) and keep the array sharded; the coordinates stay
global.
"""

from __future__ import annotations

import operator
from typing import Any, Sequence

import numpy as np
import torch

from .dtypes import promote
from .ops import shards

__all__ = ["Coord", "LabeledArray", "resolve_device"]


def resolve_device(device=None) -> torch.device:
    """``device`` as a torch.device; None means the CUDA device, and raises
    when there is none: the package never moves to the CPU unasked."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError(
            "xrft_tpu_torch runs on the CUDA device by default and none is "
            "available; pass device='cpu' (or a CPU tensor) to run on the "
            "CPU")
    return torch.device("cuda")


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

    # the accessors of xrft_tpu's Coord (``xrft_tpu/labeled.py:81-121``)
    @property
    def size(self) -> int:
        return self.values.size

    @property
    def shape(self):
        return self.values.shape

    @property
    def dtype(self):
        return self.values.dtype

    @property
    def data(self) -> np.ndarray:
        return self.values

    def __len__(self) -> int:
        return len(self.values)

    def __getitem__(self, idx):
        return self.values[idx]

    def __array__(self, dtype=None, copy=None):
        return np.asarray(self.values, dtype=dtype)

    def __getattr__(self, key):
        # xarray-style access to attrs (``coord.spacing``); never for
        # dunder names, which copy and pickle look up before attrs exists
        if key.startswith("__"):
            raise AttributeError(key)
        try:
            return self.attrs[key]
        except KeyError:
            raise AttributeError(key) from None

    def max(self):
        return self.values.max()

    def min(self):
        return self.values.min()

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
    anything ``np.asarray`` takes) passed as ``data`` becomes a tensor on
    ``device``, by default the CUDA device (see :func:`resolve_device`); a
    tensor stays on its device unless ``device`` names another.  Declared
    chunk lengths (:meth:`chunk`) live in ``attrs["_chunks"]`` and survive
    arithmetic, as dask chunks do.
    """

    __slots__ = ("data", "dims", "coords", "attrs", "name")

    def __init__(self, data, dims=None, coords=None, attrs=None, name=None,
                 device=None):
        if not isinstance(data, torch.Tensor):
            data = torch.as_tensor(np.asarray(data),
                                   device=resolve_device(device))
        elif device is not None:
            data = data.to(device)
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
    def ndim(self) -> int:
        return self.data.ndim

    @property
    def size(self) -> int:
        return self.data.numel()

    def __array__(self, dtype=None, copy=None):
        out = self.values
        return out.astype(dtype) if dtype is not None else out

    def __len__(self):
        return self.shape[0]

    def item(self):
        return self.values.item()

    @property
    def values(self) -> np.ndarray:
        """A host numpy copy of the data (lazy conjugate and negative views
        resolved).  Sharded data are gathered first (``full_tensor``, a
        collective: every rank of the mesh must ask)."""
        data = self.data
        if shards.is_sharded(data):
            data = data.full_tensor()
        return data.detach().cpu().resolve_conj().resolve_neg().numpy()

    def get_axis_num(self, dim):
        if isinstance(dim, (list, tuple)):
            return [self.dims.index(d) for d in dim]
        return self.dims.index(dim)

    def __getitem__(self, key):
        """``da["x"]``: the coordinate ``x``, as ``xrft_tpu``'s."""
        if isinstance(key, str):
            try:
                return self.coords[key]
            except KeyError:
                raise KeyError(f"no coordinate {key!r}") from None
        raise TypeError(
            "positional indexing is not supported; use .isel(dim=indexer)"
        )

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

    def sortby(self, dim) -> "LabeledArray":
        """Sort along one or more dims by their 1-D dim-coordinate values
        (stable); the data move by ``index_select`` on their device."""
        dims = [dim] if isinstance(dim, str) else list(dim)
        out = self
        for d in dims:
            if d not in out.coords:
                raise KeyError(f"no coordinate for dim {d!r}")
            order = np.argsort(out.coords[d].values, kind="stable")
            if np.array_equal(order, np.arange(order.size)):
                continue
            nxt = out.copy(data=shards.take(out.data, out.get_axis_num(d),
                                            order))
            for cname, c in nxt.coords.items():
                if d in c.dims:
                    nxt.coords[cname] = c.copy(
                        values=np.take(c.values, order, axis=c.dims.index(d)))
            out = nxt
        return out

    def isel(self, indexers=None, **indexers_kwargs) -> "LabeledArray":
        """Select by position along dims (ints drop the dim, slices and
        index arrays keep it), as ``xrft_tpu``'s ``isel``: a view for
        ints and slices, an ``index_select`` copy for index arrays."""
        indexers = dict(indexers or {})
        indexers.update(indexers_kwargs)
        data = self.data
        dropped = []
        for ax in reversed(range(len(self.dims))):
            d = self.dims[ax]
            ix = indexers.get(d, slice(None))
            if isinstance(ix, (int, np.integer)):
                data = data.select(ax, int(ix))
                dropped.append(d)
            elif isinstance(ix, slice):
                data = data[(slice(None),) * ax + (ix,)]
            else:
                data = data.index_select(ax, torch.as_tensor(
                    np.asarray(ix), dtype=torch.long, device=data.device))
        out = LabeledArray.__new__(LabeledArray)
        out.data = data
        out.dims = tuple(d for d in self.dims if d not in dropped)
        out.attrs = dict(self.attrs)
        out.name = self.name
        out.coords = {}
        for cname, c in self.coords.items():
            if any(d in dropped for d in c.dims):
                continue
            if any(d in indexers for d in c.dims):
                ckey = tuple(indexers.get(d, slice(None)) for d in c.dims)
                out.coords[cname] = Coord(c.dims, c.values[ckey], c.attrs,
                                          cname)
            else:
                out.coords[cname] = c.copy()
        return out

    def sel(self, indexers=None, method=None, **indexers_kwargs
            ) -> "LabeledArray":
        """Select by coordinate value along 1-D dim coords, as
        ``xrft_tpu``'s: exact matches, or the nearest value with
        ``method="nearest"``."""
        indexers = dict(indexers or {})
        indexers.update(indexers_kwargs)
        isel_map = {}
        for d, target in indexers.items():
            if d not in self.coords:
                raise KeyError(f"no coordinate for dim {d!r}")
            vals = self.coords[d].values
            idx = []
            for tv in np.atleast_1d(np.asarray(target)):
                if method == "nearest":
                    idx.append(int(np.argmin(np.abs(vals - tv))))
                    continue
                hits = np.nonzero(vals == tv)[0]
                if hits.size == 0:
                    raise KeyError(
                        f"value {tv!r} not found in coordinate {d!r}")
                idx.append(int(hits[0]))
            isel_map[d] = idx[0] if np.ndim(target) == 0 else np.asarray(idx)
        return self.isel(isel_map)

    def drop_vars(self, names) -> "LabeledArray":
        out = self.copy()
        for n in [names] if isinstance(names, str) else names:
            out.coords.pop(n, None)
        return out

    def rename(self, name) -> "LabeledArray":
        out = self.copy()
        out.name = name
        return out

    def assign_attrs(self, **attrs) -> "LabeledArray":
        out = self.copy()
        out.attrs.update(attrs)
        return out

    def dropna(self, dim) -> "LabeledArray":
        """Drop the labels along ``dim`` where the data (any over the other
        dims) or the dim coordinate is NaN, as ``xrft_tpu``'s."""
        axis = self.get_axis_num(dim)
        mask = np.zeros(self.shape[axis], dtype=bool)
        if self.dtype.is_floating_point or self.dtype.is_complex:
            other = [a for a in range(self.ndim) if a != axis]
            nan = self.data.isnan()
            mask |= (nan.any(dim=other) if other else nan).cpu().numpy()
        if dim in self.coords:
            cvals = self.coords[dim].values
            if np.issubdtype(cvals.dtype, np.floating):
                mask |= np.isnan(cvals)
        keep = np.nonzero(~mask)[0]
        if keep.size == self.shape[axis]:
            return self.copy()
        return self.isel({dim: keep})

    def chunk(self, chunks=None, **chunks_kwargs) -> "LabeledArray":
        """Declare chunk lengths per dim (metadata only), which
        ``chunks_to_segments=True`` cuts into segments
        (``xrft_tpu/labeled.py:533-551``)."""
        merged = dict(self.attrs.get("_chunks") or {})
        merged.update(chunks or {})
        merged.update(chunks_kwargs)
        for d in merged:
            if d not in self.dims:
                raise ValueError(f"chunk dim {d!r} not in {self.dims}")
        return self.assign_attrs(_chunks=merged)

    @property
    def chunks(self):
        return self.attrs.get("_chunks")

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
        axes = [self.dims.index(d) for d in dims]
        out.data = _sharded_reduce(self.data, fn, axes) \
            if shards.is_sharded(self.data) else fn(self.data, dim=axes)
        out.dims = tuple(d for d in self.dims if d not in dims)
        out.attrs = dict(self.attrs)
        out.name = self.name
        out.coords = {k: c.copy() for k, c in self.coords.items()
                      if not any(d in dims for d in c.dims)}
        return out

    def mean(self, dim=None):
        """The mean over ``dim``; integer and bool data give JAX's float
        dtype for them (:mod:`.dtypes`), as ``xrft_tpu``'s ``mean``."""
        return self.copy(data=promote(self.data))._reduce(torch.mean, dim)

    def sum(self, dim=None):
        return self._reduce(torch.sum, dim)

    def max(self, dim=None):
        return self._local_reduce(torch.amax, dim)

    def min(self, dim=None):
        return self._local_reduce(torch.amin, dim)

    def std(self, dim=None):
        """Population standard deviation (numpy's ``ddof=0``)."""
        return self.copy(data=promote(self.data))._local_reduce(
            lambda x, dim: torch.std(x, dim=dim, correction=0), dim)

    def var(self, dim=None):
        """Population variance (numpy's ``ddof=0``)."""
        return self.copy(data=promote(self.data))._local_reduce(
            lambda x, dim: torch.var(x, dim=dim, correction=0), dim)

    def _local_reduce(self, fn, dim):
        """``fn`` over ``dim`` of unsharded data; of the reductions only
        ``mean`` and ``sum`` cross the shards."""
        if shards.is_sharded(self.data):
            raise NotImplementedError(
                "only mean and sum reduce sharded data")
        return self._reduce(fn, dim)

    def median(self, dim=None):
        """The median over ``dim``, as ``xrft_tpu``'s (numpy's: the mean of
        the two middle values for an even count), e.g. to average Welch
        segments robustly."""
        return self._local_reduce(_median, dim)

    # ---------------------------------------------------------- elementwise
    def conj(self) -> "LabeledArray":
        """Complex conjugate (a lazy torch view; real data unchanged)."""
        return self.copy(data=self.data.conj())

    @property
    def real(self) -> "LabeledArray":
        return self.copy(data=self.data.real)

    @property
    def imag(self) -> "LabeledArray":
        """The imaginary part; zeros for real data, as numpy's."""
        x = self.data
        return self.copy(data=x.imag if x.is_complex() else torch.zeros_like(x))

    def astype(self, dtype) -> "LabeledArray":
        """The data cast to ``dtype`` (a torch dtype, or anything
        ``numpy.dtype`` takes)."""
        if not isinstance(dtype, torch.dtype):
            dtype = torch.from_numpy(np.empty(0, np.dtype(dtype))).dtype
        return self.copy(data=self.data.to(dtype))

    def fillna(self, value) -> "LabeledArray":
        """NaNs replaced by ``value`` (and infinities by the dtype's
        extremes, as numpy's and JAX's ``nan_to_num``)."""
        return self.copy(data=torch.nan_to_num(self.data, nan=value))

    def where(self, cond, other=np.nan) -> "LabeledArray":
        """The values where ``cond`` holds, ``other`` (NaN) elsewhere;
        a LabeledArray ``cond`` broadcasts by dim name."""
        if not isinstance(cond, LabeledArray):
            c = torch.as_tensor(np.asarray(cond), device=self.device)
            return self.copy(data=torch.where(c, self.data, other))
        out_dims = list(self.dims) + [d for d in cond.dims
                                      if d not in self.dims]
        out = LabeledArray.__new__(LabeledArray)
        out.data = torch.where(_expand_to(cond, out_dims),
                               _expand_to(self, out_dims), other)
        out.dims = tuple(out_dims)
        out.attrs = dict(self.attrs)
        out.name = self.name
        out.coords = {k: v.copy() for k, v in self.coords.items()}
        for k, v in cond.coords.items():
            out.coords.setdefault(k, v.copy())
        return out

    def __abs__(self):
        return self.copy(data=self.data.abs())

    def __neg__(self):
        return self.copy(data=-self.data)

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
            out = LabeledArray.__new__(LabeledArray)
            if shards.is_sharded(self.data) or shards.is_sharded(other.data):
                out.data = _sharded_binary(self, other, out_dims, op,
                                           reflexive)
            else:
                a = _expand_to(self, out_dims)
                b = _expand_to(other, out_dims)
                out.data = op(b, a) if reflexive else op(a, b)
            out.dims = tuple(out_dims)
            # user attrs and the name drop (xarray keep_attrs=False parity),
            # but declared chunk lengths are structural, like dask chunks
            # (xrft_tpu/labeled.py:650-658)
            chunks = dict(other.attrs.get("_chunks") or {})
            chunks.update(self.attrs.get("_chunks") or {})
            chunks = {d: c for d, c in chunks.items() if d in out_dims}
            out.attrs = {"_chunks": chunks} if chunks else {}
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
        chunks = self.attrs.get("_chunks")
        out.attrs = {"_chunks": dict(chunks)} if chunks else {}
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


def _median(x: torch.Tensor, dim) -> torch.Tensor:
    """numpy's median of ``x`` over the axes ``dim``: the axes are moved
    last and flattened, then the 0.5 quantile (linear between the two
    middle values) is taken."""
    dim = sorted(d % x.ndim for d in dim)
    keep = [a for a in range(x.ndim) if a not in dim]
    flat = x.permute(*keep, *dim).reshape(
        [x.shape[a] for a in keep] + [-1])
    return torch.quantile(flat, 0.5, dim=-1)


def _sharded_reduce(x, fn, axes) -> torch.Tensor:
    """``fn`` (torch.sum or torch.mean) of the DTensor ``x`` over ``axes``:
    the local sum, one all_reduce per mesh axis of a reduced sharded axis,
    the mean's division by the global count; the result keeps the
    remaining axes' shards and is replicated over the reduced ones."""
    amap = shards.axis_map(x)
    block = torch.sum(shards.local(x), dim=axes)
    shards.all_sum(x, block, axes)
    if fn is torch.mean:
        block = block / float(np.prod([x.shape[a] for a in axes]))
    keep = [a for a in range(x.ndim) if a not in axes]
    return shards.wrap(x.device_mesh, block,
                       {keep.index(a): m for a, m in amap.items() if a in keep},
                       [x.shape[a] for a in keep])


def _sharded_binary(left, right, out_dims, op, reflexive) -> torch.Tensor:
    """``op`` of two LabeledArrays, one or both sharded, on local blocks:
    every dim sharded in either operand is sharded over the same mesh axis
    in the result, and the other operand's data along it are cut to this
    rank's block (a plain tensor's by slicing, no exchange).  Two operands
    that shard one dim differently, or live on two meshes, raise."""
    mesh, sharded = None, {}
    for da in (left, right):
        if not shards.is_sharded(da.data):
            continue
        if mesh is not None and da.data.device_mesh != mesh:
            raise ValueError("operands sharded over two different meshes")
        mesh = da.data.device_mesh
        for a, m in shards.axis_map(da.data).items():
            d = da.dims[a]
            if sharded.setdefault(d, m) != m:
                raise ValueError(f"dim {d!r} is sharded over mesh axis "
                                 f"{sharded[d]!r} in one operand and {m!r} "
                                 f"in the other")
    sizes = {**right.sizes, **left.sizes}
    parts = shards.mesh_shape(mesh)

    def block(da):
        data = shards.local(da.data)
        own = shards.axis_map(da.data)
        for a, d in enumerate(da.dims):
            if d in sharded and a not in own:
                lo, hi = shards.chunk_range(
                    sizes[d], parts[sharded[d]],
                    mesh.get_local_rank(sharded[d]))
                data = data.narrow(a, lo, hi - lo)
        loc = LabeledArray.__new__(LabeledArray)
        loc.data, loc.dims = data, da.dims
        return _expand_to(loc, out_dims)

    a, b = block(left), block(right)
    out = op(b, a) if reflexive else op(a, b)
    return shards.wrap(mesh, out,
                       {out_dims.index(d): m for d, m in sharded.items()},
                       [sizes[d] for d in out_dims])
