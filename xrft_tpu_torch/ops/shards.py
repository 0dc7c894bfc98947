"""Sharded data (``torch.distributed.tensor.DTensor``) on its local blocks.

A sharded :class:`~xrft_tpu_torch.labeled.LabeledArray` holds a DTensor on a
``DeviceMesh``, each array axis sharded over at most one mesh axis
(``Shard``) and replicated over the others: the counterpart of a
``jax.Array`` with a ``NamedSharding``.  DTensor's own operator propagation
is not GSPMD: along a sharded dim ``torch.roll``, ``torch.flip``,
``torch.fft``, ``torch.cat`` and ``index_select`` replicate the array (a
silent all-gather) or refuse plain tensor operands, and a reduction leaves a
pending ``Partial``.  So every data step of the package that crosses a
sharded dim runs here, on ``to_local()`` blocks, with its one collective
explicit:

  * :func:`take` gathers along an axis by a host index (a roll, a flip, a
    sort, a mirror): local when the axis is resident, one
    ``all_to_all_single`` with uneven splits when it is sharded;
  * :func:`all_sum` sums over the ranks that hold the blocks of reduced
    sharded axes (one ``all_reduce`` per mesh axis);
  * :func:`wrap` builds the result from a local block with its placement,
    global shape and stride given explicitly.

Elementwise ops (``*`` by a scalar, ``.real``, ``abs``, ``conj``,
``angle``, a product of two identically sharded DTensors) keep DTensor's
placement as they are.  A sharded axis's blocks follow DTensor's ``Shard``
(``torch.chunk``): rank r of P holds ``[r*c, min((r+1)*c, n))``,
``c = ceil(n/P)``.
"""

from __future__ import annotations

import numpy as np
import torch

try:
    import torch.distributed as dist
    from torch.distributed.tensor import DTensor, Replicate, Shard
except ImportError:  # a torch built without torch.distributed
    dist = DTensor = Replicate = Shard = None

__all__ = ["is_sharded", "local", "mesh_shape", "axis_map", "placements",
           "wrap", "like", "chunk_range", "local_range", "take", "flip", "roll",
           "fftshift", "ifftshift", "all_sum"]


def is_sharded(x) -> bool:
    return DTensor is not None and isinstance(x, DTensor)


def local(x: torch.Tensor) -> torch.Tensor:
    """The local block of a DTensor; any other tensor as it is."""
    return x.to_local() if is_sharded(x) else x


def mesh_shape(mesh) -> dict:
    """{mesh axis name: size}."""
    return dict(zip(mesh.mesh_dim_names, mesh.shape))


def axis_map(x) -> dict:
    """{array axis: mesh axis name} of a DTensor's ``Shard`` placements
    (empty for any other tensor).  A pending reduction (``Partial``) or an
    array axis sharded over two mesh axes raises."""
    if not is_sharded(x):
        return {}
    names = x.device_mesh.mesh_dim_names
    out = {}
    for name, p in zip(names, x.placements):
        if p.is_shard():
            if p.dim in out:
                raise ValueError(
                    f"array axis {p.dim} is sharded over mesh axes "
                    f"{out[p.dim]!r} and {name!r}; one mesh axis per array "
                    f"axis is supported")
            out[p.dim] = name
        elif not p.is_replicate():
            raise ValueError(f"placement {p} on mesh axis {name!r} is not a "
                             f"Shard or Replicate")
    return out


def placements(mesh, axis_sharding: dict) -> list:
    """DTensor placements of {array axis: mesh axis name}."""
    names = list(mesh.mesh_dim_names)
    out = [Replicate()] * len(names)
    for a, m in axis_sharding.items():
        if m not in names:
            raise ValueError(f"unknown mesh axis {m!r}; the mesh has {names}")
        if out[names.index(m)] != Replicate():
            raise ValueError(f"mesh axis {m!r} shards two array axes")
        out[names.index(m)] = Shard(a)
    return out


def _contiguous_stride(shape) -> tuple:
    stride, acc = [], 1
    for n in reversed(shape):
        stride.append(acc)
        acc *= max(int(n), 1)
    return tuple(reversed(stride))


def wrap(mesh, block: torch.Tensor, axis_sharding: dict, shape) -> "DTensor":
    """The DTensor of global ``shape`` whose local block is ``block``,
    sharded per {array axis: mesh axis name}."""
    shape = tuple(int(n) for n in shape)
    return DTensor.from_local(block, mesh, placements(mesh, axis_sharding),
                              run_check=False, shape=torch.Size(shape),
                              stride=_contiguous_stride(shape))


def like(x, block: torch.Tensor):
    """``block`` wrapped with the mesh and placement of ``x`` (a DTensor);
    the global extent of each sharded axis is ``x``'s, every resident axis
    the block's own.  ``block`` as it is when ``x`` is not sharded."""
    if not is_sharded(x):
        return block
    amap = axis_map(x)
    shape = [x.shape[a] if a in amap else block.shape[a]
             for a in range(block.ndim)]
    return wrap(x.device_mesh, block, amap, shape)


def chunk_range(n: int, parts: int, r: int) -> tuple:
    """[start, stop) of block r of an axis of extent n cut into ``parts``
    as DTensor's ``Shard`` cuts it."""
    c = -(-n // parts)
    start = min(r * c, n)
    return start, min(start + c, n)


def _group(mesh, m):
    return mesh.get_group(m), mesh_shape(mesh)[m], mesh.get_local_rank(m)


def local_range(x, axis: int) -> tuple:
    """[start, stop) of the global indices of ``axis`` that this rank
    holds; the whole axis when it is resident."""
    m = axis_map(x).get(axis)
    if m is None:
        return 0, x.shape[axis]
    _, parts, r = _group(x.device_mesh, m)
    return chunk_range(x.shape[axis], parts, r)


def _real_view(t: torch.Tensor) -> torch.Tensor:
    """A complex tensor as its (..., 2) real view, which every backend's
    collectives take; any other tensor as it is."""
    return torch.view_as_real(t) if t.is_complex() else t


def take(x, axis: int, index) -> torch.Tensor:
    """``x`` gathered along ``axis`` by the global host ``index`` (numpy
    ints): ``out[..., i, ...] = x[..., index[i], ...]``.  A resident axis is
    one local ``index_select``.  A sharded axis stays sharded over the same
    mesh axis, ``len(index)`` long: each rank sends every other rank the
    rows it owns of that rank's block of the result, in one
    ``all_to_all_single`` with uneven splits, and puts what arrives in
    order."""
    index = np.asarray(index, dtype=np.int64)
    xl = local(x)
    dev = xl.device
    m = axis_map(x).get(axis)
    if m is None:
        out = xl.index_select(axis, torch.as_tensor(index, device=dev))
        return like(x, out)
    mesh = x.device_mesh
    group, parts, me = _group(mesh, m)
    n, n_out = x.shape[axis], index.size
    c_in = -(-n // parts)
    owner = index // c_in
    lo, _ = chunk_range(n, parts, me)
    send_rows, in_splits = [], []
    for r in range(parts):
        a, b = chunk_range(n_out, parts, r)
        rows = index[a:b][owner[a:b] == me] - lo
        send_rows.append(rows)
        in_splits.append(int(rows.size))
    a, b = chunk_range(n_out, parts, me)
    mine = owner[a:b]
    out_splits = [int(np.count_nonzero(mine == q)) for q in range(parts)]
    send = xl.index_select(axis, torch.as_tensor(
        np.concatenate(send_rows), device=dev)).movedim(axis, 0).contiguous()
    recv = torch.empty((b - a,) + tuple(send.shape[1:]), dtype=send.dtype,
                       device=dev)
    dist.all_to_all_single(_real_view(recv), _real_view(send), out_splits,
                           in_splits, group=group)
    # rows arrive grouped by sender, each group in output order
    arrival = np.argsort(mine, kind="stable")
    place = torch.as_tensor(np.argsort(arrival), device=dev)
    block = recv.index_select(0, place).movedim(0, axis)
    amap = axis_map(x)
    shape = list(x.shape)
    shape[axis] = n_out
    return wrap(mesh, block, amap, shape)


def flip(x, axes) -> torch.Tensor:
    """``torch.flip`` over ``axes``: local on resident axes, :func:`take`
    on sharded ones."""
    amap = axis_map(x)
    resident = [a for a in axes if a not in amap]
    out = like(x, torch.flip(local(x), resident)) if resident else x
    for a in axes:
        if a in amap:
            out = take(out, a, np.arange(x.shape[a])[::-1])
    return out


def roll(x, shifts: dict) -> torch.Tensor:
    """``torch.roll`` by {axis: shift}: local on resident axes, :func:`take`
    on sharded ones."""
    amap = axis_map(x)
    res = {a: s for a, s in shifts.items() if a not in amap and s}
    out = like(x, torch.roll(local(x), list(res.values()), list(res))) \
        if res else x
    for a, s in shifts.items():
        if a in amap and s:
            n = x.shape[a]
            out = take(out, a, (np.arange(n) - s) % n)
    return out


def fftshift(x, axes) -> torch.Tensor:
    return roll(x, {a: x.shape[a] // 2 for a in axes})


def ifftshift(x, axes) -> torch.Tensor:
    return roll(x, {a: -(x.shape[a] // 2) for a in axes})


def all_sum(x, block: torch.Tensor, axes) -> torch.Tensor:
    """``block`` (a local partial sum over ``axes`` of ``x``) summed over
    the ranks that hold the other blocks of ``axes``' sharded axes, in
    place: one ``all_reduce`` per such mesh axis."""
    amap = axis_map(x)
    for m in sorted({amap[a] for a in axes if a in amap}):
        dist.all_reduce(_real_view(block), group=x.device_mesh.get_group(m))
    return block
