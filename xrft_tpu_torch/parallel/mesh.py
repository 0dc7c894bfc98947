"""Mesh construction and LabeledArray sharding helpers.

Counterpart of ``xrft_tpu/parallel/mesh.py`` on ``torch.distributed``: a
mesh is a ``DeviceMesh`` over the default process group, and a sharded
LabeledArray holds a ``DTensor`` with one ``Shard`` placement per mesh axis
that carries a dim.  Batch (non-transform) dims shard with no collective;
transform dims go through the pencil decomposition of :mod:`.pencil`.

The caller, or ``torchrun``, initializes the process group: NCCL for CUDA
meshes, gloo for CPU ones.  One card is a one-rank NCCL group
(``dist.init_process_group("nccl", store=dist.HashStore(), rank=0,
world_size=1, device_id=torch.device("cuda", 0))``).
"""

from __future__ import annotations

import os
import warnings
import weakref

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh
from torch.distributed.tensor import distribute_tensor

from ..labeled import LabeledArray, resolve_device
from ..ops import shards

__all__ = ["make_mesh", "shard_labeled", "spec_for", "axis_links"]


def make_mesh(axis_shapes: dict | None = None, device=None) -> DeviceMesh:
    """A DeviceMesh over every rank of the default process group.

    ``axis_shapes``: mesh-axis name to size, e.g. ``{"data": 2, "fft": 4}``
    (default: one axis named "data" over all ranks).  The mesh lives on the
    CUDA device (NCCL) unless ``device`` asks for the CPU (gloo).

    Topology hints, as ``xrft_tpu.parallel.make_mesh``: a value may be
    ``(size, link)`` with link "ici" (within a host, fast) or "dcn" (between
    hosts), e.g. ``{"dp": (2, "dcn"), "fp": (8, "ici")}``.  DCN axes are
    made outermost, so each ICI axis's ranks are consecutive (one host under
    torchrun's rank order), and the link map is recorded for the pencil
    planner (:func:`axis_links`).
    """
    if not dist.is_available() or not dist.is_initialized():
        raise RuntimeError(
            "make_mesh needs the default process group: call "
            "torch.distributed.init_process_group (or run under torchrun) "
            "first")
    if axis_shapes is None:
        axis_shapes = {"data": dist.get_world_size()}
    sizes, links = {}, {}
    had_hints = False
    for name, v in axis_shapes.items():
        if isinstance(v, tuple):
            size, link = v
            had_hints = True
            if link not in ("ici", "dcn"):
                raise ValueError(f"unknown link type {link!r} for mesh axis "
                                 f"{name!r} (expected 'ici' or 'dcn')")
        else:
            size, link = v, "ici"
        sizes[name] = int(size)
        links[name] = link
    order = sorted(sizes, key=lambda n: 0 if links[n] == "dcn" else 1)
    shape = tuple(sizes[n] for n in order)
    if int(np.prod(shape)) != dist.get_world_size():
        raise ValueError(f"mesh {dict(zip(order, shape))} has "
                         f"{int(np.prod(shape))} ranks; the process group "
                         f"has {dist.get_world_size()}")
    mesh = init_device_mesh(resolve_device(device).type, shape,
                            mesh_dim_names=tuple(order))
    # an unhinted call registers nothing: it states no topology, and a
    # registration would silence axis_links' warning for a multi-host mesh;
    # meshes compare equal by ranks and names, so a hinted call that
    # conflicts with a live registration of an equal mesh warns
    if not had_hints:
        return mesh
    prev = _MESH_LINKS.get(mesh)
    if prev is not None and prev != links:
        warnings.warn(
            f"make_mesh: replacing topology hints {prev} with {links} for "
            f"an equal mesh also in use elsewhere; pencil plans built from "
            f"the earlier handle will see the new link map.",
            RuntimeWarning, stacklevel=2)
    _MESH_LINKS[mesh] = dict(links)
    return mesh


_MESH_LINKS: "weakref.WeakKeyDictionary[DeviceMesh, dict]" = \
    weakref.WeakKeyDictionary()
# meshes already warned about missing hints on a multi-host group
_WARNED_UNHINTED: "weakref.WeakSet[DeviceMesh]" = weakref.WeakSet()


def _hosts(mesh: DeviceMesh) -> int:
    """Hosts the mesh spans: its ranks over ``LOCAL_WORLD_SIZE`` (the ranks
    of one host, which torchrun sets); 1 when that is unset."""
    local = int(os.environ.get("LOCAL_WORLD_SIZE", "0") or 0)
    return max(mesh.size() // local, 1) if local > 0 else 1


def axis_links(mesh: DeviceMesh) -> dict:
    """Per-mesh-axis link type ({axis: 'ici'|'dcn'}); axes of meshes built
    without hints default to 'ici'.  A mesh that spans more than one host
    and carries no hints warns once: the all-ICI default may plan
    all_to_alls across hosts (``xrft_tpu/parallel/mesh.py:134-160``)."""
    links = _MESH_LINKS.get(mesh)
    if links is None and mesh not in _WARNED_UNHINTED:
        n_hosts = _hosts(mesh)
        if n_hosts > 1:
            warnings.warn(
                f"mesh spans {n_hosts} hosts but has no topology hints "
                f"registered: pencil plans will assume every axis is ICI, so "
                f"collectives may cross hosts. Build the mesh with "
                f"xrft_tpu_torch.parallel.make_mesh({{axis: (size, "
                f"'ici'|'dcn')}}) to register link types.",
                RuntimeWarning, stacklevel=2)
            _WARNED_UNHINTED.add(mesh)
    links = links or {}
    return {name: links.get(name, "ici") for name in mesh.mesh_dim_names}


def spec_for(da: LabeledArray, dim_shards: dict, mesh: DeviceMesh) -> list:
    """DTensor placements of ``da`` on ``mesh`` from a {dim: mesh_axis}
    mapping (the counterpart of the JAX package's PartitionSpec)."""
    return shards.placements(
        mesh, {da.dims.index(d): m for d, m in dim_shards.items() if m})


def shard_labeled(da: LabeledArray, mesh: DeviceMesh, dim_shards: dict
                  ) -> LabeledArray:
    """``da`` with its data as a DTensor on ``mesh``, sharded per
    {dim: mesh_axis}; unlisted dims are replicated.  Every rank passes the
    same global data and keeps its own block (no collective).  Data already
    sharded so are returned as they are; another sharding raises."""
    for d in dim_shards:
        if d not in da.dims:
            raise ValueError(f"shard dim {d!r} not in array dims {da.dims}")
    want = spec_for(da, dim_shards, mesh)
    data = da.data
    if shards.is_sharded(data):
        if data.device_mesh == mesh and list(data.placements) == want:
            return da
        raise ValueError(
            f"data already sharded as {list(data.placements)} on "
            f"{data.device_mesh}; asked for {want} on {mesh}")
    dev = torch.device(mesh.device_type)
    if dev.type == "cuda":
        dev = torch.device("cuda", torch.cuda.current_device())
    data = distribute_tensor(data.to(dev), mesh, want, src_data_rank=None)
    return da.copy(data=data)
