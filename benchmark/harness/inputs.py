"""The one general generator: a cell's inputs, coordinates and keyword
arguments, made from its configuration, its traffic mix and the seed.

Two stacks of the configuration's shape are made on the device from one
``torch.Generator`` seeded with ``--seed``, a stack in one call.  The mix's
``input`` says what the entry takes: ``field``, the stacks themselves
(mean + std N(0, 1)); ``half_spectrum``, the one-sided 2-D spectrum of each
stack over its two trailing dims (``freq_order`` "shifted": the first of
them fftshifted, as a user's spectrum is stored).  Calls alternate the
stacks; a mix with ``fields_per_call`` walks each stack in blocks of that
many fields.  Strings ``{space}``, ``{freq_space}`` and ``{freq_last}`` in
the mix's kwargs stand for the configuration's two trailing dims, their
frequency names and the last of these; a mix may also name its dims
literally.

A mix that names a ``mesh`` runs across ranks (:func:`make_sharded`): each
rank makes only its own block of each stack, from slabs of one index along
the first sharded dim, each slab drawn by a generator seeded from (seed,
stack, slab).  The global array is a function of the seed alone, so 1, 2 and
4 ranks hold the same data bit for bit, and any rank can make any slab
again for the reference.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

PREFIX = "freq_"


def coordinate(spec: dict, n: int) -> np.ndarray:
    """start + k num / den, k = 0 .. n-1, in float64."""
    return spec["start"] + np.arange(n) * spec["num"] / spec["den"]


def spacing(spec: dict) -> float:
    return spec["num"] / spec["den"]


@dataclass
class Inputs:
    stacks: list               # two tensors, each the whole stack
    dims: tuple
    coords: dict               # name -> numpy array over the whole stack
    kwargs: dict
    fields: int                # fields a call takes

    def blocks(self) -> int:
        return self.stacks[0].shape[0] // self.fields

    def schedule(self, i: int) -> tuple[int, int]:
        """(stack, first field) of call ``i``."""
        return i % 2, ((i // 2) % self.blocks()) * self.fields

    def args(self, i: int):
        """(data, coords) of call ``i``: a view of the stack's block and
        the coordinates over it."""
        s, lo = self.schedule(i)
        hi = lo + self.fields
        lead = self.dims[0]
        coords = {c: (v[lo:hi] if c == lead else v)
                  for c, v in self.coords.items()}
        return self.stacks[s][lo:hi], coords


def resolve_kwargs(kwargs: dict, space: list) -> dict:
    subs = {"{space}": list(space),
            "{freq_space}": [PREFIX + d for d in space],
            "{freq_last}": PREFIX + space[-1]}
    return {k: subs.get(v, v) if isinstance(v, str) else v
            for k, v in kwargs.items()}


def _generator(seed: int, device) -> torch.Generator:
    g = torch.Generator(device=device)
    g.manual_seed(int(seed))
    return g


def _field(shape, law: dict, g, device, dtype) -> torch.Tensor:
    x = torch.randn(shape, generator=g, device=device, dtype=dtype)
    if law.get("std", 1.0) != 1.0:
        x.mul_(law["std"])
    if law.get("mean", 0.0) != 0.0:
        x.add_(law["mean"])
    return x


def _half_spectrum(x: torch.Tensor, shifted: bool,
                   block: int = 8) -> torch.Tensor:
    b, ny, nx = x.shape
    out = torch.empty((b, ny, nx // 2 + 1), device=x.device,
                      dtype=torch.complex64 if x.dtype == torch.float32
                      else torch.complex128)
    for lo in range(0, b, block):
        f = torch.fft.rfft2(x[lo:lo + block])
        out[lo:lo + block] = torch.fft.fftshift(f, dim=-2) if shifted else f
    return out


def make(config: dict, mix: dict, seed: int, device) -> Inputs:
    shape = tuple(config["shape"])
    dims = tuple(config["dims"])
    dtype = getattr(torch, config["dtype"])
    space = list(dims[-2:])
    coords = {d: coordinate(config["coords"][d], n)
              for d, n in zip(dims, shape)}
    g = _generator(seed, device)
    if mix["input"] == "field":
        stacks = [_field(shape, config["field"], g, device, dtype)
                  for _ in range(2)]
    elif mix["input"] == "half_spectrum":
        shifted = mix.get("freq_order", "natural") == "shifted"
        stacks = []
        for _ in range(2):
            stacks.append(_half_spectrum(
                _field(shape, config["field"], g, device, dtype), shifted))
        ny, nx = shape[-2:]
        dy, dx = (spacing(config["coords"][d]) for d in space)
        fy = np.fft.fftfreq(ny, dy)
        lead = {d: coords[d] for d in dims[:-2]}
        coords = dict(lead, **{
            PREFIX + space[0]: np.fft.fftshift(fy) if shifted else fy,
            PREFIX + space[1]: np.fft.rfftfreq(nx, dx)})
        dims = dims[:-2] + tuple(PREFIX + d for d in space)
    else:
        raise ValueError(f"unknown input kind {mix['input']!r}")
    fields = mix.get("fields_per_call") or shape[0]
    if shape[0] % fields:
        raise ValueError(f"{fields} fields a call do not divide the stack "
                         f"of {shape[0]}")
    return Inputs(stacks, dims, coords,
                  resolve_kwargs(mix["kwargs"], space), fields)


def chunk_range(n: int, parts: int, r: int) -> tuple:
    """[start, stop) of block r of an axis of extent n cut into ``parts``
    as ``torch.distributed.tensor.Shard`` cuts it (``torch.chunk``)."""
    c = -(-n // parts)
    start = min(r * c, n)
    return start, min(start + c, n)


def slab_seed(seed: int, stack: int, k: int) -> int:
    """The generator seed of slab ``k`` of stack ``stack``: 63 bits of
    numpy's SeedSequence over (seed, stack, k), so every slab draws apart
    and no rank count changes it."""
    words = np.random.SeedSequence([int(seed) % 2 ** 64, stack, k]) \
        .generate_state(2, np.uint32)
    return (int(words[0]) << 31) ^ int(words[1])


@dataclass
class ShardedInputs:
    """A rank's share of a sharded cell's inputs."""
    stacks: list               # this rank's block of each of the two stacks
    shape: tuple               # the global array's
    dims: tuple
    coords: dict               # name -> numpy array over the global array
    kwargs: dict
    dim_shards: dict           # dim -> mesh axis
    slab_axis: int             # the axis the slabs cut
    seed: int
    law: dict                  # the configuration's field: mean, std
    dtype: torch.dtype
    device: object

    @property
    def fields(self) -> int:
        """Fields a call takes: the lead dim of the global array."""
        return self.shape[0]

    def args(self, i: int):
        """(this rank's block, the global coordinates) of call ``i``."""
        return self.stacks[i % 2], self.coords

    def slab(self, stack: int, k: int) -> torch.Tensor:
        """Index ``k`` along the slab axis of the global array of stack
        ``stack``: the global shape less that axis, made again from the
        seed on this rank's device."""
        shape = self.shape[:self.slab_axis] + self.shape[self.slab_axis + 1:]
        g = _generator(slab_seed(self.seed, stack, k), self.device)
        return _field(shape, self.law, g, self.device, self.dtype)


def make_sharded(config: dict, mix: dict, seed: int, device,
                 mesh_sizes: dict, position: dict) -> ShardedInputs:
    """This rank's inputs of a cell whose mix names ``mesh`` and
    ``dim_shards``: ``mesh_sizes`` is {mesh axis: size}, ``position``
    this rank's index on each mesh axis."""
    if mix["input"] != "field" or mix.get("fields_per_call"):
        raise ValueError("a sharded mix takes the whole field stack a call "
                         "(input 'field', fields_per_call null)")
    shape = tuple(config["shape"])
    dims = tuple(config["dims"])
    dim_shards = dict(mix["dim_shards"])
    unknown = set(dim_shards) - set(dims)
    if unknown or set(dim_shards.values()) - set(mesh_sizes):
        raise ValueError(f"dim_shards {dim_shards} name dims or mesh axes "
                         f"that {dims} and the mesh {mesh_sizes} lack")
    ranges = [(0, n) for n in shape]
    for d, m in dim_shards.items():
        a = dims.index(d)
        ranges[a] = chunk_range(shape[a], mesh_sizes[m], position[m])
    slab_axis = min(dims.index(d) for d in dim_shards)
    coords = {d: coordinate(config["coords"][d], n)
              for d, n in zip(dims, shape)}
    ins = ShardedInputs([], shape, dims, coords,
                        resolve_kwargs(mix["kwargs"], list(dims[-2:])),
                        dim_shards, slab_axis, seed,
                        config["field"], getattr(torch, config["dtype"]),
                        device)
    lo, hi = ranges[slab_axis]
    cut = tuple(slice(a, b) for a, b in ranges[:slab_axis]
                + ranges[slab_axis + 1:])
    local = tuple(b - a for a, b in ranges)
    for s in range(2):
        block = torch.empty(local, dtype=ins.dtype, device=device)
        for k in range(lo, hi):
            block.select(slab_axis, k - lo).copy_(ins.slab(s, k)[cut])
        ins.stacks.append(block)
    return ins
