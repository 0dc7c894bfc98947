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
frequency names and the last of these.
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
