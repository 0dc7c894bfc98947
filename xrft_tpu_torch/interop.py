"""Carry labeled data between xrft_tpu and this package.

A field and its coordinates are the only state the spectral pipelines hold,
so this is the counterpart of converting weights.  Neither function imports
``xrft_tpu``: the reference object is read by duck typing.
"""

from __future__ import annotations

import numpy as np
import torch

from .labeled import Coord, LabeledArray, resolve_device

__all__ = ["from_reference", "to_numpy"]


def from_reference(la, device=None) -> LabeledArray:
    """An ``xrft_tpu.LabeledArray`` (or any object with ``.values``,
    ``.dims``, ``.coords`` of objects with ``.dims``/``.values``/``.attrs``,
    ``.attrs`` and ``.name``) as this package's LabeledArray, with its data
    on ``device`` (default: the CUDA device, see
    :func:`~xrft_tpu_torch.labeled.resolve_device`)."""
    data = torch.as_tensor(np.array(la.values), device=resolve_device(device))
    coords = {name: Coord(c.dims, np.array(c.values), dict(c.attrs), name)
              for name, c in la.coords.items()}
    return LabeledArray(data, dims=tuple(la.dims), coords=coords,
                        attrs=dict(la.attrs), name=la.name)


def to_numpy(la: LabeledArray) -> dict:
    """The keyword arguments that rebuild ``la`` as an
    ``xrft_tpu.LabeledArray`` (``xrft_tpu.LabeledArray(**to_numpy(la))``):
    host numpy data, dims, coords as ``(dims, values, attrs)`` tuples,
    attrs and name."""
    return {
        "data": la.values,
        "dims": tuple(la.dims),
        "coords": {name: (c.dims, np.array(c.values), dict(c.attrs))
                   for name, c in la.coords.items()},
        "attrs": dict(la.attrs),
        "name": la.name,
    }
