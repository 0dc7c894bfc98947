"""Utility functions (counterpart of ``xrft_tpu/utils.py``), and
:func:`along`, the way the port's modules place a host constant on the
data's device."""

from __future__ import annotations

import numpy as np
import torch

from .coords import diff_coord
from .labeled import Coord

__all__ = ["get_spacing"]


def get_spacing(coord: Coord):
    """Return the spacing of an evenly spaced coordinate array; raise if
    unevenly spaced."""
    diff = diff_coord(coord)
    if not np.allclose(diff, diff[0]):
        raise ValueError(
            f"Found unevenly spaced coordinates '{coord.name}'. "
            "These coordinates should be evenly spaced."
        )
    return diff[0]


def along(values, like: torch.Tensor, axis: int, dtype=None) -> torch.Tensor:
    """The host 1-D ``values`` as a tensor on ``like``'s device, shaped to
    broadcast along ``axis`` of ``like``, in ``dtype`` (default: the real
    dtype of ``like``)."""
    shape = [1] * like.ndim
    shape[axis] = len(values)
    return torch.as_tensor(np.asarray(values).reshape(shape),
                           dtype=like.real.dtype if dtype is None else dtype,
                           device=like.device)
