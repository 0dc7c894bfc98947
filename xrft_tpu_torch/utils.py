"""Utility functions (counterpart of ``xrft_tpu/utils.py``)."""

from __future__ import annotations

import numpy as np

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
