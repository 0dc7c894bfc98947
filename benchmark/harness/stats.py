"""Order statistics of a run's samples."""

from __future__ import annotations

import math


def percentile(values, q: float) -> float:
    """The nearest-rank q-th percentile: the smallest sample that at least
    q% of all samples do not exceed."""
    xs = sorted(values)
    if not xs:
        raise ValueError("no samples")
    return xs[max(0, math.ceil(q / 100.0 * len(xs)) - 1)]

