"""The comparison that decides ``correct``: what the timed path produced
against the plain reference, worked out again from the inputs the
benchmark handed the program, field block by field block so that it fits
beside the program's output.

Numbers compared, each with its limit: ``rel_err``, the largest
|out - ref| over the largest |ref| of the compared answers (the limit is
the cell's, ``limits/<cell>.json``); ``dims_mismatch``, ``dtype_mismatch``
and ``coord_mismatch`` (coordinate values that differ, or are missing),
all exact, limit 0.

A sharded output (a cell whose mix names a ``mesh``) is not gathered: each
rank compares planes of its own block (:func:`pick_plane`), one of the last
call and one of the sampled call, each at one index of one transform dim
and of every other dim, drawn from the seed and lying in the rank's block,
and whole along the other transform dims as far as the rank holds them.  The
cell's reference works each plane out from the whole input, made again slab
by slab from the seed (``reference.<entry>.plane``); ``rel_err`` is the
largest |out - ref| over the largest |ref| of every rank's compared part.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from .inputs import chunk_range

BLOCK_BYTES = 1 << 30          # complex128 working set of one block


def block_fields(shape) -> int:
    per_field = int(np.prod(shape[1:])) * 16
    return max(1, BLOCK_BYTES // per_field)


def max_abs_err(candidate, x, coords, dims, kwargs, ref) -> tuple[float,
                                                                  float]:
    """(max |candidate - ref|, max |ref|) over the fields of ``x``, the
    input; ``candidate(lo, hi)`` gives the answer for fields lo:hi."""
    err = top = 0.0
    step = block_fields(x.shape)
    for lo in range(0, x.shape[0], step):
        hi = min(lo + step, x.shape[0])
        want = ref.values(x[lo:hi], coords, dims, kwargs).to(torch.float64)
        got = candidate(lo, hi).to(torch.float64)
        if got.shape != want.shape:
            return float("inf"), 1.0
        e = (got - want).abs().max().item()
        err = max(err, e if e == e else float("inf"))   # NaN fails
        top = max(top, want.abs().max().item())
        del want, got
    return err, top


def label_mismatch(out, x, coords, dims, kwargs, ref) -> dict:
    """dims, dtype and coordinate values of the output against the
    reference's."""
    want_dims, want_coords = ref.labels(dims, coords, kwargs)
    bad = 0
    for name, want in want_coords.items():
        got = out.coords.get(name)
        got = None if got is None else np.asarray(got.values)
        if got is None or got.shape != want.shape:
            bad += want.size
        else:
            bad += int(np.count_nonzero(got != want))
    return {
        "dims_mismatch": int(tuple(out.dims) != tuple(want_dims)),
        "dtype_mismatch": int(out.data.dtype
                              != ref.out_dtype(x.dtype, kwargs)),
        "coord_mismatch": bad,
    }


def checks(answers, ref, limits: dict) -> dict:
    """The checks of a run.  ``answers`` is a list of (candidate, x,
    coords, dims, kwargs, labelled) with ``labelled`` the output
    LabeledArray to hold to the labels, or None."""
    err = top = 0.0
    labels = {"dims_mismatch": 0, "dtype_mismatch": 0, "coord_mismatch": 0}
    for candidate, x, coords, dims, kwargs, labelled in answers:
        e, t = max_abs_err(candidate, x, coords, dims, kwargs, ref)
        err, top = max(err, e), max(top, t)
        if labelled is not None:
            for k, v in label_mismatch(labelled, x, coords, dims, kwargs,
                                       ref).items():
                labels[k] += v
    rel = err / top if top > 0 else float("inf")
    out = {"rel_err": {"value": rel, "limit": limits["rel_err"]["limit"]}}
    for k, v in labels.items():
        out[k] = {"value": v, "limit": 0}
    return out


def passed(result: dict) -> bool:
    return all(c["value"] <= c["limit"] for c in result.values())


def local_ranges(x) -> list:
    """[lo, hi) of each axis of ``x`` that this rank holds: the whole axis
    unless a ``Shard`` placement of the DTensor cuts it (``torch.chunk``'s
    cut, in mesh-dim order where two mesh dims cut one axis)."""
    ranges = [(0, n) for n in x.shape]
    placements = getattr(x, "placements", None)
    if placements is None:
        return ranges
    mesh = x.device_mesh
    position = mesh.get_coordinate()
    for m, p in enumerate(placements):
        if p.is_shard():
            lo, hi = ranges[p.dim]
            a, b = chunk_range(hi - lo, mesh.size(m), position[m])
            ranges[p.dim] = (lo + a, lo + b)
    return ranges


@dataclass
class Plane:
    """A compared part of a sharded output: ``at`` fixes one index of each
    axis it names; of the other axes, in order, this rank holds ``ranges``,
    with the output's ``values`` there."""
    call: int
    at: dict
    ranges: list
    values: torch.Tensor


def pick_plane(out, call: int, transform_axes: list, rng) -> Plane | None:
    """A plane of this rank's block of ``out`` (a LabeledArray over a
    DTensor), drawn by ``rng``: an index of the first transform axis that is
    sharded (else of the first transform axis) and of every other axis, in
    this rank's ranges; None where the rank holds nothing."""
    data = out.data
    ranges = local_ranges(data)
    if any(lo >= hi for lo, hi in ranges):
        return None
    cut = [a for a in transform_axes if ranges[a] != (0, data.shape[a])]
    axis = (cut or transform_axes)[0]
    at = {a: rng.randrange(*ranges[a]) for a in range(data.ndim)
          if a == axis or a not in transform_axes}
    block = data.to_local() if hasattr(data, "to_local") else data
    index = tuple(at[a] - ranges[a][0] if a in at else slice(None)
                  for a in range(data.ndim))
    return Plane(call, at, [r for a, r in enumerate(ranges) if a not in at],
                 block[index].clone())


def plane_err(plane: Plane, want: torch.Tensor) -> tuple[float, float]:
    """(max |plane - want|, max |want|) over the part of the reference's
    whole plane ``want`` that the rank holds."""
    want = want[tuple(slice(lo, hi) for lo, hi in plane.ranges)]
    got = plane.values.to(torch.float64)
    if got.shape != want.shape:
        return float("inf"), 1.0
    want = want.to(torch.float64)
    e = (got - want).abs().max().item()
    return (e if e == e else float("inf")), want.abs().max().item()
