"""The comparison that decides ``correct``: what the timed path produced
against the plain reference, worked out again from the inputs the
benchmark handed the program, field block by field block so that it fits
beside the program's output.

Numbers compared, each with its limit: ``rel_err``, the largest
|out - ref| over the largest |ref| of the compared answers (the limit is
the cell's, ``limits/<cell>.json``); ``dims_mismatch``, ``dtype_mismatch``
and ``coord_mismatch`` (coordinate values that differ, or are missing),
all exact, limit 0.
"""

from __future__ import annotations

import numpy as np
import torch

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
