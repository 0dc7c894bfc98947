"""Readings that set a cell's correctness limit (not run by the benchmark).

    python3 benchmark/control.py --workload <cell> --seeds 1,2,... [--control-seeds 1,2,3]

For each seed: the cell's inputs, made as a run makes them; the program's
call on each stack, at the cell's size, through the window's own entry and
keyword arguments, held to the plain reference (``rel_err``, as a run
computes it); and, for the control seeds, the control: the reference put in
the program's place and computed in the cell's lower precision
(``limits/<cell>.json``'s ``control``), and a fault planted in the
program: its output stored through float16 (``half_output``), the
bandwidth trick a later change to the epilogue might try.  One JSON line a
seed, then the largest program reading and the smallest control and fault
readings.

A cell whose mix names a ``mesh`` runs through the run's own launcher
(``harness/ranks``), one process per card: each rank reads, for each call,
the planes of its own block that a run compares (``harness/compare``), and
the control and the float16-stored output at the same planes; rank 0 prints
the readings, each the largest over the ranks' compared parts.
"""

import json
import sys
import time
from pathlib import Path

BENCH = Path(__file__).resolve().parent
ROOT = BENCH.parent


def main(argv=None, root: Path = ROOT, launch=None) -> int:
    """``root`` and ``launch`` (``harness.ranks.Launch``) are for the
    harness's tests, which run tiny cells on the CPU."""
    import argparse

    p = argparse.ArgumentParser()
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--control-seeds", default="")
    args = p.parse_args(argv)
    sys.path.insert(0, str(BENCH))
    sys.path.insert(1, str(ROOT))
    from harness import cells, compare, device, inputs, runner

    cell = cells.load(root, args.workload, bench=root / BENCH.name)
    if "mesh" in cell.mix:
        from harness import ranks

        opts = launch or ranks.Launch()
        try:
            rc, _ = ranks.launch(
                _rank, (ROOT, root, cell.name, _seeds(args.seeds),
                        set(_seeds(args.control_seeds))), cell.chips, opts,
                runner.log)
        except device.NoCard as e:
            runner.log(str(e))
            return 2
        return rc
    import torch
    import xrft_tpu_torch as xt
    dev = device.Cuda(cell.chips)
    runner.log(f"card: {dev.card_line()}")
    ref = cells.entry_module("reference", cell.mix["entry"])
    lower = cell.limits["rel_err"]["control"]
    control_seeds = set(_seeds(args.control_seeds))
    worst, least, half = 0.0, float("inf"), float("inf")
    for seed in _seeds(args.seeds):
        t0 = time.perf_counter()
        ins = inputs.make(cell.config, cell.mix, seed, dev.device)
        program = runner.Program(xt, cell, ins)
        line = {"seed": seed, "program": [], "labels": 0}
        for i in range(2):
            # the reference's blocks leave the cache in pieces; a call
            # that fills the card (the hp cell) needs it whole again
            torch.cuda.empty_cache()
            out = program(i)
            dev.sync()
            x, coords = ins.args(i)
            chk = compare.checks([(lambda lo, hi: out.data[lo:hi], x, coords,
                                   ins.dims, ins.kwargs, out)], ref,
                                 cell.limits)
            line["program"].append(chk.pop("rel_err")["value"])
            line["labels"] += sum(c["value"] for c in chk.values())
            if i == 0 and seed in control_seeds:
                e, t = compare.max_abs_err(
                    lambda lo, hi: out.data[lo:hi].to(torch.float16),
                    x, coords, ins.dims, ins.kwargs, ref)
                line["half_output"] = e / t
                half = min(half, e / t)
            out = None
        worst = max([worst] + line["program"])
        if seed in control_seeds:
            x, coords = ins.args(0)
            e, t = compare.max_abs_err(
                lambda lo, hi: ref.values(x[lo:hi], coords, ins.dims,
                                          ins.kwargs, lower),
                x, coords, ins.dims, ins.kwargs, ref)
            line["control"] = e / t
            line["control_precision"] = lower
            least = min(least, e / t)
        line["seconds"] = time.perf_counter() - t0
        print(json.dumps(line), flush=True)
        del ins, program
    print(json.dumps({"workload": cell.name, "program_max": worst,
                      "control_min": least, "half_output_min": half,
                      "limit": cell.limits["rel_err"]["limit"]}), flush=True)
    return 0


def _seeds(text: str) -> list:
    return [int(s) for s in text.split(",") if s]


def _rank(team, dev, checkout, root, name, seeds, control_seeds):
    """One rank of a sharded cell's readings: the program's two calls a
    seed, each rank's planes of them held to the reference, and at the
    control seeds the control and the float16-stored output at the planes
    of the first call."""
    import random
    from dataclasses import replace

    import torch

    from harness import cells, compare, inputs, runner

    try:
        xt = runner.load_port(checkout)
    except runner.PortMissing as e:
        runner.log(str(e))
        raise SystemExit(3)
    import xrft_tpu_torch.parallel  # noqa: F401  (xt.parallel)
    cell = cells.load(root, name, bench=root / BENCH.name)
    if team.rank == 0:
        runner.log(f"card: {dev.card_line()}")
    mesh = xt.parallel.make_mesh(cell.mix["mesh"], device=dev.device)
    names = list(mesh.mesh_dim_names)
    ref = cells.entry_module("reference", cell.mix["entry"])
    lower = cell.limits["rel_err"]["control"]
    worst, least, half = 0.0, float("inf"), float("inf")

    def rel(e_t):
        e, t = team.max(e_t)
        return e / t if t > 0 else float("inf")

    for seed in seeds:
        t0 = time.perf_counter()
        ins = inputs.make_sharded(cell.config, cell.mix, seed, dev.device,
                                  dict(zip(names, mesh.shape)),
                                  dict(zip(names, mesh.get_coordinate())))
        program = runner.ShardedProgram(xt, cell, ins, mesh)
        pick = random.Random(seed * 4099 + team.rank)
        axes = sorted(ins.dims.index(d) for d in ins.kwargs["dim"])
        line = {"seed": seed, "program": [], "labels": 0}
        for i in range(2):
            out = program(i)
            dev.sync()
            p = compare.pick_plane(out, i, axes, pick)
            labels = compare.label_mismatch(out, ins.stacks[0], ins.coords,
                                            ins.dims, ins.kwargs, ref)
            out = None
            line["labels"] += int(sum(team.max(list(labels.values()))))
            want = None if p is None else ref.plane(
                lambda k, s=i: ins.slab(s, k), ins.shape, ins.slab_axis,
                ins.dims, ins.coords, ins.kwargs, p.at)

            def read(values):
                """The largest |values - want| over the largest |want| of
                every rank's plane."""
                return rel([0.0, 0.0] if p is None else list(
                    compare.plane_err(replace(p, values=values), want)))

            line["program"].append(read(p and p.values))
            if i == 0 and seed in control_seeds:
                line["half_output"] = read(p and p.values.to(torch.float16))
                line["control"] = read(p and ref.plane(
                    lambda k: ins.slab(0, k), ins.shape, ins.slab_axis,
                    ins.dims, ins.coords, ins.kwargs, p.at, lower)[
                    tuple(slice(lo, hi) for lo, hi in p.ranges)])
                line["control_precision"] = lower
                half = min(half, line["half_output"])
                least = min(least, line["control"])
        worst = max([worst] + line["program"])
        line["seconds"] = time.perf_counter() - t0
        if team.rank == 0:
            print(json.dumps(line), flush=True)
        del ins, program
    if team.rank == 0:
        print(json.dumps({"workload": cell.name, "program_max": worst,
                          "control_min": least, "half_output_min": half,
                          "limit": cell.limits["rel_err"]["limit"]}),
              flush=True)


if __name__ == "__main__":
    sys.exit(main())
