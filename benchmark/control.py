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
"""

import json
import sys
import time
from pathlib import Path

BENCH = Path(__file__).resolve().parent
ROOT = BENCH.parent


def main(argv=None) -> int:
    import argparse

    p = argparse.ArgumentParser()
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--control-seeds", default="")
    args = p.parse_args(argv)
    sys.path.insert(0, str(BENCH))
    sys.path.insert(1, str(ROOT))
    from harness import cells, compare, device, inputs, runner

    cell = cells.load(ROOT, args.workload)
    import torch
    import xrft_tpu_torch as xt
    dev = device.Cuda(cell.chips)
    runner.log(f"card: {dev.card_line()}")
    ref = cells.entry_module("reference", cell.mix["entry"])
    lower = cell.limits["rel_err"]["control"]
    control_seeds = {int(s) for s in args.control_seeds.split(",") if s}
    worst, least, half = 0.0, float("inf"), float("inf")
    for seed in (int(s) for s in args.seeds.split(",")):
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


if __name__ == "__main__":
    sys.exit(main())
