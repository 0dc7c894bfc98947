"""The program's spans and counters in one cell, beside the benchmark's own
traced stretches (not run by the benchmark).

    python3 benchmark/spans.py --workload <cell> --seed <n> [--seconds 5]

Sets the cell up as a run does (the same inputs, entry and warm-up) and
logs the program's ``telemetry.snapshot()`` after the warm-up.  Then, in
the window's loop: ``--seconds`` of calls with no profiler (their mean wall
time a call), the timing and attributed stretches of a traced run
(``runner._traced``), and the span stretch (``harness/spans.stretch``):
device activity alone, at least ``runner.TRACE_SECONDS`` of calls, the
program recording its spans.  Last, one call recorded and one not, on the
same inputs, compared bit for bit.  Prints one JSON line: the span
stretch's readings (``harness/spans.read``), its wall time a call against
the timing stretch's and, call by call, recorded against not (the cost of
recording), the device ms by layer from
the spans and from the Python stacks, the idle gaps before each call's
first launch split into the benchmark's part and the program's, and the
card's name and power limit.  Exits with another code than 0 without a
CUDA device or without the program's ``telemetry``.
"""

import json
import sys
from dataclasses import asdict
from pathlib import Path

BENCH = Path(__file__).resolve().parent
ROOT = BENCH.parent
PAIRS = 20


def _paired_cost_ms(program, dev, tm, first: int, pairs: int) -> list:
    """Recording's cost, call by call with no profiler: the quartiles of
    (wall ms of a call recorded) - (of the same call not recorded) over
    ``pairs`` pairs, each a call index of its own, the recorded call first
    in every other pair; each call ends in a synchronize."""
    import statistics
    import time

    diffs = []
    for k in range(pairs):
        wall = {}
        for on in ((True, False) if k % 2 else (False, True)):
            t0 = time.perf_counter()
            if on:
                with tm.recording():
                    program(first + k)
            else:
                program(first + k)
            dev.sync()
            wall[on] = (time.perf_counter() - t0) * 1e3
        diffs.append(wall[True] - wall[False])
    return statistics.quantiles(diffs, n=4)


def main(argv=None, root: Path = ROOT, make_device=None) -> int:
    """One cell; ``root`` and ``make_device`` are for the harness's tests,
    which run tiny cells on the CPU."""
    import argparse

    p = argparse.ArgumentParser()
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, default=5.0)
    args = p.parse_args(argv)
    for path in (str(BENCH), str(ROOT)):
        if path not in sys.path:
            sys.path.insert(0, path)
    import torch
    from harness import cells, device, inputs, runner, spans, trace

    cell = cells.load(root, args.workload, bench=root / BENCH.name)
    import xrft_tpu_torch as xt
    tm = getattr(xt, "telemetry", None)
    if tm is None:
        runner.log("this checkout's xrft_tpu_torch has no telemetry")
        return 3
    try:
        dev = (make_device or device.Cuda)(cell.chips)
    except device.NoCard as e:
        runner.log(str(e))
        return 2
    ins = inputs.make(cell.config, cell.mix, args.seed, dev.device)
    program = runner.Program(xt, cell, ins)
    for i in range(spans.WARM_UP):
        program(i)
        dev.sync()
    runner.log(f"after the warm-up: {json.dumps(tm.snapshot())}")

    window, out, last, _ = runner._window(program, dev, args.seconds,
                                          spans.WARM_UP, -1, 0)
    out = None
    patterns = {}
    for m in cell.per_layer:
        patterns.update(getattr(m.reader, "KERNEL_LAYERS", {}))
    summary, out, last = runner._traced(program, dev, last + 1,
                                        trace.load_layer_map(), patterns)
    out = None
    st, out = spans.stretch(program, dev, last + 1, tm,
                            runner.TRACE_SECONDS)
    out = None
    reading = spans.read(st)

    i = last + 1 + st.calls
    off = program(i).data.cpu()
    with tm.recording():
        on = program(i).data.cpu()
    paired = _paired_cost_ms(program, dev, tm, i + 1, PAIRS)
    line = {
        "workload": cell.name, "seed": args.seed,
        "window_wall_ms": runner._mean_wall_ms(window),
        "timing_wall_ms": summary.call_wall_s * 1e3,
        "span_wall_ms": reading.wall_ms,
        "recording_cost": reading.wall_ms / (summary.call_wall_s * 1e3) - 1,
        "paired_cost_ms": paired,
        "timing_idle_share": 100 * (1 - summary.busy_s / summary.window_s),
        "stack_layer_ms": {k: summary.layer_ms_per_call(k)
                           for k in summary.layer_s},
        "span_layer_ms": spans.layer_ms(reading.device_ms),
        "spans": asdict(reading),
        "bit_identical": bool(torch.equal(off, on)),
        "snapshot": tm.snapshot(),
        "device": dev.name(), "card": dev.card_line(),
    }
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
