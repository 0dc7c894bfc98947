"""One run of a cell: set-up, the measured window, the traced stretches
(``--trace 1``), the metrics and the comparison with the plain reference.

The loop is closed with one caller: call i builds a fresh LabeledArray over
the inputs' block (stacks alternate), calls the entry, and waits for the
device with a synchronize; the output is released before the next call.
Each call is timed on the host clock, from its start to its return (the
benchmark's own span) and to the end of the synchronize.  The window runs
until ``seconds`` have passed; the output of its last call is kept, with
one field of a call drawn from the seed among the first four, and both are
compared with the reference once the window has closed.  A traced run
goes on after the window with two profiled stretches in the same loop (see
``trace``); the output of their last call is the one compared.
"""

from __future__ import annotations

import json
import random
import sys
import tempfile
import time
import traceback
from contextlib import nullcontext
from dataclasses import dataclass, field
from pathlib import Path

import torch

from . import cells, compare, inputs, roofline, trace

TRACE_CALLS = 6          # the attributed stretch
TRACE_SECONDS = 0.5      # the timing stretch, at least
SAMPLE_AMONG = 4
FORBIDDEN = ("jax", "jaxlib", "flax", "xrft_tpu")


@dataclass
class Window:
    calls: list = field(default_factory=list)   # (fields, host s, wall s)
    seconds: float = 0.0
    failed: int = 0


@dataclass
class Reading:
    """What the metric readers read."""
    cell: cells.Cell
    work: dict
    window: Window
    setup_s: float
    peak_window_bytes: int | None
    trace: trace.Summary | None = None

    def least_seconds(self, layer: str) -> float | None:
        w = self.work.get(layer)
        return None if w is None else roofline.least_seconds(w)


def log(*args):
    print(*args, file=sys.stderr, flush=True)


def forbidden_modules() -> list:
    """Top-level names in sys.modules, compared whole, that the run must
    not hold."""
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


class Program:
    """The cell's entry point of the port and its inputs."""

    def __init__(self, xt, cell: cells.Cell, ins: inputs.Inputs):
        self.xt = xt
        self.entry = getattr(xt, cell.mix["entry"])
        self.ins = ins

    def __call__(self, i: int):
        data, coords = self.ins.args(i)
        da = self.xt.LabeledArray(data, dims=self.ins.dims, coords=coords)
        return self.entry(da, **self.ins.kwargs)


def _window(program, dev, seconds: float, first: int, sample_at: int,
            sample_field: int):
    """The measured window: calls from index ``first`` until ``seconds``
    have passed; returns (Window, last output, its index, the sample:
    (call, field, values) of field ``sample_field`` of call ``sample_at``)."""
    w = Window()
    out, sample, i = None, None, first
    start = time.perf_counter()
    deadline = start + seconds
    while True:
        out = None                       # released before the next call
        t0 = time.perf_counter()
        try:
            out = program(i)
            t1 = time.perf_counter()
            dev.sync()
        except Exception:                # a failed call ends the window
            log(traceback.format_exc())
            w.failed += 1
            out = None
            break
        t2 = time.perf_counter()
        w.calls.append((program.ins.fields, t1 - t0, t2 - t0))
        if i == sample_at:
            sample = (i, sample_field, out.data[sample_field].clone())
            dev.sync()
        i += 1
        if t2 >= deadline and i > sample_at:
            break
    w.seconds = time.perf_counter() - start
    return w, out, i - 1, sample


def _profiled(program, dev, first: int, stacks: bool, calls: int = 0,
              seconds: float = 0.0):
    """Calls from index ``first`` under torch.profiler: ``calls`` of them,
    or as many as fill ``seconds``, at least two.  With ``stacks`` the
    profiler records host ops and Python stacks inside the stretch
    annotation; without, device activity alone.  Returns (events, calls,
    host seconds of the calls, last output)."""
    from torch.profiler import ProfilerActivity, profile, record_function

    cuda = dev.kind == "cuda"
    acts = [ProfilerActivity.CUDA] if cuda else []
    if stacks or not cuda:
        acts.insert(0, ProfilerActivity.CPU)
    out, i = None, first
    dev.sync()
    with profile(activities=acts, with_stack=stacks) as prof:
        with record_function(trace.STRETCH) if stacks else nullcontext():
            t0 = time.perf_counter()
            while (i - first < max(calls, 2)
                   or time.perf_counter() - t0 < seconds):
                out = None
                out = program(i)
                dev.sync()
                i += 1
            host_s = time.perf_counter() - t0
    with tempfile.TemporaryDirectory() as tmp:
        path = Path(tmp) / "trace.json"
        prof.export_chrome_trace(str(path))
        with open(path) as f:
            events = json.load(f)["traceEvents"]
    return events, i - first, host_s, out


def _traced(program, dev, first: int, layer_map, patterns):
    """The timing stretch (device activity alone, TRACE_SECONDS of calls),
    then the attributed stretch (TRACE_CALLS calls with Python stacks), in
    the window's loop; returns (Summary, last output, its index)."""
    timing, timed, host_s, out = _profiled(program, dev, first, False,
                                           seconds=TRACE_SECONDS)
    out = None                  # released before the next call, as ever
    first += timed
    stacked, calls, _, out = _profiled(program, dev, first, True,
                                       calls=TRACE_CALLS)
    attributed = trace.attribute(stacked, layer_map, patterns)
    return (trace.summarize(timing, host_s, timed, attributed, calls), out,
            first + calls - 1)


def _mean_wall_ms(window: Window) -> float:
    return sum(c[2] for c in window.calls) / max(len(window.calls), 1) * 1e3


def _answers(ins, out, last: int, sample):
    """The compared answers: the last call's whole output, with its labels,
    and the sampled field."""
    x, coords = ins.args(last)
    answers = [(lambda lo, hi: out.data[lo:hi], x, coords, ins.dims,
                ins.kwargs, out)]
    if sample is not None:
        i, j, values = sample
        xs, cs = ins.args(i)
        lead = ins.dims[0]
        cs = {c: (v[j:j + 1] if c == lead else v) for c, v in cs.items()}
        answers.append((lambda lo, hi: values[None], xs[j:j + 1], cs,
                        ins.dims, ins.kwargs, None))
    return answers


def run(cell: cells.Cell, seed: int, seconds: float, traced: bool, dev,
        t0: float, xt=None, marks=None) -> tuple[dict, dict]:
    """One run; returns (result line without ``checks``, checks).
    ``marks`` are (phase, time) pairs of the set-up before the call."""
    if xt is None:
        import xrft_tpu_torch as xt
    ref = cells.entry_module("reference", cell.mix["entry"])
    work_model = cells.entry_module("work", cell.mix["entry"])
    marks = list(marks or [])
    ins = inputs.make(cell.config, cell.mix, seed, dev.device)
    dev.sync()
    marks.append(("inputs", time.perf_counter()))
    program = Program(xt, cell, ins)
    rng = random.Random(seed)
    sample_at = rng.randrange(SAMPLE_AMONG)
    sample_field = rng.randrange(ins.fields)

    # warm-up: every shape the window uses (both stacks, one block)
    for i in range(2):
        program(i)
        dev.sync()
        marks.append((f"warm-up call {i}", time.perf_counter()))
    setup_s = time.perf_counter() - t0
    log("set-up: " + ", ".join(
        f"{name} {t - (marks[k - 1][1] if k else t0):.3f} s"
        for k, (name, t) in enumerate(marks)))
    peak = dev.peak_bytes()
    dev.reset_peak()

    window, out, last, sample = _window(program, dev, seconds, 2,
                                        sample_at + 2, sample_field)
    peak_window = dev.peak_bytes()
    summary = None
    if traced and not window.failed:
        layer_map = trace.load_layer_map()
        patterns = {}
        for m in cell.per_layer:
            patterns.update(getattr(m.reader, "KERNEL_LAYERS", {}))
        out = None              # released before the next call, as ever
        summary, out, last = _traced(program, dev, last + 1, layer_map,
                                     patterns)
        log(f"traced: {summary.call_wall_s * 1e3:.3f} ms a call over "
            f"{summary.timed_calls} calls of the timing stretch, "
            f"{_mean_wall_ms(window):.3f} in the window")
    peaks = [p for p in (peak, peak_window, dev.peak_bytes())
             if p is not None]
    memory_peak = max(peaks) if peaks else None

    work = work_model.layers(ins.args(0)[0].shape, ins.stacks[0].dtype,
                             ins.kwargs)
    reading = Reading(cell, work, window, setup_s, peak_window, summary)
    metrics = {}
    for m in (cell.per_layer if traced else cell.end_to_end):
        v = m.reader.read(reading)
        if v is not None:
            metrics[m.name] = {"value": v, "unit": m.unit}

    attempted = len(window.calls) + window.failed + (
        summary.timed_calls + summary.calls if summary is not None else 0)
    if out is None:
        checks = {"failed_calls": {"value": window.failed, "limit": 0}}
    else:
        checks = compare.checks(_answers(ins, out, last, sample),
                                ref, cell.limits)
    log(f"card: {dev.card_line()}")
    device = {"platform": dev.platform, "kind": dev.name(),
              "count": dev.count, "memory_peak_bytes": memory_peak}
    if summary is not None:
        device["busy_s"] = summary.busy_s
        device["window_s"] = summary.window_s
    result = {"correct": compare.passed(checks) and not window.failed,
              "attempted": attempted, "failed": window.failed,
              "metrics": metrics, "device": device}
    if summary is not None:
        result["breakdown"] = trace.breakdown(summary)
    return result, checks
