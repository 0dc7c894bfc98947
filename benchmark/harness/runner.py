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

A cell whose mix names a ``mesh`` runs the same loop on every rank
(:func:`run_rank`, started by ``ranks.launch``): each call ends with the
rank's synchronize and a control message, so that rank 0's clock decides
when every rank stops.  Its metrics are rank 0's, its peaks the fullest
card's, and its check a sample of the sharded output (``compare``).
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

from . import cells, compare, inputs, ranks, roofline, trace

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


class PortMissing(RuntimeError):
    pass


def load_port(root: Path):
    """``xrft_tpu_torch`` from the checkout at ``root``; raises PortMissing
    when the checkout holds none, or when it was loaded from elsewhere."""
    if str(root) not in sys.path:
        sys.path.insert(1, str(root))
    try:
        import xrft_tpu_torch as xt
    except ImportError as e:
        raise PortMissing(f"this checkout holds no xrft_tpu_torch ({e})")
    where = Path(xt.__file__).resolve()
    if root not in where.parents:
        raise PortMissing(f"xrft_tpu_torch was loaded from {where}, not "
                          f"from this checkout ({root})")
    return xt


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


def _contiguous_stride(shape) -> tuple:
    stride, acc = [], 1
    for n in reversed(shape):
        stride.append(acc)
        acc *= max(int(n), 1)
    return tuple(reversed(stride))


class ShardedProgram:
    """The cell's sharded entry (``xt.parallel.<entry>``), its mesh and this
    rank's inputs: call i wraps this rank's block of stack i % 2 as a
    DTensor with the placements the mix's ``dim_shards`` give (no
    collective) and calls ``entry(da, mesh, dim_shards, **kwargs)``."""

    def __init__(self, xt, cell: cells.Cell, ins: inputs.ShardedInputs,
                 mesh, entry=None):
        from torch.distributed.tensor import Replicate, Shard

        self.xt = xt
        self.entry = entry or getattr(xt.parallel, cell.mix["entry"])
        self.ins = ins
        self.mesh = mesh
        names = list(mesh.mesh_dim_names)
        self.placements = [Replicate()] * len(names)
        for d, m in ins.dim_shards.items():
            self.placements[names.index(m)] = Shard(ins.dims.index(d))

    def __call__(self, i: int):
        from torch.distributed.tensor import DTensor

        block, coords = self.ins.args(i)
        data = DTensor.from_local(block, self.mesh, self.placements,
                                  run_check=False,
                                  shape=torch.Size(self.ins.shape),
                                  stride=_contiguous_stride(self.ins.shape))
        da = self.xt.LabeledArray(data, dims=self.ins.dims, coords=coords)
        return self.entry(da, self.mesh, self.ins.dim_shards,
                          **self.ins.kwargs)


def _window(program, dev, seconds: float, first: int, sample_at: int,
            keep, team=ranks.Solo()):
    """The measured window: calls from index ``first`` until ``seconds``
    have passed on rank 0's clock; returns (Window, last output, its index,
    the sample: ``keep(output, call)`` of call ``sample_at``)."""
    w = Window()
    out, sample, i = None, None, first
    start = time.perf_counter()
    deadline = start + seconds
    while True:
        out = None                       # released before the next call
        failed = False
        t0 = t1 = time.perf_counter()
        try:
            out = program(i)
            t1 = time.perf_counter()
            dev.sync()
        except Exception:                # a failed call ends the window
            log(traceback.format_exc())
            failed = True
            out = None
        t2 = time.perf_counter()
        failed, done = team.step(failed, t2 >= deadline and i + 1 > sample_at)
        if failed:                       # on any rank: ends every rank's
            w.failed += 1
            out = None
            break
        w.calls.append((program.ins.fields, t1 - t0, t2 - t0))
        if i == sample_at:
            sample = keep(out, i)
            dev.sync()
        i += 1
        if done:
            break
    w.seconds = time.perf_counter() - start
    return w, out, i - 1, sample


def _profiled(program, dev, first: int, stacks: bool, calls: int = 0,
              seconds: float = 0.0, team=ranks.Solo()):
    """Calls from index ``first`` under torch.profiler: ``calls`` of them,
    or as many as fill ``seconds``, at least two.  With ``stacks`` the
    profiler records host ops and Python stacks inside the stretch
    annotation; without, device activity alone.  Returns (events, calls,
    host seconds of the calls, last output).  Rank 0 decides when every
    rank stops."""
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
            while team.agree(i - first < max(calls, 2)
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


def _traced(program, dev, first: int, layer_map, patterns,
            team=ranks.Solo()):
    """The timing stretch (device activity alone, TRACE_SECONDS of calls),
    then the attributed stretch (TRACE_CALLS calls with Python stacks), in
    the window's loop; returns (Summary, last output, its index)."""
    timing, timed, host_s, out = _profiled(program, dev, first, False,
                                           seconds=TRACE_SECONDS, team=team)
    out = None                  # released before the next call, as ever
    first += timed
    stacked, calls, _, out = _profiled(program, dev, first, True,
                                       calls=TRACE_CALLS, team=team)
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

    window, out, last, sample = _window(
        program, dev, seconds, 2, sample_at + 2,
        lambda out, i: (i, sample_field, out.data[sample_field].clone()))
    peak_window = dev.peak_bytes()
    summary = None
    if traced and not window.failed:
        layer_map = trace.load_layer_map()
        out = None              # released before the next call, as ever
        summary, out, last = _traced(program, dev, last + 1, layer_map,
                                     _patterns(cell))
        log(f"traced: {summary.call_wall_s * 1e3:.3f} ms a call over "
            f"{summary.timed_calls} calls of the timing stretch, "
            f"{_mean_wall_ms(window):.3f} in the window")
    peaks = [p for p in (peak, peak_window, dev.peak_bytes())
             if p is not None]
    memory_peak = max(peaks) if peaks else None

    work = work_model.layers(ins.args(0)[0].shape, ins.stacks[0].dtype,
                             ins.kwargs)
    reading = Reading(cell, work, window, setup_s, peak_window, summary)
    if out is None:
        checks = {"failed_calls": {"value": window.failed, "limit": 0}}
    else:
        checks = compare.checks(_answers(ins, out, last, sample),
                                ref, cell.limits)
    log(f"card: {dev.card_line()}")
    device = {"platform": dev.platform, "kind": dev.name(),
              "count": dev.count, "memory_peak_bytes": memory_peak}
    return _result(cell, reading, traced, window, summary, device,
                   checks), checks


def _share(work: dict, ranks_: int) -> dict:
    """Each rank's even share of a global work model."""
    return {layer: dict(w, bytes=w["bytes"] / ranks_,
                        flops=w["flops"] / ranks_)
            for layer, w in work.items()}


def run_rank(team, dev, checkout: Path, root: Path, name: str, seed: int,
             seconds: float, traced: bool, t0: float, marks: list,
             wrap=None):
    """One rank of the cell ``name`` of ``root/BENCHMARK.json`` whose mix
    names a ``mesh``, started by ``ranks.launch``, the port taken from
    ``checkout``; ``t0`` and ``marks`` are the launching process's.
    Returns rank 0's (result line without ``checks``, checks), None on the
    other ranks."""
    lead = team.rank == 0
    try:
        xt = load_port(checkout)
    except PortMissing as e:
        log(str(e))
        raise SystemExit(3)
    import xrft_tpu_torch.parallel  # noqa: F401  (xt.parallel)
    cell = cells.load(root, name, bench=root / cells.HERE.name)
    marks = list(marks) + [(f"rank {team.rank}: xrft_tpu_torch and the "
                            f"process groups", time.perf_counter())]
    mesh = xt.parallel.make_mesh(cell.mix["mesh"], device=dev.device)
    marks.append(("the mesh", time.perf_counter()))
    ref = cells.entry_module("reference", cell.mix["entry"])
    work_model = cells.entry_module("work", cell.mix["entry"])
    names = list(mesh.mesh_dim_names)
    ins = inputs.make_sharded(cell.config, cell.mix, seed, dev.device,
                              dict(zip(names, mesh.shape)),
                              dict(zip(names, mesh.get_coordinate())))
    dev.sync()
    marks.append(("inputs", time.perf_counter()))
    entry = getattr(xt.parallel, cell.mix["entry"])
    program = ShardedProgram(xt, cell, ins, mesh,
                             wrap(entry, team.rank) if wrap else entry)
    sample_at = random.Random(seed).randrange(SAMPLE_AMONG)
    pick = random.Random(seed * 4099 + team.rank)    # planes of this rank
    axes = sorted(ins.dims.index(d) for d in ins.kwargs["dim"])

    for i in range(2):
        program(i)
        dev.sync()
        marks.append((f"warm-up call {i}", time.perf_counter()))
    setup_s = time.perf_counter() - t0
    if lead:
        log("set-up: " + ", ".join(
            f"{n} {t - (marks[k - 1][1] if k else t0):.3f} s"
            for k, (n, t) in enumerate(marks)))
    peak = dev.peak_bytes()
    dev.reset_peak()

    window, out, last, sample = _window(
        program, dev, seconds, 2, sample_at + 2,
        lambda out, i: compare.pick_plane(out, i, axes, pick), team)
    peak_window = dev.peak_bytes()
    summary = None
    if traced and not window.failed:
        layer_map = trace.load_layer_map()
        out = None              # released before the next call, as ever
        summary, out, last = _traced(program, dev, last + 1, layer_map,
                                     _patterns(cell), team)
        busy = team.gather(summary.busy_s)
        summary.busy_s = sum(busy) / len(busy)      # the mean over cards
        if lead:
            log(f"traced: {summary.call_wall_s * 1e3:.3f} ms a call over "
                f"{summary.timed_calls} calls of the timing stretch, "
                f"{_mean_wall_ms(window):.3f} in the window")
    peaks = team.gather([p if p is not None else -1 for p in
                         (peak, peak_window, dev.peak_bytes())])

    # the check, once the program's state is freed: planes of the last and
    # the sampled call against the reference, from the input made again
    checks = {"failed_calls": {"value": window.failed, "limit": 0}}
    if out is not None:
        planes = [sample, compare.pick_plane(out, last, axes, pick)]
        labels = compare.label_mismatch(out, ins.stacks[0], ins.coords,
                                        ins.dims, ins.kwargs, ref)
        out = program = None
        ins.stacks.clear()
        err = top = 0.0
        for p in planes:
            if p is None:
                continue
            want = ref.plane(lambda k, s=p.call % 2: ins.slab(s, k),
                             ins.shape, ins.slab_axis, ins.dims, ins.coords,
                             ins.kwargs, p.at)
            e, t = compare.plane_err(p, want)
            err, top = max(err, e), max(top, t)
        err, top, *bad = team.max([err, top] + list(labels.values()))
        checks = {"rel_err": {"value": err / top if top > 0 else
                              float("inf"),
                              "limit": cell.limits["rel_err"]["limit"]}}
        checks.update({k: {"value": int(v), "limit": 0}
                       for k, v in zip(labels, bad)})
    cards = team.gather(dev.card_line())

    found = forbidden_modules()
    if found:
        log(f"rank {team.rank} loaded {found}: nothing it runs may import "
            f"JAX or the JAX package")
    if team.max([len(found)])[0]:
        raise SystemExit(4)
    if not lead:
        return None
    for r, line in enumerate(cards):
        log(f"card of rank {r}: {line}")
    by_rank = [[p for p in ps if p >= 0] for ps in peaks]
    peak_window_all = max((ps[1] for ps in peaks if ps[1] >= 0),
                          default=None)
    work = _share(work_model.layers(ins.shape, ins.dtype, ins.kwargs,
                                    ins.dims), team.world)
    reading = Reading(cell, work, window, setup_s, peak_window_all, summary)
    device = {"platform": dev.platform, "kind": dev.name(),
              "count": team.world,
              "memory_peak_bytes": max((max(p) for p in by_rank if p),
                                       default=None),
              "rank_peak_bytes": [max(p) if p else None for p in by_rank]}
    return _result(cell, reading, traced, window, summary, device,
                   checks), checks


def _patterns(cell: cells.Cell) -> dict:
    patterns = {}
    for m in cell.per_layer:
        patterns.update(getattr(m.reader, "KERNEL_LAYERS", {}))
    return patterns


def _result(cell, reading, traced, window, summary, device, checks) -> dict:
    """The result line, ``checks`` aside."""
    metrics = {}
    for m in (cell.per_layer if traced else cell.end_to_end):
        v = m.reader.read(reading)
        if v is not None:
            metrics[m.name] = {"value": v, "unit": m.unit}
    attempted = len(window.calls) + window.failed + (
        summary.timed_calls + summary.calls if summary is not None else 0)
    if summary is not None:
        device["busy_s"] = summary.busy_s
        device["window_s"] = summary.window_s
    result = {"correct": compare.passed(checks) and not window.failed,
              "attempted": attempted, "failed": window.failed,
              "metrics": metrics, "device": device}
    if summary is not None:
        result["breakdown"] = trace.breakdown(summary)
    return result
