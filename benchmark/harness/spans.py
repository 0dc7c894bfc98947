"""The program's own record of its calls (``xrft_tpu_torch.telemetry``),
read in a run.

**Counters.** The program counts, always, its outermost calls, the host's
blocking copies onto the card (``host_syncs``) and the host's time inside
them (``host_wait_ns``).  :func:`run_counters` reads them at the end of a
run, and only where they count exactly the calls the harness made (its
warm-up calls, the window's and the traced stretches'), so a reading
covers this run alone; a checkout whose program has no ``telemetry``
reads nothing.

**Spans.** The span stretch (:func:`stretch`) runs calls in the window's
loop under ``torch.profiler`` with device activity alone, as the timing
stretch does, while the program records its spans; the spans are laid
onto the trace by their clock, ``time.time_ns()``, the profiler's
(``chrome_events(baseTimeNanoseconds)``).  :func:`read` ties each device
operation to its launch (a runtime or driver event, by correlation id)
and the launch to the innermost program span open on its thread at that
moment (``trace._enclosing``), so device time is split by program span
with no Python tracer, K1's launch through ctypes included.  It reads the
host's wait on the card (``sync`` spans), the self time of ``coords``
spans, and the device's idle time inside the host extent of ``call``
spans: the part of the idle time a call causes.  The rest is the
benchmark's own time between calls.
"""

from __future__ import annotations

import json
import sys
import tempfile
import time
from dataclasses import dataclass
from pathlib import Path

from . import trace

WARM_UP = 2              # the runner's warm-up calls
SYNC = "sync"
OUTSIDE = "outside"      # a device operation launched outside every span
# program span -> the layer of harness/layers.json it belongs to
SPAN_LAYERS = {"call": "api coords", "coords": "api coords",
               "prologue": "prologue", "fft": "fft", "epilogue": "epilogue",
               "binning": "binning", "segmenting": "segmenting"}


def run_counters(r) -> dict | None:
    """``telemetry.snapshot()`` of the program loaded in this run, when its
    ``calls`` equal the calls the harness made in run ``r``; otherwise (no
    such program, no traced stretches, other calls counted) None."""
    tm = getattr(sys.modules.get("xrft_tpu_torch"), "telemetry", None)
    if tm is None or r.trace is None:
        return None
    snap = tm.snapshot()
    made = WARM_UP + len(r.window.calls) + r.window.failed + \
        r.trace.timed_calls + r.trace.calls
    return snap if snap["calls"] == made else None


@dataclass
class Stretch:
    """A profiled stretch of calls with the program's spans on its clock."""
    events: list            # the trace's events, spans appended
    lo: float               # the stretch's first and last instant (us)
    hi: float
    calls: int
    host_s: float           # the calls' host seconds
    before: dict            # the program's snapshot at its start
    after: dict             # and at its end


def stretch(program, dev, first: int, tm, seconds: float) -> tuple:
    """Calls from index ``first`` (at least two, and until ``seconds``
    have passed) under torch.profiler with device activity alone, as the
    timing stretch, while the program records its spans.  Returns
    (Stretch, last output)."""
    from torch.profiler import ProfilerActivity, profile

    cuda = dev.kind == "cuda"
    acts = [ProfilerActivity.CUDA] if cuda else [ProfilerActivity.CPU]
    out, i = None, first
    dev.sync()
    before = tm.snapshot()
    with profile(activities=acts) as prof, tm.recording():
        lo_ns = time.time_ns()
        t0 = time.perf_counter()
        while i - first < 2 or time.perf_counter() - t0 < seconds:
            out = None
            out = program(i)
            dev.sync()
            i += 1
        host_s = time.perf_counter() - t0
        hi_ns = time.time_ns()
    after = tm.snapshot()
    with tempfile.TemporaryDirectory() as tmp:
        path = Path(tmp) / "trace.json"
        prof.export_chrome_trace(str(path))
        with open(path) as f:
            doc = json.load(f)
    base = doc.get("baseTimeNanoseconds", 0)
    events = doc["traceEvents"] + tm.chrome_events(base)
    return Stretch(events, (lo_ns - base) / 1e3, (hi_ns - base) / 1e3,
                   i - first, host_s, before, after), out


def _merged(intervals) -> list:
    out = []
    for s, t in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], t)
        else:
            out.append([s, t])
    return out


def idle_intervals(events, lo: float, hi: float) -> list:
    """The stretches of [lo, hi] (us) in which no device operation ran."""
    busy = _merged((s, t) for s, t, _ in trace._device_ops(events, lo, hi))
    out, at = [], lo
    for s, t in busy:
        if s > at:
            out.append((at, s))
        at = max(at, t)
    if hi > at:
        out.append((at, hi))
    return out


def _overlap(a: list, b: list) -> float:
    """Length of the intersection of two sets of disjoint intervals."""
    return sum(max(0.0, min(t, v) - max(s, u)) for s, t in a for u, v in b)


def span_events(events) -> list:
    return [e for e in events if e.get("cat") == "xrft_tpu_torch"]


def self_us(spans: list, name: str) -> float:
    """Host us of the spans named ``name``, each less its child spans."""
    by_index = {e["args"]["index"]: e for e in spans}
    total = sum(e["dur"] for e in spans if e["name"] == name)
    for e in spans:
        up = by_index.get(e["args"]["parent"])
        if up is not None and up["name"] == name:
            total -= e["dur"]
    return total


def device_by_span(events) -> dict:
    """Device us by the innermost program span (``sync`` aside: it waits,
    and its copy belongs to the layer around it) open at each device
    operation's launch; OUTSIDE where none was, "unattributed" where the
    trace has no launch for it."""
    spans = span_events(events)
    device = trace._device_ops(events)
    launches = {e["args"]["correlation"]: e for e in events
                if e.get("cat") in trace.LAUNCH_CATS and "args" in e
                and "correlation" in e["args"]}
    queries = []
    for k, (_, _, e) in enumerate(device):
        launch = launches.get(e.get("args", {}).get("correlation"))
        if launch is not None:
            queries.append((k, launch["tid"], launch["ts"]))
    open_at = trace._enclosing(spans, queries)
    out: dict = {}
    for k, (s, t, _) in enumerate(device):
        stack = open_at.get(k)
        name = trace.UNATTRIBUTED if stack is None else next(
            (n for n in stack if n != SYNC), OUTSIDE)
        out[name] = out.get(name, 0.0) + (t - s)
    return out


@dataclass
class Reading:
    calls: int
    wall_ms: float                 # host ms a call, the stretch's
    host_wait_ms: float            # in sync spans, a call
    coords_host_ms: float          # coords self time, a call
    call_idle_share: float         # %, idle inside call spans / length
    idle_share: float              # %, all idle / length
    first_gap_ms: tuple            # (benchmark's part, program's part)
    device_ms: dict                # span name -> device ms a call
    stream_syncs: float            # cudaStreamSynchronize events a call
    counters: dict                 # counter deltas a call


def read(st: Stretch) -> Reading:
    spans = span_events(st.events)
    n = max(st.calls, 1)
    length = st.hi - st.lo
    idle = idle_intervals(st.events, st.lo, st.hi)
    calls = sorted((e["ts"], e["ts"] + e["dur"]) for e in spans
                   if e["name"] == "call")
    bench, prog = 0.0, 0.0
    for start, _ in calls:
        gap = next(((a, b) for a, b in idle if a <= start < b), None)
        if gap is not None:
            bench += start - gap[0]
            prog += gap[1] - start
    syncs = sum(1 for e in st.events if e.get("cat") in trace.LAUNCH_CATS
                and e.get("name") == "cudaStreamSynchronize")
    before = _flat(st.before)
    counters = {k: (v - before[k]) / n for k, v in _flat(st.after).items()
                if k in before}
    return Reading(
        calls=st.calls,
        wall_ms=st.host_s * 1e3 / n,
        host_wait_ms=sum(e["dur"] for e in spans if e["name"] == SYNC)
        / 1e3 / n,
        coords_host_ms=self_us(spans, "coords") / 1e3 / n,
        call_idle_share=100.0 * _overlap(idle, calls) / length
        if length > 0 else 0.0,
        idle_share=100.0 * sum(b - a for a, b in idle) / length
        if length > 0 else 0.0,
        first_gap_ms=(bench / 1e3 / n, prog / 1e3 / n),
        device_ms={k: v / 1e3 / n for k, v in
                   device_by_span(st.events).items()},
        stream_syncs=syncs / n,
        counters=counters)


def _flat(snap: dict) -> dict:
    """A snapshot's numbers, nested groups as ``group.key``."""
    out = {}
    for k, v in snap.items():
        if isinstance(v, dict):
            out.update({f"{k}.{j}": w for j, w in v.items()})
        else:
            out[k] = v
    return out


def layer_ms(device_ms: dict) -> dict:
    """Device ms a call by span, summed into the layers of layers.json."""
    out: dict = {}
    for name, ms in device_ms.items():
        layer = SPAN_LAYERS.get(name, name)
        out[layer] = out.get(layer, 0.0) + ms
    return out
