"""Read ``torch.profiler`` chrome traces of two stretches of calls.

The timing stretch is recorded with device activity alone: the union of its
device operations' intervals (kernels, copies, sets) over its length on the
host clock gives the busy and idle shares, and the gaps between them the
longest idle gaps.  Python's tracer slows the host, so it is off there.

The attributed stretch is recorded with Python stacks, inside the
``bench.stretch`` annotation the benchmark records around its calls: each
device operation is attributed to a layer by the stack that launched it,
and only device times are read from it.  A device operation is tied to its
launch (a cudaLaunchKernel or cuLaunchKernel call on a host thread) by the
trace's correlation id, and the launch to the ``python_function`` events
that enclose it on that thread.
"""

from __future__ import annotations

import json
import re
from collections import defaultdict
from dataclasses import dataclass, field
from pathlib import Path

STRETCH = "bench.stretch"
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
LAUNCH_CATS = ("cuda_runtime", "cuda_driver")
UNATTRIBUTED = "unattributed"
LAYERS_FILE = Path(__file__).resolve().parent / "layers.json"


@dataclass
class Summary:
    calls: int                             # calls of the attributed stretch
    timed_calls: int                       # calls of the timing stretch
    window_s: float                        # the timing stretch's length
    busy_s: float                          # union of device intervals in it
    layer_s: dict = field(default_factory=dict)    # layer -> device s
    ops: list = field(default_factory=list)        # [(layer, name, s)]
    gaps: list = field(default_factory=list)       # [(host op, s)]

    @property
    def call_wall_s(self) -> float:
        return self.window_s / self.timed_calls

    def layer_ms_per_call(self, layer: str) -> float:
        return self.layer_s.get(layer, 0.0) * 1e3 / self.calls


def load_layer_map(path: Path = LAYERS_FILE) -> dict:
    with open(path) as f:
        return json.load(f)


def union_seconds(intervals, lo: float, hi: float) -> float:
    """Length of the union of (start, end) intervals (us) within [lo, hi],
    in seconds."""
    total, end = 0.0, lo
    for s, e in sorted(intervals):
        s, e = max(s, end), min(e, hi)
        if e > s:
            total += e - s
            end = e
    return total * 1e-6


def _frame(name: str) -> tuple[str, str]:
    """("path/to/file.py", "function") of a python_function event name
    ``path/to/file.py(123): function``."""
    path, _, rest = name.partition("(")
    func = rest.partition(": ")[2]
    return path.replace("\\", "/"), func


def _matches(path: str, rule: dict, func: str) -> bool:
    m = rule["module"]
    if m.endswith("/"):
        hit = path.startswith(m) or ("/" + m) in path
    else:
        hit = path == m or path.endswith("/" + m)
    return hit and ("function" not in rule or rule["function"] == func)


def layer_of_stack(stack: list, layer_map: dict) -> str | None:
    """The layer of a launch from its Python stack (innermost frame first):
    the first frame in a named module, container modules only where no
    other named frame is found."""
    fallback = None
    for name in stack:
        path, func = _frame(name)
        for rule in layer_map["modules"]:
            if _matches(path, rule, func):
                if not rule.get("container"):
                    return rule["layer"]
                fallback = fallback or rule["layer"]
                break
    return fallback


def layer_of_kernel(name: str, patterns: dict) -> str | None:
    for pat, layer in patterns.items():
        if pat in name:
            return layer
    return None


def _enclosing(py_events: list, queries: list) -> dict:
    """For each query (key, tid, t), the stack of python_function events
    open at time t on thread tid, innermost first.  Events of one thread
    nest, so one sweep in time order with a stack finds them."""
    by_tid = defaultdict(list)
    for e in py_events:
        by_tid[e["tid"]].append(e)
    out = {}
    for tid, qs in _group(queries).items():
        evs = sorted(by_tid.get(tid) or py_events, key=lambda e: e["ts"])
        stack, i = [], 0
        for key, t in sorted(qs, key=lambda q: q[1]):
            while i < len(evs) and evs[i]["ts"] <= t:
                while stack and stack[-1]["ts"] + stack[-1]["dur"] < evs[i]["ts"]:
                    stack.pop()
                stack.append(evs[i])
                i += 1
            while stack and stack[-1]["ts"] + stack[-1]["dur"] < t:
                stack.pop()
            out[key] = [e["name"] for e in reversed(stack)]
    return out


def _group(queries):
    g = defaultdict(list)
    for key, tid, t in queries:
        g[tid].append((key, t))
    return g


def _short(name: str, n: int = 160) -> str:
    return name if len(name) <= n else name[:n - 3] + "..."


def _host_label(stack: list) -> str:
    """The innermost host frame, and the innermost frame of the port
    beneath it where that is another."""
    if not stack:
        return "no host frame"
    inner = re.sub(r" at 0x[0-9a-fA-F]+", "", stack[0])
    port = next((s for s in stack if "xrft_tpu_torch/" in s), None)
    label = inner if port in (None, stack[0]) else f"{inner} < {port}"
    return _short(label, 200)


def _device_ops(events, lo=None, hi=None) -> list:
    """The device operations of a trace in time order, clipped to [lo, hi]
    where given."""
    ops = []
    for e in events:
        if e.get("cat") not in DEVICE_CATS or e.get("ph") != "X":
            continue
        s, t = e["ts"], e["ts"] + e["dur"]
        if lo is not None:
            s, t = max(s, lo), min(t, hi)
        if t > s:
            ops.append((s, t, e))
    ops.sort(key=lambda o: o[0])
    return ops


def attribute(events: list, layer_map: dict,
              patterns: dict | None = None) -> list:
    """[(layer, name, seconds, launch stack)] of the device operations
    inside the stretch annotation of a trace recorded with Python stacks,
    in time order."""
    patterns = dict(layer_map.get("kernels", {}), **(patterns or {}))
    stretch = [e for e in events if e.get("cat") == "user_annotation"
               and e.get("name") == STRETCH]
    if not stretch:
        raise ValueError(f"the trace has no {STRETCH!r} annotation")
    lo = stretch[0]["ts"]
    device = _device_ops(events, lo, lo + stretch[0]["dur"])
    launches = {e["args"]["correlation"]: e for e in events
                if e.get("cat") in LAUNCH_CATS and "args" in e
                and "correlation" in e["args"]}
    py = [e for e in events if e.get("cat") == "python_function"
          and e.get("ph") == "X"]
    queries = []
    for k, (_, _, e) in enumerate(device):
        launch = launches.get(e.get("args", {}).get("correlation"))
        if launch is not None:
            queries.append((k, launch["tid"], launch["ts"]))
    stacks = _enclosing(py, queries)
    out = []
    for k, (s, t, e) in enumerate(device):
        stack = stacks.get(k, [])
        layer = layer_of_stack(stack, layer_map) \
            or layer_of_kernel(e["name"], patterns) or UNATTRIBUTED
        out.append((layer, e["name"], (t - s) * 1e-6, stack))
    return out


def _runtime_at(events: list, t: float) -> str | None:
    """The CUDA runtime or driver call that the host was in at time t."""
    for e in events:
        if e.get("cat") in LAUNCH_CATS and e.get("ph") == "X" \
                and e["ts"] <= t <= e["ts"] + e["dur"]:
            return e["name"]
    return None


def _gap_label(j: int, device: list, attributed: list, calls: int,
               events: list, mid: float) -> str:
    """What the device waited for in the gap before its j-th operation:
    the host's CUDA call at the gap's middle where the trace has one, and
    the operation after the gap with the layer and the host frame that
    launched it, taken from the attributed stretch (``calls`` calls) where
    every call runs the same operations in the same order."""
    name = device[j][2]["name"]
    host = _runtime_at(events, mid)
    head = f"host in {host}" if host else "host"
    n = len(attributed) // calls if calls else 0
    if n and len(attributed) == n * calls and len(device) % n == 0 and all(
            device[i][2]["name"] == attributed[i % n][1]
            for i in range(len(device))):
        layer, _, _, stack = attributed[j % n]
        return _short(f"{head}, before {layer}: {_short(name, 60)} "
                      f"launched at {_host_label(stack)}", 200)
    return _short(f"{head}, before {name}", 200)


def summarize(timing: list, window_s: float, timed_calls: int,
              attributed: list, calls: int, top: int = 10) -> Summary:
    """The summary of a traced run.  ``timing`` is the event list of a
    stretch of ``timed_calls`` calls recorded with device activity alone
    (no Python tracer to slow the host), lasting ``window_s`` on the host
    clock; ``attributed`` is ``attribute()`` of a stretch of ``calls``
    calls recorded with Python stacks."""
    device = _device_ops(timing)
    intervals = [(s, t) for s, t, _ in device]
    busy = union_seconds(intervals, device[0][0], device[-1][1]) \
        if device else 0.0
    merged = []
    for k, (s, t) in enumerate(intervals):
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], t)
        else:
            merged.append([s, t, k])
    gaps = [(merged[i][1], merged[i + 1][0], merged[i + 1][2])
            for i in range(len(merged) - 1)]
    gaps.sort(key=lambda g: g[0] - g[1])
    labelled = [(_gap_label(k, device, attributed, calls, timing,
                            (a + b) / 2), (b - a) * 1e-6)
                for a, b, k in gaps[:top]]
    if device:
        edges = window_s - (device[-1][1] - device[0][0]) * 1e-6
        if edges > 0:
            labelled.append(("host before the stretch's first device op "
                             "and after its last", edges))
            labelled.sort(key=lambda g: -g[1])
            labelled = labelled[:top]
    layer_s, by_op = defaultdict(float), defaultdict(float)
    for layer, name, s, _ in attributed:
        layer_s[layer] += s
        by_op[(layer, name)] += s
    ops = sorted(((layer, name, s) for (layer, name), s in by_op.items()),
                 key=lambda o: -o[2])[:top]
    return Summary(calls=calls, timed_calls=timed_calls, window_s=window_s,
                   busy_s=busy, layer_s=dict(layer_s), ops=ops,
                   gaps=labelled)


def breakdown(summary: Summary) -> dict:
    """The result line's ``breakdown``: device seconds over the attributed
    stretch, idle gaps over the timing stretch."""
    return {
        "device_ops": [[f"{layer}: {_short(name)}", s]
                       for layer, name, s in summary.ops],
        "idle_gaps": [[label, s] for label, s in summary.gaps],
    }
