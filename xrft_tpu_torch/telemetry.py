"""What the package records about its own calls: counters, always on, and
spans, recorded only inside :func:`recording`.

Counters (integers since the last :func:`reset`):

- ``calls``: outermost calls of the package's public array functions
  (``xrft_tpu_torch.power_spectrum``, ``fft``, ``ifft`` ...), which
  :func:`entry` marks where the package exports them; one called inside
  another is not counted again;
- ``host_syncs``, ``h2d_bytes``, ``host_wait_ns``: the copies of host arrays
  onto a CUDA device made through :func:`to_device`.  Such a copy is
  pageable, and PyTorch synchronizes the stream after it, so the host
  waits there until every operation queued before it has run;
  ``host_wait_ns`` is the host's time inside them;
- ``cufft_plans``: cuFFT plans added to the device's plan cache by the
  ``"torch"`` route's transforms (:func:`cufft`);
- ``prologue_plain_cuda``: prologues (detrend, window) of CUDA data that
  kernel K6 did not take and the plain torch ops ran
  (``detrend.detrend_and_window``);
- ``exchanges``, ``exchange_bytes``: the collectives this process issued
  (``parallel.exchange``: the pencil's all_to_alls, the shifts' and
  flips' uneven all_to_alls, the all_reduces) and the bytes it sent to
  other ranks in them, its own rows left out;
- ``chain_shifts``: the transformed axes whose fftshift or ifftshift the
  pencil chain applied in the exchange that splits them, as a rotation of
  which chunk goes to which rank (``parallel.pencil_fftn``);
- ``spans_dropped``: spans left out because the buffer was full.

:func:`snapshot` returns them with what the package already keeps where it
keeps it: each kernel wrapper's ``launches``, the misses of the host table
caches, and the seconds of each nvcc build.

A span is a named stretch of host time: (name, call id, parent index,
start_ns, end_ns).  Spans nest per thread, each naming its parent (the
index of the enclosing span, -1 for none); the spans of one outermost call
share its call id.  The names are the layers of the package: ``call`` (the
outermost entry), ``coords`` (coordinate checks, spacings, lags, frequency
grids, the output's coordinates), ``prologue`` (detrend, window, the
float64 promotion), ``fft`` (the route call with its shifts), ``epilogue``
(K1, |F|^2, one-sided doubling, scales, the Hermitian expansion),
``binning``, ``segmenting``, ``sync`` (each :func:`to_device` onto a
CUDA device) and ``exchange`` (a collective, from its issue to its
completion; an asynchronous one is opened by :func:`begin` and names its
parent but takes no children, so that the work the host does while it is
pending nests as before).  Off, :func:`span` and :func:`begin` return one
shared object that does nothing, after one check of a flag.  The clock is
``time.time_ns()``, the clock of ``torch.profiler``'s chrome trace, so
:func:`chrome_events` lays the spans onto a profiler trace of the same
calls.
"""

from __future__ import annotations

import functools
import os
import threading
import time
from contextlib import contextmanager

import torch

__all__ = ["span", "begin", "entry", "count", "to_device", "cufft",
           "recording", "spans", "self_ns", "chrome_events", "snapshot",
           "reset"]

COUNTERS = ("calls", "host_syncs", "h2d_bytes", "host_wait_ns",
            "cufft_plans", "prologue_plain_cuda", "exchanges",
            "exchange_bytes", "chain_shifts", "spans_dropped")
SPAN_LIMIT = 100_000

_lock = threading.Lock()
_counts = dict.fromkeys(COUNTERS, 0)
_recording = False
# [name, call id, parent index, start_ns, end_ns, thread id]; end_ns is
# None while the span is open
_spans: list = []
_cleared = 0             # how often _spans was cleared
_next_call = 0
_miss_base: dict = {}


class _Thread(threading.local):
    depth = 0            # nesting of marked public entries
    call = None          # call id of the open ``call`` span
    stack = ()           # the open spans, innermost last

    def __init__(self):
        # read once: a system call, 7-9 us each on an H100 machine's host
        self.tid = threading.get_native_id()


def _fresh_thread_state():
    global _here
    _here = _Thread()


_fresh_thread_state()
os.register_at_fork(after_in_child=_fresh_thread_state)


def count(name: str, n: int = 1) -> None:
    """Add ``n`` to counter ``name`` (one of COUNTERS)."""
    with _lock:
        _counts[name] += n


class _Noop:
    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def end(self):
        pass


_NOOP = _Noop()


class _Span:
    __slots__ = ("name", "index", "cleared", "nest")

    def __init__(self, name: str, nest: bool = True):
        self.name = name
        self.nest = nest        # a parent of the spans opened inside it

    def __enter__(self):
        global _next_call
        here = _here
        with _lock:
            self.cleared = _cleared
            up = here.stack[-1] if here.stack else None
            parent = up.index if up is not None and \
                up.cleared == _cleared else -1
            if self.name == "call":
                here.call = _next_call
                _next_call += 1
            if len(_spans) < SPAN_LIMIT:
                self.index = len(_spans)
                _spans.append([self.name, here.call, parent,
                               time.time_ns(), None, here.tid])
            else:
                self.index = -1
                _counts["spans_dropped"] += 1
        if self.nest:
            here.stack = here.stack + (self,)
        return self

    def __exit__(self, *exc):
        end = time.time_ns()
        here = _here
        if self.nest:
            here.stack = here.stack[:-1]
        if self.index >= 0 and self.cleared == _cleared:
            _spans[self.index][4] = end
        if self.name == "call":
            here.call = None
        return False

    def end(self):
        self.__exit__(None, None, None)


def span(name: str):
    """A context manager spanning its block as ``name`` while recording;
    otherwise a shared no-op."""
    if not _recording:
        return _NOOP
    return _Span(name)


def begin(name: str):
    """A span ``name`` opened now and closed by ``end()`` on the object
    returned, while recording; otherwise the shared no-op.  It names the
    innermost span open now as its parent, but is no parent itself: spans
    opened and closed before its end nest around it as if it were not
    there (an asynchronous exchange, issued, then waited on after other
    work)."""
    if not _recording:
        return _NOOP
    return _Span(name, nest=False).__enter__()


def entry(fn):
    """Mark a public entry: its outermost call counts in ``calls`` and, while
    recording, is a ``call`` span with a new call id; called inside another
    marked entry it is a plain call.  The wrapper holds the arguments until
    the call returns, so mark only a function whose callers hold them too
    (the exported names, behind the xarray boundary's wrapper), never one
    the package calls with a temporary it lets go of early (the hp path's
    float64 copy, passed to ``transform.fft``)."""

    @functools.wraps(fn)
    def marked(*args, **kwargs):
        here = _here
        if here.depth:
            return fn(*args, **kwargs)
        count("calls")
        here.depth = 1
        try:
            with span("call"):
                return fn(*args, **kwargs)
        finally:
            here.depth = 0

    return marked


def to_device(array, dtype=None, device=None) -> torch.Tensor:
    """``torch.as_tensor(array, dtype=dtype, device=device)`` of a host
    (numpy) array: the same values, dtype and device, and the same wait.
    Onto a CUDA device a non-empty copy counts in ``host_syncs``,
    ``h2d_bytes`` (the bytes it moves, in the result's dtype: PyTorch
    converts on the host first) and ``host_wait_ns``, and is a ``sync``
    span while recording."""
    if device is None or array.size == 0 or \
            torch.device(device).type != "cuda":
        return torch.as_tensor(array, dtype=dtype, device=device)
    with span("sync"):
        t0 = time.perf_counter_ns()
        out = torch.as_tensor(array, dtype=dtype, device=device)
        waited = time.perf_counter_ns() - t0
    with _lock:
        _counts["host_syncs"] += 1
        _counts["h2d_bytes"] += out.numel() * out.element_size()
        _counts["host_wait_ns"] += waited
    return out


def cufft(fn, x: torch.Tensor, **kwargs) -> torch.Tensor:
    """``fn(x, **kwargs)``, a transform of ``torch.fft``; on a CUDA tensor,
    the plans it adds to the device's cuFFT plan cache count in
    ``cufft_plans``."""
    if not x.is_cuda:
        return fn(x, **kwargs)
    cache = torch.backends.cuda.cufft_plan_cache[x.device.index]
    before = cache.size
    out = fn(x, **kwargs)
    count("cufft_plans", max(cache.size - before, 0))
    return out


@contextmanager
def recording():
    """Record spans inside the block, at most SPAN_LIMIT of them (the rest
    count in ``spans_dropped``); the spans of an earlier recording are
    cleared at its start and kept after its end."""
    global _recording
    with _lock:
        if _recording:
            raise RuntimeError("spans are already being recorded")
        _clear()
        _recording = True
    try:
        yield
    finally:
        _recording = False


def _clear() -> None:
    """Drop the recorded spans (under the lock); a span still open from
    before closes without writing into the new list."""
    global _cleared
    _spans.clear()
    _cleared += 1


def spans() -> list:
    """The spans recorded, in the order they opened (a parent index points
    into this list), as (name, call id, parent index, start_ns, end_ns);
    end_ns is None while a span is open."""
    with _lock:
        return [tuple(s[:5]) for s in _spans]


def self_ns() -> dict:
    """Host nanoseconds by span name over the closed spans recorded, each
    span's duration less its child spans'."""
    with _lock:
        recorded = [tuple(s) for s in _spans]
    out: dict = {}
    for name, _, parent, start, end, _ in recorded:
        if end is None:
            continue
        out[name] = out.get(name, 0) + end - start
        if parent >= 0 and recorded[parent][4] is not None:
            up = recorded[parent][0]
            out[up] = out.get(up, 0) - (end - start)
    return out


def chrome_events(base_ns: int = 0) -> list:
    """The closed spans as chrome-trace complete events ("X", times in us),
    on the clock of a ``torch.profiler`` chrome trace whose
    ``baseTimeNanoseconds`` is ``base_ns``; ``args`` holds each span's call
    id, its own index and its parent's."""
    pid = os.getpid()
    with _lock:
        recorded = [(i, s) for i, s in enumerate(_spans) if s[4] is not None]
    return [{"ph": "X", "cat": "xrft_tpu_torch", "name": name,
             "ts": (start - base_ns) / 1e3, "dur": (end - start) / 1e3,
             "pid": pid, "tid": tid,
             "args": {"call": call, "index": i, "parent": parent}}
            for i, (name, call, parent, start, end, tid) in recorded]


def _kernels() -> dict:
    from .ops import binning, dft64, dot, fft_fourstep, mirror, prologue
    return {"K1": mirror.mirror_psd, "K2": fft_fourstep.fft_last,
            "K3": binning.binned_sum, "K4": dft64.dft_last, "K5a": dot.dot,
            "K5b": dot.dot_fold, "K5c": dot.dot_dma,
            "K6": prologue.detrend_window}


def _table_misses() -> dict:
    """Misses of the ``lru_cache`` tables each host-plan module defines."""
    from .ops import dft64, fft_fourstep, fft_plan, matmul_fft, stacked_fft
    out = {}
    for mod in (fft_plan, fft_fourstep, dft64, stacked_fft, matmul_fft):
        out[mod.__name__.rsplit(".", 1)[-1]] = sum(
            f.cache_info().misses for f in vars(mod).values()
            if hasattr(f, "cache_info")
            and getattr(f, "__module__", None) == mod.__name__)
    return out


def snapshot() -> dict:
    """The counters since the last :func:`reset`, each kernel's ``launches``
    (K1-K6), the table caches' misses since the last reset, and the
    seconds of each nvcc build of this process (``ops._build``)."""
    from .ops import _build
    with _lock:
        out = dict(_counts)
    out["launches"] = {k: f.launches for k, f in _kernels().items()}
    out["table_misses"] = {k: n - _miss_base.get(k, 0)
                           for k, n in _table_misses().items()}
    out["build_seconds"] = dict(_build.build_seconds)
    return out


def reset() -> None:
    """Zero the counters and the kernels' ``launches``, take the table
    caches' misses as the new zero, and drop the recorded spans."""
    with _lock:
        for k in _counts:
            _counts[k] = 0
        _clear()
    for f in _kernels().values():
        f.launches = 0
    _miss_base.update(_table_misses())
