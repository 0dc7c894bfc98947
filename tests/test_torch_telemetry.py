"""The port's own record of its calls (``xrft_tpu_torch/telemetry.py``): the
span tree of the flagship PSD, the hp PSD and the inverse, self times,
recording off, the counters and the kernels' ``launches`` in one snapshot,
the bounded span buffer, the spans on ``torch.profiler``'s clock, and the
host-to-device copies routed through ``to_device``.  The card's side (the
syncs counted against the profiler's) is
``test_torch_cuda.py::test_host_syncs_match_the_profilers_stream_syncs``."""

import ast
import json
import warnings
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import xrft_tpu_torch as xt
from xrft_tpu_torch import telemetry as tm
from xrft_tpu_torch.ops import dot, fft_plan, mirror

PKG = Path(xt.__file__).resolve().parent

FLAGSHIP = dict(dim=["y", "x"], window="hann", detrend="linear")
FLAGSHIP_SPANS = ["call", "coords", "coords", "coords", "coords", "prologue",
                  "prologue", "fft", "coords", "epilogue", "epilogue",
                  "coords"]
HP_SPANS = ["call", "prologue", "coords", "coords", "prologue", "prologue",
            "fft", "coords", "epilogue", "epilogue", "coords"]
IFFT_SPANS = ["call", "coords", "coords", "fft", "coords"]


@pytest.fixture(autouse=True)
def fresh():
    tm.reset()
    yield
    tm.reset()


def field(shape=(3, 32, 48), seed=0):
    x = torch.from_numpy(
        np.random.default_rng(seed).standard_normal(shape).astype(np.float32))
    return xt.LabeledArray(
        x, dims=("time", "y", "x"),
        coords={"time": np.arange(shape[0], dtype=float),
                "y": 0.5 * np.arange(shape[1]),
                "x": 0.5 * np.arange(shape[2])})


def half_spectrum(shape=(3, 32, 25), seed=1):
    g = np.random.default_rng(seed)
    h = (g.standard_normal(shape) + 1j * g.standard_normal(shape)).astype(
        np.complex64)
    ny, nx = shape[1], 2 * (shape[2] - 1)
    return xt.LabeledArray(
        torch.from_numpy(h), dims=("time", "freq_y", "freq_x"),
        coords={"time": np.arange(shape[0], dtype=float),
                "freq_y": np.fft.fftshift(np.fft.fftfreq(ny, 0.5)),
                "freq_x": np.fft.rfftfreq(nx, 0.5)})


def flagship():
    return xt.power_spectrum(field(), **FLAGSHIP)


def hp():
    return xt.power_spectrum(field(), engine="hp", **FLAGSHIP)


def inverse():
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", FutureWarning)   # lag=None
        return xt.ifft(half_spectrum(), dim=["freq_y", "freq_x"],
                       real_dim="freq_x", shift=False, lag=None,
                       true_phase=False, true_amplitude=False)


PATHS = {"flagship": (flagship, FLAGSHIP_SPANS), "hp": (hp, HP_SPANS),
         "ifft": (inverse, IFFT_SPANS)}


@pytest.mark.parametrize("path", sorted(PATHS))
def test_span_tree_of_one_call(path):
    """One ``call`` root; every other span is its child, inside it, with
    its call id, named by the layers in the order the call runs them."""
    run, names = PATHS[path]
    with tm.recording():
        run()
    spans = tm.spans()
    assert [s[0] for s in spans] == names
    root = spans[0]
    assert root[1] is not None and root[2] == -1
    for name, call, parent, start, end in spans[1:]:
        assert call == root[1] and parent == 0
        assert root[3] <= start <= end <= root[4]
    assert tm.snapshot()["calls"] == 1


def test_calls_get_their_own_ids():
    with tm.recording():
        flagship()
        inverse()
    spans = tm.spans()
    roots = [i for i, s in enumerate(spans) if s[0] == "call"]
    assert roots == [0, len(FLAGSHIP_SPANS)]
    ids = [s[1] for s in spans]
    assert ids == [ids[0]] * len(FLAGSHIP_SPANS) + \
        [ids[0] + 1] * len(IFFT_SPANS)
    assert [s[2] for s in spans[roots[1] + 1:]] == [roots[1]] * \
        (len(IFFT_SPANS) - 1)


def test_an_entry_inside_another_opens_no_second_root():
    """The isotropic PSD runs ``power_spectrum``, which runs ``fft``: one
    call, one root, and the binning under it."""
    with tm.recording():
        xt.isotropic_power_spectrum(field(shape=(2, 32, 32)), dim=["y", "x"],
                                    window="hann", detrend="linear",
                                    truncate=True)
    spans = tm.spans()
    assert [s[0] for s in spans].count("call") == 1
    assert spans[-1][0] == "binning" and spans[-1][2] == 0
    assert tm.snapshot()["calls"] == 1


def test_self_time_is_the_duration_less_the_children(monkeypatch):
    """On a clock that steps 1000 ns a read: ``a`` [0, 7000] holds ``b``
    [1000, 4000], which holds ``c`` [2000, 3000], and ``d`` [5000, 6000]."""
    clock = iter(range(0, 10 ** 6, 1000))
    monkeypatch.setattr(tm.time, "time_ns", lambda: next(clock))
    with tm.recording():
        with tm.span("a"):
            with tm.span("b"):
                with tm.span("c"):
                    pass
            with tm.span("d"):
                pass
    spans = tm.spans()
    assert [(s[0], s[2], s[3], s[4]) for s in spans] == [
        ("a", -1, 0, 7000), ("b", 0, 1000, 4000), ("c", 1, 2000, 3000),
        ("d", 0, 5000, 6000)]
    assert tm.self_ns() == {"a": 7000 - 3000 - 1000, "b": 3000 - 1000,
                            "c": 1000, "d": 1000}


def test_self_times_of_the_flagship_add_up_to_the_call():
    with tm.recording():
        flagship()
    spans = tm.spans()
    own = tm.self_ns()
    assert set(own) == set(FLAGSHIP_SPANS)
    assert all(v >= 0 for v in own.values())
    assert sum(own.values()) == spans[0][4] - spans[0][3]


@pytest.mark.parametrize("path", sorted(PATHS))
def test_recording_off_records_nothing_and_changes_no_bit(path):
    run, _ = PATHS[path]
    off = run()
    assert tm.spans() == [] and tm.chrome_events() == []
    with tm.recording():
        on = run()
    after = run()
    assert len(tm.spans()) == len(PATHS[path][1])   # kept, not grown
    for out in (on, after):
        assert out.dims == off.dims and out.dtype == off.dtype
        assert torch.equal(out.data, off.data)
        for c in off.coords:
            np.testing.assert_array_equal(out.coords[c].values,
                                          off.coords[c].values)


def test_the_off_span_is_one_shared_object():
    assert tm.span("coords") is tm.span("fft")
    with tm.recording():
        assert tm.span("coords") is not tm.span("coords")
    with pytest.raises(RuntimeError):
        with tm.recording():
            with tm.recording():
                pass


def test_snapshot_and_reset_hold_the_kernels_counts():
    flagship()
    inverse()
    mirror.mirror_psd.launches += 3
    dot.dot_dma.launches += 2
    fft_plan.build(96, -1)
    fft_plan.build(96, -1)
    snap = tm.snapshot()
    assert snap["calls"] == 2               # fft inside power_spectrum: not
    assert snap["host_syncs"] == snap["h2d_bytes"] == 0     # the CPU
    assert snap["host_wait_ns"] == snap["cufft_plans"] == 0
    assert snap["launches"] == {"K1": 3, "K2": 0, "K3": 0, "K4": 0,
                                "K5a": 0, "K5b": 0, "K5c": 2}
    assert set(snap["table_misses"]) == {"fft_plan", "fft_fourstep", "dft64",
                                         "stacked_fft", "matmul_fft"}
    assert snap["table_misses"]["fft_plan"] in (0, 1)  # 0: cached earlier
    assert isinstance(snap["build_seconds"], dict)
    json.dumps(snap)
    tm.reset()
    snap = tm.snapshot()
    assert mirror.mirror_psd.launches == 0 and dot.dot_dma.launches == 0
    assert all(v == 0 for k, v in snap.items()
               if k in tm.COUNTERS)
    assert set(snap["launches"].values()) == {0}
    assert set(snap["table_misses"].values()) == {0}
    fft_plan.build(96, -1)                          # a hit
    fft_plan.build(97, -1)                          # a miss, or cached
    assert tm.snapshot()["table_misses"]["fft_plan"] <= 1


def test_spans_carry_their_threads_id():
    """The id the profiler gives a thread: here and in another thread."""
    import threading

    ids = {}

    def record(key):
        with tm.span(key):
            pass
        ids[key] = threading.get_native_id()

    with tm.recording():
        record("main")
        worker = threading.Thread(target=record, args=("worker",))
        worker.start()
        worker.join(timeout=60)
    assert not worker.is_alive()
    got = {e["name"]: e["tid"] for e in tm.chrome_events()}
    assert got == ids and got["main"] != got["worker"]


def test_a_forked_childs_spans_carry_its_own_id():
    """The thread id is read once a thread; a forked child reads its own
    (run in a fresh interpreter, which forks before any thread starts)."""
    import subprocess
    import sys

    code = """
import json, os, threading
from xrft_tpu_torch import telemetry as tm
with tm.recording():
    with tm.span("parent"):
        pass
r, w = os.pipe()
pid = os.fork()
if pid == 0:
    with tm.recording():
        with tm.span("child"):
            pass
    os.write(w, json.dumps([tm.chrome_events()[0]["tid"],
                            threading.get_native_id()]).encode())
    os._exit(0)
os.close(w)
child = json.loads(os.read(r, 1000))
os.waitpid(pid, 0)
print(json.dumps(child + [threading.get_native_id()]))
"""
    p = subprocess.run([sys.executable, "-c", code], cwd=PKG.parent,
                       capture_output=True, text=True, timeout=120)
    assert p.returncode == 0, p.stderr[-2000:]
    tid, native, parent = json.loads(p.stdout.strip().splitlines()[-1])
    assert tid == native != parent


def test_a_span_open_across_a_reset_writes_nothing():
    with tm.recording():
        outer = tm.span("outer")
        outer.__enter__()
        tm.reset()
        with tm.span("inner"):
            pass
        outer.__exit__(None, None, None)
    assert [(s[0], s[2]) for s in tm.spans()] == [("inner", -1)]
    assert tm.spans()[0][4] is not None


def test_the_span_buffer_is_bounded(monkeypatch):
    monkeypatch.setattr(tm, "SPAN_LIMIT", 4)
    with tm.recording():
        flagship()
    spans = tm.spans()
    assert [s[0] for s in spans] == FLAGSHIP_SPANS[:4]
    assert tm.snapshot()["spans_dropped"] == len(FLAGSHIP_SPANS) - 4
    assert len(tm.chrome_events()) == 4
    monkeypatch.setattr(tm, "SPAN_LIMIT", 100)
    with tm.recording():                            # a new one: cleared
        flagship()
    assert len(tm.spans()) == len(FLAGSHIP_SPANS)


def test_chrome_events_lie_on_the_profilers_clock(tmp_path):
    """A span around a ``record_function`` range, laid on the profiler's
    chrome trace by its ``baseTimeNanoseconds``, holds the range within
    200 us at each edge, on the same process and thread."""
    from torch.profiler import ProfilerActivity, profile, record_function

    with tm.recording():
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            with record_function("warm"):       # the profiler's first range
                torch.ones(8).sum()
            with tm.span("outer"):
                with record_function("inner"):
                    torch.ones(1000).cumsum(0)
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    trace = json.loads(path.read_text())
    inner = next(e for e in trace["traceEvents"] if e.get("name") == "inner")
    events = tm.chrome_events(trace.get("baseTimeNanoseconds", 0))
    outer = next(e for e in events if e["name"] == "outer")
    assert outer["ph"] == "X" and outer["args"]["parent"] == -1
    assert outer["ts"] <= inner["ts"] + 200
    assert outer["ts"] + outer["dur"] >= inner["ts"] + inner["dur"] - 200
    assert outer["ts"] >= inner["ts"] - 5000     # not far before it
    assert (outer["pid"], outer["tid"]) == (inner["pid"], inner["tid"])


def test_to_device_is_as_tensor_off_the_card():
    w = np.hanning(7)
    for dtype in (None, torch.float32):
        got = tm.to_device(w, dtype=dtype, device="cpu")
        ref = torch.as_tensor(w, dtype=dtype, device="cpu")
        assert got.dtype == ref.dtype and torch.equal(got, ref)
    assert tm.to_device(np.zeros(0), device="cpu").numel() == 0
    assert tm.snapshot()["host_syncs"] == 0


# the modules whose host-to-device copies sit on the spans' paths
COPY_MODULES = ("spectra.py", "transform.py", "highprec.py", "detrend.py",
                "ops/window.py", "ops/shards.py", "ops/mirror.py")


@pytest.mark.parametrize("module", COPY_MODULES)
def test_host_copies_go_through_to_device(module):
    """No ``torch.as_tensor(..., device=...)`` is left in these modules:
    each such copy onto the card blocks the host, and ``to_device`` counts
    it."""
    tree = ast.parse((PKG / module).read_text())
    left = [node.lineno for node in ast.walk(tree)
            if isinstance(node, ast.Call)
            and isinstance(node.func, ast.Attribute)
            and node.func.attr == "as_tensor"
            and any(k.arg == "device" for k in node.keywords)]
    assert left == [], f"{module}: torch.as_tensor(device=) at {left}"
    assert "to_device" in (PKG / module).read_text()


def test_the_exported_names_are_the_entries():
    """The package's own calls take the modules' functions, unwrapped: a
    wrapper holds its arguments until it returns, and the hp path's float64
    copy, passed to ``transform.fft``, is let go of once detrended.  The
    exported names are marked, over the xarray boundary's wrapper, which
    holds them already."""
    from xrft_tpu_torch import highprec, isotropic, spectra, transform
    for mod, name in ((spectra, "power_spectrum"),
                      (spectra, "cross_spectrum"), (spectra, "welch"),
                      (isotropic, "isotropic_power_spectrum"),
                      (transform, "fft"), (transform, "ifft"),
                      (highprec, "fft64")):
        inner = getattr(mod, name)
        outer = getattr(xt, name)
        assert not hasattr(inner, "__wrapped__")
        assert outer.__wrapped__.__wrapped__ is inner
        assert outer.__name__ == name and outer.__doc__ == inner.__doc__


def test_the_hp_paths_float64_copy_goes_once_detrended(monkeypatch):
    """The float64 copy the hp path makes of the data is gone by the time
    the window is applied: no wrapper holds it through ``transform.fft``."""
    import gc
    import sys
    import weakref

    det = sys.modules["xrft_tpu_torch.detrend"]
    win = sys.modules["xrft_tpu_torch.ops.window"]
    seen = {}

    def detrend(da, *args, **kwargs):
        seen["copy"] = weakref.ref(da.data)
        return real_detrend(da, *args, **kwargs)

    def apply_window(da, *args, **kwargs):
        gc.collect()
        seen["alive"] = seen["copy"]() is not None
        return real_window(da, *args, **kwargs)

    real_detrend, real_window = det.detrend, win.apply_window
    monkeypatch.setattr(det, "detrend", detrend)
    monkeypatch.setattr(win, "apply_window", apply_window)
    hp()
    assert seen == {"copy": seen["copy"], "alive": False}
