"""The program's spans and counters as the benchmark reads them: the span
stretch's reading on a synthetic trace (host waits, coords self time, the
idle time inside calls, the first-launch gap, device time by span with a
launch through ctypes), the counters' readers and their silence where the
program has no telemetry or counted other calls, and whole tiny runs on
the CPU: the benchmark's traced run and ``spans.py``."""

import json
import sys
import types

import pytest

import bench_helpers as H
import run as bench_run
import spans as bench_spans
from harness import cells, device, runner, spans, trace

CELLS = ("mitgcm-4096.psd", "glorys12-daily.psd", "mitgcm-4096.irfft2",
         "mitgcm-4096.psd-hp")


def _span(name, index, parent, ts, dur, call=0, tid=1):
    return {"ph": "X", "cat": "xrft_tpu_torch", "name": name, "ts": ts,
            "dur": dur, "pid": 1, "tid": tid,
            "args": {"call": call, "index": index, "parent": parent}}


def _runtime(name, ts, dur=1, corr=None, cat="cuda_runtime"):
    e = {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur,
         "tid": 1, "pid": 1}
    if corr is not None:
        e["args"] = {"correlation": corr}
    return e


def _op(corr, name, ts, dur, cat="kernel"):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur,
            "tid": 7, "pid": 0, "args": {"correlation": corr}}


def synthetic_stretch():
    """One call [100, 900] in a stretch [0, 1200] (us): a prologue with a
    blocking copy (its memcpy launched inside the ``sync`` span), cuFFT,
    K1 launched through the driver API with no Python frame, a ``coords``
    span holding a ``sync`` span, an operation launched after the call and
    one whose launch the trace lacks."""
    ev = [_span("call", 0, -1, 100, 800), _span("coords", 1, 0, 110, 40),
          _span("prologue", 2, 0, 160, 200), _span("sync", 3, 2, 170, 100),
          _span("fft", 4, 0, 380, 100), _span("epilogue", 5, 0, 500, 60),
          _span("coords", 6, 0, 600, 100), _span("sync", 7, 6, 620, 20)]
    ev += [_runtime("cudaLaunchKernel", 165, corr=1),
           _op(1, "reduce_kernel", 200, 60),
           _runtime("cudaMemcpyAsync", 175, corr=2),
           _op(2, "Memcpy HtoD (Pageable -> Device)", 265, 5, "gpu_memcpy"),
           _runtime("cudaStreamSynchronize", 180, 80),
           _runtime("cudaLaunchKernel", 300, corr=3),
           _op(3, "elementwise_mul", 305, 65),
           _runtime("cuLaunchKernel", 390, corr=4, cat="cuda_driver"),
           _op(4, "regular_fft", 395, 75),
           _runtime("cudaLaunchKernel", 510, corr=5),
           _op(5, "void mirror_pairs_kernel<float2>", 512, 88),
           _runtime("cudaStreamSynchronize", 625, 10),
           _runtime("cudaDeviceSynchronize", 905, 5),
           _runtime("cudaLaunchKernel", 1000, corr=6),
           _op(6, "stray", 1010, 40),
           _op(99, "no_launch", 1100, 10)]
    before = {"calls": 5, "host_syncs": 10, "launches": {"K1": 1}}
    after = {"calls": 6, "host_syncs": 12, "launches": {"K1": 2}}
    return spans.Stretch(ev, 0.0, 1200.0, 1, 1.2e-3, before, after)


def test_the_span_stretch_reading():
    r = spans.read(synthetic_stretch())
    assert r.calls == 1 and r.wall_ms == pytest.approx(1.2)
    assert r.host_wait_ms == pytest.approx(0.120)          # 100 + 20 us
    assert r.coords_host_ms == pytest.approx(0.120)        # 40 + 100 - 20
    # idle: [0,200] [260,265] [270,305] [370,395] [470,512] [600,1010]
    # [1050,1100] [1110,1200]; inside the call [100, 900]: 100 + 5 + 35 +
    # 25 + 42 + 300
    assert r.idle_share == pytest.approx(100 * 857 / 1200)
    assert r.call_idle_share == pytest.approx(100 * 507 / 1200)
    assert r.first_gap_ms == pytest.approx((0.1, 0.1))
    assert r.device_ms == pytest.approx({
        "prologue": 0.130, "fft": 0.075, "epilogue": 0.088,
        spans.OUTSIDE: 0.040, trace.UNATTRIBUTED: 0.010})
    assert r.stream_syncs == 2                 # the device sync is not one
    assert r.counters == {"calls": 1, "host_syncs": 2, "launches.K1": 1}
    assert spans.layer_ms({"call": 1.0, "coords": 0.5, "fft": 2.0}) == \
        {"api coords": 1.5, "fft": 2.0}


def test_a_launch_with_no_python_frame_takes_its_span():
    """K1 goes through ctypes: its launch has no Python stack, and the
    stack attribution needs the kernel's name; the span holds it."""
    ev = synthetic_stretch().events
    assert spans.device_by_span(ev)["epilogue"] == pytest.approx(88)
    py = [e for e in ev if e.get("cat") == "python_function"]
    assert py == []


def test_self_time_subtracts_only_the_children():
    ev = [_span("coords", 0, -1, 0, 100), _span("coords", 1, 0, 10, 30),
          _span("sync", 2, 1, 15, 5), _span("fft", 3, -1, 200, 50)]
    assert spans.self_us(ev, "coords") == pytest.approx(100 - 30 + 30 - 5)
    assert spans.self_us(ev, "fft") == pytest.approx(50)
    assert spans.self_us(ev, "epilogue") == 0


def _reading(failed=0, traced=True):
    cell = cells.load(H.ROOT, "mitgcm-4096.psd")
    w = runner.Window(calls=[(64, 0.02, 0.04)] * 20, seconds=1.0,
                      failed=failed)
    s = trace.Summary(calls=6, timed_calls=10, window_s=0.4, busy_s=0.38) \
        if traced else None
    return cell, runner.Reading(cell, {}, w, 7.5, 2 ** 30, s)


def _program(monkeypatch, snapshot):
    """A loaded program whose telemetry reports ``snapshot``; None: a
    program without telemetry."""
    xt = types.SimpleNamespace()
    if snapshot is not None:
        xt.telemetry = types.SimpleNamespace(snapshot=lambda: dict(snapshot))
    monkeypatch.setitem(sys.modules, "xrft_tpu_torch", xt)


def test_the_counters_are_read_where_they_count_this_run(monkeypatch):
    made = 2 + 20 + 10 + 6
    _program(monkeypatch, {"calls": made, "host_syncs": 4 * made,
                           "host_wait_ns": made * 21_000_000})
    cell, r = _reading()
    got = {m.name: m.reader.read(r) for m in cell.per_layer
           if m.name in ("host_syncs", "host_wait_ms")}
    assert got == {"host_syncs": 4.0, "host_wait_ms": pytest.approx(21.0)}
    # a failed call counts too
    _program(monkeypatch, {"calls": made + 1, "host_syncs": 0,
                           "host_wait_ns": 0})
    assert spans.run_counters(_reading(failed=1)[1]) is not None


@pytest.mark.parametrize("snapshot,traced", [
    (None, True),                                         # no telemetry
    ({"calls": 37, "host_syncs": 1, "host_wait_ns": 1}, True),  # others
    ({"calls": 38, "host_syncs": 1, "host_wait_ns": 1}, False),  # untraced
    ({"calls": 0, "host_syncs": 0, "host_wait_ns": 0}, True),
])
def test_the_counters_read_nothing_otherwise(monkeypatch, snapshot, traced):
    _program(monkeypatch, snapshot)
    cell, r = _reading(traced=traced)
    for m in cell.per_layer:
        if m.name in ("host_syncs", "host_wait_ms"):
            assert m.reader.read(r) is None, m.name


@pytest.mark.parametrize("cell", CELLS)
def test_a_traced_tiny_run_reads_the_counters(cell, tmp_path, capsys):
    """A whole run on the CPU, the program's counters zeroed first: every
    call the harness made is counted once, and the CPU makes no blocking
    copy onto a card."""
    import xrft_tpu_torch as xt

    root = H.tiny_root(tmp_path)
    xt.telemetry.reset()
    rc = bench_run.main(["--workload", cell, "--seed", "2147483659",
                         "--seconds", "0.05", "--trace", "1"], root=root,
                        make_device=lambda chips: device.Cpu())
    out, err = capsys.readouterr()
    assert rc == 0, err
    m = json.loads(out.strip().splitlines()[-1])["metrics"]
    assert m["host_syncs"] == {"value": 0.0, "unit": "syncs/call"}
    assert m["host_wait_ms"] == {"value": 0.0, "unit": "ms"}


@pytest.mark.parametrize("cell", ["mitgcm-4096.psd", "mitgcm-4096.irfft2"])
def test_the_spans_tool_on_a_tiny_cell(cell, tmp_path, capsys):
    root = H.tiny_root(tmp_path)
    rc = bench_spans.main(["--workload", cell, "--seed", "7", "--seconds",
                           "0.05"], root=root,
                          make_device=lambda chips: device.Cpu())
    out, err = capsys.readouterr()
    assert rc == 0, err
    assert "after the warm-up" in err
    line = json.loads(out.strip().splitlines()[-1])
    assert line["bit_identical"] is True
    assert len(line["paired_cost_ms"]) == 3
    r = line["spans"]
    assert r["calls"] >= 2 and r["counters"]["calls"] == 1.0
    assert r["coords_host_ms"] > 0 and r["host_wait_ms"] == 0
    assert r["stream_syncs"] == 0 and line["span_wall_ms"] > 0
    assert line["snapshot"]["launches"]["K1"] == 0


def test_the_spans_tool_needs_the_programs_telemetry(monkeypatch, capsys):
    monkeypatch.setitem(sys.modules, "xrft_tpu_torch",
                        types.SimpleNamespace())
    assert bench_spans.main(["--workload", "mitgcm-4096.psd", "--seed",
                             "1"]) == 3
    assert "no telemetry" in capsys.readouterr().err
