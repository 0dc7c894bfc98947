"""The metric arithmetic on synthetic inputs: the p95 over all calls, idle as
the union of device intervals, the roofline work of each layer for each
dtype, and the attribution of device operations to layers by their Python
stack."""

import math

import pytest
import torch

import bench_helpers as H  # noqa: F401  (puts the benchmark on sys.path)
from harness import cells, roofline, runner, stats, trace


def test_p95_is_the_nearest_rank_over_all_calls():
    xs = list(range(1, 101))            # 100 calls, 1..100 ms
    assert stats.percentile(xs, 95) == 95
    assert stats.percentile(xs[::-1], 95) == 95
    assert stats.percentile([7.0], 95) == 7.0
    assert stats.percentile(list(range(1, 21)), 95) == 19
    with pytest.raises(ValueError):
        stats.percentile([], 95)


def test_idle_is_the_union_of_device_intervals():
    # two overlapping kernels, one inside another, one clipped at each end
    iv = [(0, 10), (5, 15), (6, 7), (30, 40), (-5, 2), (95, 120)]
    busy = trace.union_seconds(iv, 0, 100)
    assert busy == pytest.approx((15 + 10 + 5) * 1e-6)


def _py(name, ts, dur, tid=1):
    return {"ph": "X", "cat": "python_function", "name": name, "ts": ts,
            "dur": dur, "tid": tid, "pid": 1}


def _launch(corr, ts, tid=1, cat="cuda_runtime"):
    return {"ph": "X", "cat": cat, "name": "cudaLaunchKernel", "ts": ts,
            "dur": 1, "tid": tid, "pid": 1, "args": {"correlation": corr}}


def _kernel(corr, name, ts, dur, cat="kernel"):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur,
            "tid": 7, "pid": 0, "args": {"correlation": corr}}


def synthetic_trace():
    """One call of 1000 us: the window multiply launched from labeled.py
    inside ops/window.py (a container frame under the prologue), the
    detrend's sum, cuFFT through cuLaunchKernel from fft_core.py, K1 with
    no Python stack (the name pattern places it), a memcpy from coords.py,
    and a kernel launched outside the port."""
    ev = [{"ph": "X", "cat": "user_annotation", "name": trace.STRETCH,
           "ts": 0, "dur": 1000, "tid": 1, "pid": 1}]
    ev += [
        _py("benchmark/harness/runner.py(60): __call__", 1, 998),
        _py("xrft_tpu_torch/spectra.py(359): power_spectrum", 2, 990),
        _py("xrft_tpu_torch/detrend.py(80): _detrended", 10, 100),
        _py("xrft_tpu_torch/ops/window.py(88): apply_window", 120, 50),
        _py("xrft_tpu_torch/labeled.py(300): __mul__", 125, 40),
        _py("xrft_tpu_torch/ops/fft_core.py(150): rfftn", 200, 60),
        _py("xrft_tpu_torch/coords.py(96): get_coordinate_spacing", 300, 10),
        _py("somewhere/else.py(1): helper", 400, 10),
    ]
    ev += [_launch(1, 20), _kernel(1, "reduce_kernel<double>", 100, 200)]
    ev += [_launch(2, 130), _kernel(2, "elementwise_mul", 300, 100)]
    ev += [_launch(3, 210, cat="cuda_driver"),
           _kernel(3, "regular_fft_factor", 400, 300)]
    ev += [_launch(4, 305), _kernel(4, "Memcpy HtoD", 700, 10,
                                    cat="gpu_memcpy")]
    ev += [_kernel(5, "void mirror_pairs_kernel<float2>", 750, 100)]
    ev += [_launch(6, 995), _kernel(6, "mystery_kernel", 900, 50)]
    return ev


def timing_trace():
    """The same call traced with device activity alone: the operations in
    the same order, a gap of 100 us before cuFFT while the host sat in a
    pageable copy, and nothing of Python."""
    ev = [_kernel(1, "reduce_kernel<double>", 0, 200),
          _kernel(2, "elementwise_mul", 200, 100),
          {"ph": "X", "cat": "cuda_runtime", "name": "cudaMemcpyAsync",
           "ts": 320, "dur": 60, "tid": 1, "pid": 1},
          _kernel(3, "regular_fft_factor", 400, 300),
          _kernel(4, "Memcpy HtoD", 700, 10, cat="gpu_memcpy"),
          _kernel(5, "void mirror_pairs_kernel<float2>", 750, 100),
          _kernel(6, "mystery_kernel", 900, 50)]
    return ev


def test_device_ops_are_attributed_to_layers_by_their_stack():
    attributed = trace.attribute(synthetic_trace(), trace.load_layer_map(),
                                 {"mirror_pairs_kernel": "epilogue"})
    assert [a[0] for a in attributed] == [
        "prologue", "prologue", "fft", "api coords", "epilogue",
        trace.UNATTRIBUTED]
    s = trace.summarize(timing_trace(), 1000e-6, 1, attributed, 1)
    assert s.layer_s == pytest.approx({
        "prologue": 300e-6, "fft": 300e-6, "api coords": 10e-6,
        "epilogue": 100e-6, trace.UNATTRIBUTED: 50e-6})
    # the timing stretch's length is the host's, its busy time the union
    # of its own device intervals: [0, 300], [400, 710], [750, 850],
    # [900, 950]
    assert s.window_s == pytest.approx(1000e-6)
    assert s.busy_s == pytest.approx((300 + 310 + 100 + 50) * 1e-6)
    assert s.call_wall_s == pytest.approx(1000e-6)
    assert s.layer_ms_per_call("prologue") == pytest.approx(0.3)
    # the longest idle gap is the 100 us before cuFFT, while the host sat
    # in a copy; the op after it is named with its layer and launch frame
    label, gap = s.gaps[0]
    assert gap == pytest.approx(100e-6)
    assert "cudaMemcpyAsync" in label and "fft:" in label
    assert "fft_core.py" in label
    # the stretch's edges: 50 us after the last device op
    assert ("host before the stretch's first device op and after its "
            "last", pytest.approx(50e-6)) in s.gaps
    assert [op[0] for op in s.ops][:2] == ["fft", "prologue"] or \
        s.ops[0][2] == pytest.approx(300e-6)
    b = trace.breakdown(s)
    assert len(b["device_ops"]) == 6 and len(b["idle_gaps"]) <= 10
    assert all(isinstance(v, float) for _, v in b["device_ops"])


def test_gap_labels_hold_over_a_longer_timing_stretch():
    """The timing stretch runs more calls than the attributed one: each
    gap is still named by the operation after it, its layer and launch."""
    attributed = trace.attribute(synthetic_trace(), trace.load_layer_map(),
                                 {"mirror_pairs_kernel": "epilogue"})
    timing = []
    for c in range(3):
        for e in timing_trace():
            timing.append(dict(e, ts=e["ts"] + 1000 * c))
    s = trace.summarize(timing, 3000e-6, 3, attributed, 1)
    assert s.busy_s == pytest.approx(3 * 760e-6)
    assert s.call_wall_s == pytest.approx(1000e-6)
    fft = [g for g in s.gaps if "fft_core.py" in g[0]]
    assert len(fft) == 3 and all(g[1] == pytest.approx(100e-6) for g in fft)
    # the 50 us between calls: the host before the next call's detrend
    assert any("before prologue" in g[0] and g[1] == pytest.approx(50e-6)
               for g in s.gaps)


def test_the_innermost_named_frame_decides():
    lm = trace.load_layer_map()
    assert trace.layer_of_stack([
        "torch/fft/x.py(1): f",
        "xrft_tpu_torch/ops/fft_core.py(1): rfftn",
        "xrft_tpu_torch/transform.py(205): fft",
        "xrft_tpu_torch/spectra.py(1): power_spectrum"], lm) == "fft"
    assert trace.layer_of_stack([
        "xrft_tpu_torch/transform.py(91): _stack_segments",
        "xrft_tpu_torch/transform.py(205): fft"], lm) == "segmenting"
    # a container decides only where nothing else is named
    assert trace.layer_of_stack([
        "xrft_tpu_torch/labeled.py(1): __mul__",
        "xrft_tpu_torch/highprec.py(1): power_spectrum_hp"], lm) == \
        "api coords"
    assert trace.layer_of_stack([
        "xrft_tpu_torch/ops/shards.py(1): local"], lm) == "sharding"
    assert trace.layer_of_stack([
        "xrft_tpu_torch/parallel/pencil.py(1): step"], lm) == "sharding"
    assert trace.layer_of_stack(["xrft_tpu/transform.py(1): fft"], lm) is None
    assert trace.layer_of_stack([], lm) is None


@pytest.mark.parametrize("hp", [False, True])
def test_roofline_work_of_each_layer_of_the_psd(hp):
    work = cells.entry_module("work", "power_spectrum")
    f, ny, nx = 64, 4096, 4096
    kw = {"engine": "hp"} if hp else {}
    w = work.layers((f, ny, nx), torch.float32, kw)
    real = 8 if hp else 4
    n = ny * nx
    assert w["prologue"]["bytes"] == f * n * (4 + real)
    assert w["fft"]["bytes"] == f * n * real + f * ny * 2049 * 2 * real
    assert w["epilogue"]["bytes"] == f * ny * 2049 * 2 * real + f * n * real
    assert w["call"]["bytes"] == f * n * (4 + real)
    assert w["fft"]["flops"] == f * 2.5 * n * math.log2(n)
    assert w["fft"]["peak"] == ("float64" if hp else "float32")
    # the flagship's call: 4.3 GB read and 4.3 GB written at 3.35 TB/s
    if not hp:
        assert roofline.least_seconds(w["call"]) == pytest.approx(
            2 * f * n * 4 / 3.35e12)


def test_roofline_work_of_the_inverse():
    work = cells.entry_module("work", "ifft")
    w = work.layers((64, 4096, 2049), torch.complex64, {})
    half, out = 64 * 4096 * 2049 * 8, 64 * 4096 * 4096 * 4
    assert w["call"]["bytes"] == w["fft"]["bytes"] == half + out
    assert "prologue" not in w and "epilogue" not in w
    w64 = work.layers((2, 8, 5), torch.complex128, {})
    assert w64["fft"]["bytes"] == 2 * 8 * 5 * 16 + 2 * 8 * 8 * 8
    assert w64["fft"]["peak"] == "float64"


def test_least_time_takes_the_longer_bound():
    w = {"bytes": 3.35e12, "flops": 67e12 * 2, "peak": "float32"}
    assert roofline.least_seconds(w) == pytest.approx(2.0)
    w["flops"] = 0.0
    assert roofline.least_seconds(w) == pytest.approx(1.0)


def _reading(summary, calls=((64, 0.002, 0.05),) * 20, name="mitgcm-4096.psd"):
    cell = cells.load(H.ROOT, name)
    work = cells.entry_module("work", cell.mix["entry"]).layers(
        (64, 4096, 4096), torch.float32, {})
    w = runner.Window(calls=list(calls), seconds=1.0)
    return cell, runner.Reading(cell, work, w, 7.5, 3 * 2 ** 30, summary)


def test_metric_readers_on_a_synthetic_run():
    s = trace.Summary(calls=2, timed_calls=2, window_s=0.1, busy_s=0.09,
                      layer_s={"prologue": 0.06, "fft": 0.02,
                               "epilogue": 0.008})
    cell, r = _reading(s)
    got = {m.name: m.reader.read(r) for m in cell.end_to_end + cell.per_layer}
    assert got["fields_per_s"] == pytest.approx(64 * 20 / 1.0)
    assert got["call_p95_ms"] == pytest.approx(50.0)
    assert got["peak_mem_gib"] == pytest.approx(3.0)
    assert got["setup_s"] == 7.5
    assert got["host_call_ms"] == pytest.approx(2.0)
    assert got["device_idle_share"] == pytest.approx(10.0)
    assert got["prologue_ms"] == pytest.approx(30.0)
    least = 64 * 4096 * 4096 * 8 / 3.35e12
    assert got["call_roofline"] == pytest.approx(100 * least / 0.05)
    assert got["prologue_roofline"] == pytest.approx(100 * least / 0.030)
    assert got["k1_roofline"] == pytest.approx(
        100 * (64 * 4096 * 2049 * 8 + 64 * 4096 * 4096 * 4) / 3.35e12
        / 0.004)


def test_readers_that_find_nothing_return_nothing():
    s = trace.Summary(calls=2, timed_calls=2, window_s=0.1, busy_s=0.0,
                      layer_s={})
    cell, r = _reading(s, name="mitgcm-4096.psd")
    for m in cell.per_layer:
        if m.name != "host_call_ms":
            assert m.reader.read(r) is None, m.name
    cell, r = _reading(None, calls=())
    for m in cell.end_to_end + cell.per_layer:
        if m.name not in ("setup_s", "peak_mem_gib"):
            assert m.reader.read(r) is None, m.name
