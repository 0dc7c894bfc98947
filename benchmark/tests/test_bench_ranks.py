"""Cells that run across ranks, on gloo ranks on the CPU: a tiny sharded
3-D PSD cell (``rank_cells``) through the whole launcher, each run in a
process of its own that is ended after ``rank_cells.TIME_LIMIT_S``; the
global input at 1, 2 and 4 ranks; the sampled check against the plain
reference; and a one-card cell, which starts no process group and no
process."""

import json
import math
import multiprocessing
import time

import numpy as np
import pytest
import torch
import torch.distributed as dist

import bench_helpers as H
import rank_cells as RC
import run as bench_run
from harness import device, ranks
from reference import sharded_power_spectrum as ref3

SEED = 2147483659


@pytest.mark.parametrize("world", [2, 4])
def test_a_sharded_run_prints_one_line_and_is_correct(world, tmp_path):
    p = RC.run(RC.sharded_root(tmp_path, world), world)
    assert p.returncode == 0, p.stderr[-4000:]
    lines = [s for s in p.stdout.splitlines() if s.startswith("{")]
    assert len(lines) == 1
    line = json.loads(lines[0])
    assert list(line) == ["correct", "attempted", "failed", "metrics",
                          "device", "checks"]
    assert line["correct"] is True and line["failed"] == 0, line["checks"]
    assert line["checks"]["rel_err"]["value"] < RC.LIMIT / 10
    assert {"fields_per_s", "call_p95_ms", "setup_s"} <= set(line["metrics"])
    assert line["device"]["count"] == world
    tail = p.stderr.strip().splitlines()[-len(line["checks"]):]
    assert [t.split()[1] for t in tail] == list(line["checks"])


def test_the_global_input_is_the_same_at_1_2_and_4_ranks(tmp_path):
    roots = {n: RC.sharded_root(tmp_path / str(n), n) for n in (1, 2, 4)}
    stacks = {n: RC.global_input(roots[n], n, SEED) for n in roots}
    assert list(stacks[1][0].shape) == H.tiny_shape([2, 2048, 2048, 2048])
    for n in (2, 4):
        for s in range(2):
            assert torch.equal(stacks[n][s], stacks[1][s])
    assert not torch.equal(stacks[1][0], stacks[1][1])
    assert not torch.equal(RC.global_input(roots[2], 2, SEED + 1)[0],
                           stacks[1][0])


@pytest.mark.parametrize("fault", ["alter_rank1", "no_exchange"])
def test_a_fault_in_one_rank_is_not_correct(fault, tmp_path):
    """Rank 1's block altered where it is produced, or the exchange
    between ranks left out: ``correct`` comes out false."""
    p = RC.run(RC.sharded_root(tmp_path, 2), 2, wrap=fault)
    assert p.returncode == 0, p.stderr[-4000:]
    line = RC.last_line(p)
    assert line["correct"] is False
    assert line["checks"]["rel_err"]["value"] > RC.LIMIT


@pytest.mark.parametrize("fault", ["raise_on_rank1", "kill_rank1"])
def test_a_rank_that_fails_ends_the_run(fault, tmp_path):
    """A rank that raises mid-window while its peer waits in an exchange,
    or that dies: the run exits non-zero, prints no result and leaves no
    rank behind, well inside the time limit."""
    t0 = time.monotonic()
    p = RC.run(RC.sharded_root(tmp_path, 2), 2, wrap=fault, timeout_s=10)
    assert p.returncode != 0
    assert p.stdout.strip() == ""
    assert "rank 1 exited" in p.stderr or "rank 0 exited" in p.stderr
    assert time.monotonic() - t0 < RC.TIME_LIMIT_S


def test_a_traced_run_on_two_ranks_gives_the_per_layer_metrics(tmp_path):
    p = RC.run(RC.sharded_root(tmp_path, 2), 2, trace=1)
    assert p.returncode == 0, p.stderr[-4000:]
    line = RC.last_line(p)
    assert line["correct"] is True
    units = {m["name"]: m["unit"] for m in H.spec()["per_layer"]}
    assert "host_call_ms" in line["metrics"]
    for name, m in line["metrics"].items():
        assert m["unit"] == units[name]
    d = line["device"]
    assert d["window_s"] > 0 and "busy_s" in d
    assert set(line["breakdown"]) == {"device_ops", "idle_gaps"}


def test_the_peak_is_the_fullest_cards(tmp_path):
    p = RC.run(RC.sharded_root(tmp_path, 2), 2, make_device="PeakCpu")
    assert p.returncode == 0, p.stderr[-4000:]
    line = RC.last_line(p)
    assert line["device"]["rank_peak_bytes"] == [2 ** 30, 2 ** 31]
    assert line["device"]["memory_peak_bytes"] == 2 ** 31
    assert line["metrics"]["peak_mem_gib"]["value"] == 2.0


def test_control_reads_a_sharded_cell_through_the_launcher(tmp_path):
    p = RC.run(RC.sharded_root(tmp_path, 2), 2, script="control")
    assert p.returncode == 0, p.stderr[-4000:]
    lines = [json.loads(s) for s in p.stdout.splitlines()
             if s.startswith("{")]
    seeds = [x for x in lines if "seed" in x]
    assert [x["seed"] for x in seeds] == [1, 2]
    summary = lines[-1]
    assert summary["program_max"] < RC.LIMIT / 10
    assert summary["control_min"] > 3 * RC.LIMIT
    assert summary["half_output_min"] > 3 * RC.LIMIT
    assert all(x["labels"] == 0 for x in seeds)


def test_a_sharded_cell_without_cards_fails_and_prints_nothing(tmp_path,
                                                              capsys):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is visible")
    root = RC.sharded_root(tmp_path, 2)
    rc = bench_run.main(["--workload", RC.cell_name(2), "--seed", "5",
                         "--seconds", "1", "--trace", "0"], root=root)
    out, err = capsys.readouterr()
    assert rc != 0 and out.strip() == ""
    assert "no CUDA device" in err


def test_a_mesh_that_is_not_the_cells_chips_fails(tmp_path, capsys):
    root = RC.sharded_root(tmp_path, 2)
    spec = json.loads((root / "BENCHMARK.json").read_text())
    spec["workloads"][-1]["chips"] = 4
    (root / "BENCHMARK.json").write_text(json.dumps(spec))
    rc = bench_run.main(["--workload", RC.cell_name(2), "--seed", "5",
                         "--seconds", "1", "--trace", "0"], root=root,
                        launch=ranks.Launch(make_device=device.Cpu))
    out, err = capsys.readouterr()
    assert rc != 0 and out.strip() == ""
    assert "4 chips" in err


@pytest.mark.parametrize("trace", [0, 1])
def test_a_one_card_run_starts_no_group_and_no_process(trace, tmp_path,
                                                      capsys, monkeypatch):
    def refuse(*args, **kwargs):
        raise AssertionError("a one-card run started a group or a process")

    monkeypatch.setattr(dist, "init_process_group", refuse)
    monkeypatch.setattr(dist, "new_group", refuse)
    monkeypatch.setattr(multiprocessing, "get_context", refuse)
    monkeypatch.setattr(ranks, "launch", refuse)
    root = H.tiny_root(tmp_path)
    rc = bench_run.main(["--workload", "mitgcm-4096.psd", "--seed",
                         str(SEED), "--seconds", "0.05", "--trace",
                         str(trace)], root=root,
                        make_device=lambda chips: device.Cpu())
    out, err = capsys.readouterr()
    assert rc == 0, err
    assert not dist.is_initialized()
    assert multiprocessing.active_children() == []
    line = json.loads(out.strip().splitlines()[-1])
    assert list(line) == ["correct", "attempted", "failed", "metrics",
                          "device"] + (["breakdown"] if trace else []) + [
                              "checks"]
    assert set(line["device"]) == {"platform", "kind", "count",
                                   "memory_peak_bytes"} | (
        {"busy_s", "window_s"} if trace else set())
    assert list(line["checks"]) == ["rel_err", "dims_mismatch",
                                    "dtype_mismatch", "coord_mismatch"]


def test_tiny_shapes_cut_a_4d_configuration_to_lengths_the_ranks_divide():
    shape = H.tiny_shape([1, 2048, 2048, 2048])
    assert shape == [1, 64, 64, 64]
    assert all(n % 4 == 0 for n in shape[1:])
    assert H.tiny_shape([1, 4096, 4096, 4096])[1:] == [64, 64, 64]


def _whole_psd(x: np.ndarray, d) -> np.ndarray:
    """numpy's two-sided PSD of one 3-D field: the least-squares hyperplane
    removed, the Hann window, |fftn|^2 scaled, fftshifted."""
    x = x.astype(np.float64)
    grids = np.meshgrid(*[np.arange(n) - (n - 1) / 2 for n in x.shape],
                        indexing="ij")
    a = np.stack([np.ones(x.size)] + [g.ravel() for g in grids], 1)
    coef = np.linalg.lstsq(a, x.ravel(), rcond=None)[0]
    p = x - (a @ coef).reshape(x.shape)
    for k, n in enumerate(x.shape):
        w = ref3.hann(n).reshape([-1 if j == k else 1
                                  for j in range(x.ndim)])
        p = p * w
    scale = math.prod(d) ** 2 / math.prod(n * e for n, e in zip(x.shape, d))
    return np.fft.fftshift(np.abs(np.fft.fftn(p)) ** 2 * scale)


@pytest.mark.parametrize("axis", [1, 2, 3])
@pytest.mark.parametrize("slab_axis", [0, 1])
def test_the_sharded_reference_gives_planes_of_the_whole_spectrum(
        axis, slab_axis, monkeypatch):
    """Planes of the streamed reference, in float64, against numpy's whole
    spectrum of each field, chunked along the slab axis or along the first
    transform dim; the controls lie far above the float32 limit."""
    monkeypatch.setattr(ref3, "CHUNK_BYTES", 8 * 12 * 10 * 3)
    g = torch.Generator().manual_seed(7)
    x = torch.randn(2, 8, 12, 10, generator=g, dtype=torch.float64) * 2 + 5
    dims = ("component", "z", "y", "x")
    d = (0.5, 1.0, 0.25)
    coords = {"component": np.arange(2.0), "z": np.arange(8) * d[0],
              "y": np.arange(12) * d[1], "x": np.arange(10) * d[2]}
    kw = {"dim": ["z", "y", "x"], "window": "hann", "detrend": "linear"}
    for f in range(2):
        whole = _whole_psd(x[f].numpy(), d)
        for k in (0, x.shape[axis] // 2, x.shape[axis] - 1):
            got = ref3.plane(lambda j: x.select(slab_axis, j), x.shape,
                             slab_axis, dims, coords, kw, {0: f, axis: k})
            want = np.take(whole, k, axis=axis - 1)
            assert np.abs(got.numpy() - want).max() <= \
                1e-12 * np.abs(whole).max()
        c = ref3.plane(lambda j: x.select(slab_axis, j), x.shape, slab_axis,
                       dims, coords, kw, {0: f, axis: 1}, "tf32")
        want = np.take(whole, 1, axis=axis - 1)
        assert np.abs(c.numpy() - want).max() > 3 * RC.LIMIT * \
            np.abs(want).max()
    _, labels = ref3.labels(dims, coords, kw)
    assert np.array_equal(labels["freq_y"], np.fft.fftshift(
        np.fft.fftfreq(12, 1.0)))
