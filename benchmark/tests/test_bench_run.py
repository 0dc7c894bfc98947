"""Whole runs of the harness on tiny cells on the CPU: the last line's
schema, a run that finds no card or no port, and the faults that the
comparison has to catch."""

import json
import os
import shutil
import subprocess
import sys

import pytest
import torch

import bench_helpers as H
import run as bench_run
from harness import device

CELLS = ("mitgcm-4096.psd", "glorys12-daily.psd", "mitgcm-4096.irfft2",
         "mitgcm-4096.psd-hp")
REQUIRED = ("correct", "attempted", "failed", "metrics", "device")


def _run(root, cell, trace, capsys, seconds="0.05", seed="2147483659"):
    rc = bench_run.main(["--workload", cell, "--seed", seed, "--seconds",
                         seconds, "--trace", str(trace)], root=root,
                        make_device=lambda chips: device.Cpu())
    out, err = capsys.readouterr()
    return rc, out, err


@pytest.mark.parametrize("trace", [0, 1])
@pytest.mark.parametrize("cell", CELLS)
def test_last_line_schema(cell, trace, tmp_path, capsys):
    root = H.tiny_root(tmp_path)
    rc, out, err = _run(root, cell, trace, capsys)
    assert rc == 0, err
    line = json.loads(out.strip().splitlines()[-1])
    assert all(k in line for k in REQUIRED)
    assert list(line)[-1] == "checks"
    assert line["correct"] is True and line["failed"] == 0
    assert line["attempted"] >= 1
    spec = H.spec()
    kind = "per_layer" if trace else "end_to_end"
    units = {m["name"]: m["unit"] for m in spec[kind]}
    for name, m in line["metrics"].items():
        assert set(m) == {"value", "unit"} and m["unit"] == units[name]
        assert isinstance(m["value"], float)
    if not trace:
        assert {"fields_per_s", "call_p95_ms", "setup_s"} <= set(
            line["metrics"])
    d = line["device"]
    assert {"platform", "kind", "count", "memory_peak_bytes"} <= set(d)
    if trace:
        assert d["window_s"] > 0 and "busy_s" in d
        b = line["breakdown"]
        assert len(b["device_ops"]) <= 10 and len(b["idle_gaps"]) <= 10
    for name, c in line["checks"].items():
        assert set(c) == {"value", "limit"}
    tail = err.strip().splitlines()[-len(line["checks"]):]
    assert [t.split()[1] for t in tail] == list(line["checks"])


def test_a_run_without_a_card_fails_and_prints_nothing():
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    p = subprocess.run(
        [sys.executable, str(H.BENCH / "run.py"), "--workload",
         "mitgcm-4096.psd", "--seed", "5", "--seconds", "1", "--trace", "0"],
        cwd=H.ROOT, env=env, capture_output=True, text=True, timeout=300)
    assert p.returncode != 0
    assert p.stdout.strip() == ""
    assert "no CUDA device" in p.stderr


def test_a_checkout_of_the_benchmark_alone_fails(tmp_path):
    shutil.copytree(H.BENCH, tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(H.ROOT / "BENCHMARK.json", tmp_path)
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    p = subprocess.run(
        [sys.executable, "benchmark/run.py", "--workload", "mitgcm-4096.psd",
         "--seed", "5", "--seconds", "1", "--trace", "0"],
        cwd=tmp_path, env=env, capture_output=True, text=True, timeout=300)
    assert p.returncode != 0
    assert p.stdout.strip() == ""
    assert "xrft_tpu_torch" in p.stderr


def _altered(out):
    """An answer altered where it is produced: the largest value zeroed."""
    flat = out.data.reshape(-1)
    flat[flat.abs().argmax()] = 0
    return out


def _half_batch(out):
    """Half of the batch left out: the second half of the fields replaced
    by the mean over the first half."""
    h = out.data.shape[0] // 2
    out.data[h:] = out.data[:h].mean(dim=0, keepdim=True)
    return out


class _Stale:
    """A call that returns its state unchanged: the first output, again."""

    def __init__(self):
        self.first = None

    def __call__(self, out):
        if self.first is None:
            self.first = out
        return self.first


FAULTS = {"altered": lambda: _altered, "half_batch": lambda: _half_batch,
          "stale": _Stale}


@pytest.mark.parametrize("fault", sorted(FAULTS))
@pytest.mark.parametrize("cell", CELLS)
def test_a_broken_timed_path_is_not_correct(cell, fault, tmp_path, capsys,
                                           monkeypatch):
    """The run's own flow, the chip check skipped, with the entry broken
    underneath: ``correct`` comes out false."""
    import xrft_tpu_torch as xt

    root = H.tiny_root(tmp_path)
    entry = H.load_cell(root, cell).mix["entry"]
    real = getattr(xt, entry)
    broken = FAULTS[fault]()
    monkeypatch.setattr(xt, entry, lambda da, **kw: broken(real(da, **kw)))
    rc, out, err = _run(root, cell, 0, capsys)
    assert rc == 0, err
    line = json.loads(out.strip().splitlines()[-1])
    assert line["correct"] is False, line["checks"]


@pytest.mark.cuda
def test_the_flagship_runs_correct_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    p = subprocess.run(
        [sys.executable, str(H.BENCH / "run.py"), "--workload",
         "mitgcm-4096.psd", "--seed", "2147483659", "--seconds", "2",
         "--trace", "0"],
        cwd=H.ROOT, capture_output=True, text=True, timeout=900)
    assert p.returncode == 0, p.stderr[-4000:]
    assert json.loads(p.stdout.strip().splitlines()[-1])["correct"] is True
