"""Helpers of the multi-rank tests: a tiny sharded 3-D cell added to a tiny
copy of the benchmark (``bench_helpers``), whole runs of it on gloo ranks on
the CPU in a process of their own with a time limit, and the faults and
devices the tests plant in the ranks (each rank imports this module by
name, so they are top-level functions and classes)."""

from __future__ import annotations

import json
import os
import signal
import subprocess
import sys
from pathlib import Path

import torch

import bench_helpers as H
from harness import device

HERE = Path(__file__).resolve().parent
CONFIG = "dns-test"
LIMIT = 4e-5               # float32, as the float32 PSD cells' limits
TIME_LIMIT_S = 120


def cell_name(ranks: int) -> str:
    return f"{CONFIG}.psd3d-{ranks}"


def sharded_root(tmp: Path, ranks: int) -> Path:
    """``bench_helpers.tiny_root`` plus a cell of a 4-D (component, z, y,
    x) float32 configuration, 2 x 2048^3 cut by ``tiny_shape`` to 2 x 64^3,
    whose mix takes the 3-D PSD over (z, y, x) through
    ``xrft_tpu_torch.parallel.sharded_power_spectrum`` on the mesh
    {"fp": ranks}, z sharded."""
    root = H.tiny_root(tmp)
    bench = root / "benchmark"
    spec = H.spec(root)
    config = {
        "name": CONFIG, "dims": ["component", "z", "y", "x"],
        "shape": H.tiny_shape([2, 2048, 2048, 2048]), "dtype": "float32",
        "coords": {"component": {"start": 0.0, "num": 1, "den": 1},
                   "z": {"start": 0.0, "num": 1, "den": 2},
                   "y": {"start": 0.0, "num": 1, "den": 2},
                   "x": {"start": 0.0, "num": 1, "den": 4}},
        "field": {"variable": "velocity", "mean": 0.5, "std": 2.0}}
    (bench / "configs" / f"{CONFIG}.json").write_text(json.dumps(config))
    mix = {"entry": "sharded_power_spectrum", "input": "field",
           "fields_per_call": None, "mesh": {"fp": ranks},
           "dim_shards": {"z": "fp"},
           "kwargs": {"dim": ["z", "y", "x"], "window": "hann",
                      "detrend": "linear"}}
    (bench / "traffic" / f"psd3d-{ranks}.json").write_text(json.dumps(mix))
    (bench / "limits" / f"{cell_name(ranks)}.json").write_text(json.dumps(
        {"rel_err": {"limit": LIMIT, "control": "tf32"}}))
    spec["configs"].append({"name": CONFIG, "source": "test",
                            "file": f"benchmark/configs/{CONFIG}.json",
                            "reduced": [], "why": "test"})
    spec["workloads"].append({"name": cell_name(ranks), "config": CONFIG,
                              "traffic": f"psd3d-{ranks}", "chips": ranks,
                              "why": "test"})
    (root / "BENCHMARK.json").write_text(json.dumps(spec))
    return root


def run(root: Path, ranks: int, trace: int = 0, make_device: str = "Cpu",
        wrap: str | None = None, seed: int = 2147483659,
        seconds: float = 0.3, timeout_s: float = 20.0,
        script: str = "run") -> subprocess.CompletedProcess:
    """A whole run of the sharded cell of ``sharded_root`` on ``ranks``
    gloo ranks, through ``benchmark/<script>.py``'s ``main`` in a process
    of its own, ended with its ranks after TIME_LIMIT_S; ``make_device``
    and ``wrap`` name a device class and an entry wrapper of this module
    (``Cpu``: ``harness.device.Cpu``)."""
    if script == "run":
        argv = ["--workload", cell_name(ranks), "--seed", str(seed),
                "--seconds", str(seconds), "--trace", str(trace)]
    else:
        argv = ["--workload", cell_name(ranks), "--seeds", "1,2",
                "--control-seeds", "2"]
    code = f"""
import sys
from pathlib import Path
sys.path[:0] = [{str(H.BENCH)!r}, {str(HERE)!r}]
import {script} as entry, rank_cells
from harness import device, ranks
dev = {"device.Cpu" if make_device == "Cpu" else "rank_cells." + make_device}
wrap = {"None" if wrap is None else "rank_cells." + wrap}
sys.exit(entry.main({argv!r}, root=Path({str(root)!r}),
                    launch=ranks.Launch(make_device=dev, wrap=wrap,
                                        timeout_s={timeout_s!r})))
"""
    p = subprocess.Popen([sys.executable, "-c", code], cwd=root,
                         stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                         text=True, start_new_session=True)
    try:
        out, err = p.communicate(timeout=TIME_LIMIT_S)
    except subprocess.TimeoutExpired:
        os.killpg(p.pid, signal.SIGKILL)
        out, err = p.communicate()
        raise AssertionError(f"the run did not end within {TIME_LIMIT_S} "
                             f"s:\n{err[-4000:]}")
    return subprocess.CompletedProcess(p.args, p.returncode, out, err)


def last_line(p: subprocess.CompletedProcess) -> dict:
    return json.loads(p.stdout.strip().splitlines()[-1])


class PeakCpu(device.Cpu):
    """The CPU, reporting a peak that grows with the rank."""

    def peak_bytes(self):
        return (self.index + 1) * 2 ** 30


def alter_rank1(entry, rank):
    """Rank 1's block of each output scaled by 1 + 2^-10."""
    def call(*args, **kwargs):
        out = entry(*args, **kwargs)
        if rank == 1:
            out.data.to_local().mul_(1 + 2 ** -10)
        return out
    return call


def no_exchange(entry, rank):
    """The exchange between ranks left out: every all_to_all hands each
    rank its own send buffer back."""
    import torch.distributed as dist

    class Done:
        def wait(self, *args):
            return True

    def skip(output, input, *args, async_op=False, **kwargs):
        output.copy_(input)
        return Done() if async_op else None

    def call(*args, **kwargs):
        real = dist.all_to_all_single
        dist.all_to_all_single = skip
        try:
            return entry(*args, **kwargs)
        finally:
            dist.all_to_all_single = real
    return call


def raise_on_rank1(entry, rank):
    """Rank 1's fifth call raises, before the exchange its peers wait on."""
    calls = []

    def call(*args, **kwargs):
        calls.append(None)
        if rank == 1 and len(calls) == 5:
            raise RuntimeError("a fault planted in rank 1")
        return entry(*args, **kwargs)
    return call


def kill_rank1(entry, rank):
    """Rank 1 dies in its fifth call."""
    calls = []

    def call(*args, **kwargs):
        calls.append(None)
        if rank == 1 and len(calls) == 5:
            os.kill(os.getpid(), signal.SIGKILL)
        return entry(*args, **kwargs)
    return call


def global_input(root: Path, ranks: int, seed: int) -> list:
    """Each stack of the sharded cell's global input, put together from
    the blocks that ``ranks`` ranks make."""
    from harness import cells, inputs

    cell = cells.load(root, cell_name(ranks), bench=root / "benchmark")
    parts = [inputs.make_sharded(cell.config, cell.mix, seed,
                                 torch.device("cpu"), {"fp": ranks},
                                 {"fp": r}) for r in range(ranks)]
    return [torch.cat([p.stacks[s] for p in parts], dim=1)
            for s in range(2)]
