"""Nothing the benchmark runs imports JAX or the JAX package, compared by
whole top-level module names (``xrft_tpu_torch`` is not ``xrft_tpu``), and
the plain references load nothing of the port."""

import json
import subprocess
import sys

import bench_helpers as H
from harness import runner

FORBIDDEN = {"jax", "jaxlib", "flax", "xrft_tpu"}


def _modules(code: str, tmp_path) -> set:
    p = subprocess.run([sys.executable, "-c", code], cwd=tmp_path,
                       capture_output=True, text=True, timeout=600,
                       env={"PATH": "/usr/bin:/bin", "HOME": str(tmp_path)})
    assert p.returncode == 0, p.stderr[-4000:]
    return set(json.loads(p.stdout.strip().splitlines()[-1]))


def test_a_whole_run_of_every_cell_loads_no_jax(tmp_path):
    root = H.tiny_root(tmp_path)
    code = f"""
import json, sys
sys.path[:0] = [{str(H.BENCH)!r}, {str(H.ROOT)!r}]
import run, control
from harness import device
for cell in {list(H.spec()['workloads'][i]['name'] for i in range(4))!r}:
    for trace in ("0", "1"):
        rc = run.main(["--workload", cell, "--seed", "3", "--seconds",
                       "0.02", "--trace", trace], root=__import__(
                       "pathlib").Path({str(root)!r}),
                      make_device=lambda chips: device.Cpu())
        assert rc == 0, (cell, trace, rc)
print(json.dumps(sorted({{m.split(".")[0] for m in sys.modules}})))
"""
    names = _modules(code, tmp_path)
    assert "xrft_tpu_torch" in names and "harness" in names
    assert not names & FORBIDDEN, names & FORBIDDEN


def test_the_references_load_nothing_of_the_port(tmp_path):
    code = f"""
import json, sys
import numpy as np, torch
sys.path[:0] = [{str(H.BENCH)!r}]
from reference import ifft, power_spectrum
x = torch.randn(2, 8, 12, dtype=torch.float64)
c = {{"time": np.arange(2.0), "y": np.arange(8.0), "x": np.arange(12.0)}}
power_spectrum.values(x, c, ("time", "y", "x"),
                      {{"dim": ["y", "x"], "window": "hann",
                        "detrend": "linear"}})
h = torch.fft.rfft2(x)
ifft.values(h, {{"time": c["time"], "freq_y": np.fft.fftfreq(8),
                 "freq_x": np.fft.rfftfreq(12)}}, ("time", "freq_y", "freq_x"),
            {{"dim": ["freq_y", "freq_x"], "real_dim": "freq_x",
              "shift": False, "lag": None, "true_phase": False,
              "true_amplitude": False}})
print(json.dumps(sorted({{m.split(".")[0] for m in sys.modules}})))
"""
    names = _modules(code, tmp_path)
    assert "reference" in names
    assert not names & (FORBIDDEN | {"xrft_tpu_torch", "harness"})


def test_the_check_compares_whole_top_level_names(monkeypatch):
    monkeypatch.setitem(sys.modules, "xrft_tpu_torch_fake.sub", object())
    assert runner.forbidden_modules() == sorted(
        n for n in FORBIDDEN if n in {m.split(".")[0] for m in sys.modules})
    monkeypatch.setitem(sys.modules, "xrft_tpu.transform", object())
    assert "xrft_tpu" in runner.forbidden_modules()
