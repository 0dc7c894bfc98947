"""Cells, configurations, mixes, limits and metric readers are found by
name, and a new cell is added from new files alone."""

import hashlib
import json

import pytest

import bench_helpers as H
from harness import cells, device, runner

CELLS = ("mitgcm-4096.psd", "glorys12-daily.psd", "mitgcm-4096.irfft2",
         "mitgcm-4096.psd-hp")


@pytest.mark.parametrize("name", CELLS)
def test_cell_resolves_by_name(name):
    spec = H.spec()
    w = {w["name"]: w for w in spec["workloads"]}[name]
    cell = cells.load(H.ROOT, name)
    assert cell.chips == 1
    assert cell.config["name"] == w["config"]
    assert cell.mix["entry"] in ("power_spectrum", "ifft")
    assert cell.limits["rel_err"]["limit"] > 0
    assert [m.name for m in cell.end_to_end] == [
        "fields_per_s", "call_p95_ms", "peak_mem_gib", "setup_s"]
    per_layer = {m.name for m in cell.per_layer}
    assert {"host_call_ms", "device_idle_share", "call_roofline",
            "fft_roofline"} <= per_layer
    assert ("k1_roofline" in per_layer) == (name in (
        "mitgcm-4096.psd", "glorys12-daily.psd"))
    assert ("prologue_ms" in per_layer) == (name != "mitgcm-4096.irfft2")
    for m in cell.end_to_end + cell.per_layer:
        assert callable(m.reader.read)
    assert callable(cells.entry_module("reference", cell.mix["entry"]).values)
    assert callable(cells.entry_module("work", cell.mix["entry"]).layers)


def test_unknown_cell_raises():
    with pytest.raises(KeyError, match="no workload"):
        cells.load(H.ROOT, "nope.psd")


def test_every_configuration_and_metric_has_its_file():
    spec = H.spec()
    for c in spec["configs"]:
        cfg = json.loads((H.ROOT / c["file"]).read_text())
        assert cfg["name"] == c["name"]
        assert cfg["reduced"] == c["reduced"]
        assert len(cfg["shape"]) == len(cfg["dims"]) == 3
    for m in spec["end_to_end"] + spec["per_layer"]:
        assert (H.BENCH / "metrics" / f"{m['name']}.py").is_file()
    for w in spec["workloads"]:
        assert (H.BENCH / "traffic" / f"{w['traffic']}.json").is_file()
        assert (H.BENCH / "limits" / f"{w['name']}.json").is_file()


def _digests(root):
    return {p.relative_to(root): hashlib.sha256(p.read_bytes()).hexdigest()
            for p in root.rglob("*") if p.is_file()
            and "__pycache__" not in p.parts}


def test_a_throwaway_cell_needs_only_new_files(tmp_path):
    """A configuration, a mix, a limits file and a per-layer metric, each a
    new file, and new entries in BENCHMARK.json: the cell runs and reports
    the new metric, and no file that was there changed."""
    root = H.tiny_root(tmp_path)
    before = _digests(root / "benchmark")
    b = root / "benchmark"
    cfg = json.loads((b / "configs" / "mitgcm-4096.json").read_text())
    cfg.update(name="throwaway-grid", shape=[2, 24, 40])
    (b / "configs" / "throwaway-grid.json").write_text(json.dumps(cfg))
    (b / "traffic" / "psd-one.json").write_text(json.dumps({
        "entry": "power_spectrum", "input": "field", "fields_per_call": 1,
        "kwargs": {"dim": "{space}", "window": "hann",
                   "detrend": "linear"}}))
    (b / "limits" / "throwaway-grid.psd-one.json").write_text(json.dumps(
        {"rel_err": {"limit": 1e-5, "control": "tf32"}}))
    (b / "metrics" / "calls_made.py").write_text(
        "def read(r):\n    return float(len(r.window.calls))\n")
    spec = json.loads((root / "BENCHMARK.json").read_text())
    spec["configs"].append({"name": "throwaway-grid", "source": "test",
                            "file": "benchmark/configs/throwaway-grid.json",
                            "reduced": [], "why": "test"})
    spec["workloads"].append({"name": "throwaway-grid.psd-one",
                              "config": "throwaway-grid",
                              "traffic": "psd-one", "chips": 1,
                              "why": "test"})
    spec["end_to_end"].append({"name": "calls_made", "unit": "calls",
                               "better": "higher", "bound": 0.25,
                               "source": "host_clock",
                               "workloads": ["throwaway-grid.psd-one"]})
    (root / "BENCHMARK.json").write_text(json.dumps(spec))

    cell = cells.load(root, "throwaway-grid.psd-one", bench=b)
    import xrft_tpu_torch as xt
    result, checks = runner.run(cell, 12345, 0.05, False, device.Cpu(),
                                0.0, xt)
    assert result["correct"], checks
    assert result["metrics"]["calls_made"]["value"] >= 1
    assert "calls_made" not in [m.name for m in cells.load(
        root, "mitgcm-4096.psd", bench=b).end_to_end]
    after = _digests(b)
    assert {k: v for k, v in after.items() if k in before} == before


def test_a_new_configuration_needs_no_edit_of_the_test_helpers(tmp_path):
    """A configuration that a later change adds by a new file is cut to a
    test size from its own shape: the tiny copy of the checkout holds it,
    and a cell on it runs correct."""
    import shutil

    src = tmp_path / "src"
    shutil.copytree(H.BENCH, src / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    b = src / "benchmark"
    cfg = json.loads((b / "configs" / "glorys12-daily.json").read_text())
    cfg.update(name="new-grid", shape=[64, 1000, 3000])
    (b / "configs" / "new-grid.json").write_text(json.dumps(cfg))
    shutil.copy(b / "limits" / "glorys12-daily.psd.json",
                b / "limits" / "new-grid.psd.json")
    spec = H.spec()
    spec["configs"].append({"name": "new-grid", "source": "test",
                            "file": "benchmark/configs/new-grid.json",
                            "reduced": [], "why": "test"})
    spec["workloads"].append({"name": "new-grid.psd", "config": "new-grid",
                              "traffic": "psd", "chips": 1, "why": "test"})
    (src / "BENCHMARK.json").write_text(json.dumps(spec))

    root = H.tiny_root(tmp_path / "tiny", src)
    cell = H.load_cell(root, "new-grid.psd")
    assert cell.config["shape"] == [4, 40, 60]
    assert H.tiny_shape([64, 1000, 3000]) == [4, 40, 60]
    import xrft_tpu_torch as xt
    result, checks = runner.run(cell, 2 ** 31 + 5, 0.05, False,
                                device.Cpu(), 0.0, xt)
    assert result["correct"], checks
