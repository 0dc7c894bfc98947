"""Resolve a cell of ``BENCHMARK.json`` by name into everything a run needs:
its configuration (``configs``' file), its traffic mix
(``traffic/<traffic>.json``), its correctness limits (``limits/<cell>.json``)
and the metrics it reports, each read by ``metrics/<metric>.py``.  Every
part is a file of its own, found by name, so a cell, a configuration, a mix
or a metric is added by adding files and entries, never by an edit."""

from __future__ import annotations

import importlib
import importlib.util
import json
from dataclasses import dataclass, field
from pathlib import Path

HERE = Path(__file__).resolve().parent.parent      # the benchmark's folder


@dataclass
class Metric:
    name: str
    unit: str
    reader: object                # the module with read(reading)


@dataclass
class Cell:
    name: str
    chips: int
    config: dict
    mix: dict
    limits: dict
    end_to_end: list = field(default_factory=list)
    per_layer: list = field(default_factory=list)


def _json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def _applies(entry: dict, cell: str, reported: set) -> bool:
    """A metric with ``workloads`` belongs to those cells; one without to
    every cell (a per-layer one: every cell that reports what it moves)."""
    if "workloads" in entry:
        return cell in entry["workloads"]
    return entry.get("moves") is None or entry["moves"] in reported


def reader(bench: Path, name: str):
    """The module ``metrics/<name>.py``, loaded from its file."""
    path = bench / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"bench_metric_{name}",
                                                  path)
    if spec is None or not path.is_file():
        raise FileNotFoundError(f"no reader for metric {name!r} at {path}")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def entry_module(package: str, entry: str):
    """``reference.<entry>`` or ``work.<entry>``: one module per entry."""
    return importlib.import_module(f"{package}.{entry}")


def load(root: Path, name: str, bench: Path = HERE) -> Cell:
    """The cell ``name`` of ``root/BENCHMARK.json``; the files it names are
    read relative to ``root``, the mixes, limits and readers from
    ``bench``."""
    spec = _json(root / "BENCHMARK.json")
    cells = {w["name"]: w for w in spec["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json; "
                       f"known: {sorted(cells)}")
    w = cells[name]
    configs = {c["name"]: c for c in spec["configs"]}
    config = _json(root / configs[w["config"]]["file"])
    mix = _json(bench / "traffic" / f"{w['traffic']}.json")
    limits = _json(bench / "limits" / f"{name}.json")
    cell = Cell(name=name, chips=int(w["chips"]), config=config, mix=mix,
                limits=limits)
    e2e = [m for m in spec["end_to_end"] if _applies(m, name, set())]
    reported = {m["name"] for m in e2e}
    cell.end_to_end = [Metric(m["name"], m["unit"], reader(bench, m["name"]))
                       for m in e2e]
    cell.per_layer = [Metric(m["name"], m["unit"], reader(bench, m["name"]))
                      for m in spec["per_layer"]
                      if _applies(m, name, reported)]
    return cell
