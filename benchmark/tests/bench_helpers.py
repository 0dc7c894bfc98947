"""Shared helpers of the benchmark's CPU tests: paths, and a tiny copy of the
benchmark (``BENCHMARK.json`` and the folder) whose configurations are cut
to a few small fields, so whole runs fit a CPU test.  The cut is worked out
from each configuration's own shape, so a configuration added by a new file
needs no entry here."""

from __future__ import annotations

import json
import math
import shutil
import sys
from pathlib import Path

BENCH = Path(__file__).resolve().parent.parent
ROOT = BENCH.parent
for p in (str(BENCH), str(ROOT)):
    if p not in sys.path:
        sys.path.insert(0, p)

TINY_LEADING = 4           # fields of a tiny stack
TINY_LEN = (32, 64)        # the range a trailing length is cut into
TINY_FIELDS = 2            # fields a call, for mixes that take blocks


def spec(root: Path = ROOT) -> dict:
    with open(root / "BENCHMARK.json") as f:
        return json.load(f)


def _factors(n: int) -> list:
    out, p = [], 2
    while p * p <= n:
        while n % p == 0:
            out.append(p)
            n //= p
        p += 1
    return out + ([n] if n > 1 else [])


def tiny_length(n: int) -> int:
    """A length in TINY_LEN of the parity of ``n`` that shares the most
    prime factors with it, and a factor above 7 where ``n`` has one: 4096
    gives 64, 4320 (2^5 3^3 5) 48, 2041 (13 x 157) 39.  Lengths within
    the range stay."""
    lo, hi = TINY_LEN
    if n <= hi:
        return n
    rough = max(_factors(n)) > 7

    def score(m):
        shared = _factors(math.gcd(m, n))
        return (len(shared), len(set(shared)),
                (max(_factors(m)) > 7) == rough, -m)

    return max((m for m in range(lo, hi + 1) if m % 2 == n % 2), key=score)


def tiny_shape(shape) -> list:
    return [min(shape[0], TINY_LEADING)] + [tiny_length(n)
                                            for n in shape[1:]]


def tiny_root(tmp: Path, src: Path = ROOT) -> Path:
    """A checkout-like root under ``tmp``: the benchmark's files of the
    checkout ``src`` as they are, with every configuration cut by
    ``tiny_shape`` and every mix that takes blocks of fields cut to
    TINY_FIELDS."""
    root = tmp / "root"
    shutil.copytree(src / BENCH.name, root / BENCH.name,
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(src / "BENCHMARK.json", root)
    for c in spec(src)["configs"]:
        path = root / c["file"]
        cfg = json.loads(path.read_text())
        cfg["shape"] = tiny_shape(cfg["shape"])
        path.write_text(json.dumps(cfg))
    for mix in (root / "benchmark" / "traffic").glob("*.json"):
        m = json.loads(mix.read_text())
        if m.get("fields_per_call"):
            m["fields_per_call"] = TINY_FIELDS
            mix.write_text(json.dumps(m))
    return root


def load_cell(root: Path, name: str):
    from harness import cells
    return cells.load(root, name, bench=root / "benchmark")
