"""The benchmark of xrft_tpu_torch on one NVIDIA H100.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Runs the cell of ``BENCHMARK.json`` named ``--workload`` from the root of a
checkout and prints, as the last line of standard output, one JSON object:
``correct``, ``attempted``, ``failed``, ``metrics`` (the cell's end-to-end
metrics with ``--trace 0``, its per-layer metrics with ``--trace 1``),
``device``, with ``--trace 1`` ``breakdown``, and last ``checks``: each
number compared with the plain reference beside its limit, also printed as
the last lines of standard error.  It exits with another code than 0 and
prints no result when no CUDA device (or fewer than the cell asks for) is
visible, when the checkout holds no ``xrft_tpu_torch``, and when JAX or the
JAX package was loaded.
"""

import sys
import time

T0 = time.perf_counter()

from pathlib import Path  # noqa: E402

BENCH = Path(__file__).resolve().parent
ROOT = BENCH.parent
# caches at fixed paths inside the checkout, so only the checkout's first run
# compiles (the port builds its nvcc libraries into xrft_tpu_torch/_build/)
CACHE = ROOT / ".bench_cache"

import argparse  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402


def parse(argv):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def main(argv=None, root: Path = ROOT, make_device=None, launch=None) -> int:
    """Run one cell; ``root``, ``make_device`` (chips -> device) and
    ``launch`` (``harness.ranks.Launch``, for a cell whose mix names a
    mesh) are for the harness's tests, which run tiny cells on the CPU."""
    args = parse(argv)
    os.environ["TRITON_CACHE_DIR"] = str(CACHE / "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = str(CACHE / "torch_extensions")
    if str(BENCH) not in sys.path:
        sys.path.insert(0, str(BENCH))
    from harness import cells, device, runner
    marks = [("python, torch and the harness", time.perf_counter())]

    cell = cells.load(root, args.workload, bench=root / BENCH.name)
    if "mesh" in cell.mix:
        return _ranks(cell, args, root, launch, marks)
    try:
        xt = runner.load_port(ROOT)
    except runner.PortMissing as e:
        runner.log(str(e))
        return 3
    marks.append(("xrft_tpu_torch", time.perf_counter()))
    try:
        dev = (make_device or device.Cuda)(cell.chips)
    except device.NoCard as e:
        runner.log(str(e))
        return 2
    marks.append(("device context", time.perf_counter()))
    result, checks = runner.run(cell, args.seed, args.seconds,
                                bool(args.trace), dev, T0, xt, marks)
    found = runner.forbidden_modules()
    if found:
        runner.log(f"the run loaded {found}: nothing it runs may import JAX "
                   f"or the JAX package")
        return 4
    _report(result, checks, runner.log)
    return 0


def _report(result: dict, checks: dict, log) -> None:
    """The result line, its checks last, and the checks as the last lines
    of standard error."""
    result["checks"] = checks
    print(json.dumps(result), flush=True)
    for name, c in checks.items():
        log(f"check {name} = {c['value']!r} (limit {c['limit']!r})")


def _ranks(cell, args, root: Path, launch, marks) -> int:
    """A cell whose mix names a mesh: one rank per card (``harness/ranks``),
    rank 0's result printed here once every rank has exited 0."""
    from harness import device, ranks, runner

    opts = launch or ranks.Launch()
    world = math.prod(cell.mix["mesh"].values())
    if world != cell.chips:
        runner.log(f"the mesh {cell.mix['mesh']} has {world} ranks; the "
                   f"cell asks for {cell.chips} chips")
        return 2
    try:
        rc, out = ranks.launch(
            runner.run_rank, (ROOT, root, cell.name, args.seed,
                              args.seconds, bool(args.trace), T0, marks,
                              opts.wrap), world, opts, runner.log)
    except device.NoCard as e:
        runner.log(str(e))
        return 2
    if rc:
        return rc
    found = runner.forbidden_modules()
    if found:
        runner.log(f"the launcher loaded {found}: nothing it runs may "
                   f"import JAX or the JAX package")
        return 4
    _report(*out, runner.log)
    return 0


if __name__ == "__main__":
    # Python's bytecode too: an environment may forbid writing it next to
    # the sources, and then every run compiles torch's Python anew (about 6
    # of its 8 s import on the card's machine)
    sys.pycache_prefix = str(CACHE / "pycache")
    sys.dont_write_bytecode = False
    sys.exit(main())
