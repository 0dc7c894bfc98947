"""Build the package's CUDA sources with nvcc and load them with ctypes.

Each ``csrc/<name>.cu`` exposes a plain C interface (no PyTorch headers),
so a build takes seconds.  It is compiled for Hopper (``sm_90a``) into
``xrft_tpu_torch/_build/<name>-<hash>.so`` at first use; the hash covers the
source, every shared header ``csrc/*.cuh`` and the compiler flags, so an
edited source or header is rebuilt and a stale library is never loaded.
Nothing here runs at import time.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

__all__ = ["load", "digest", "build_seconds"]

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC"]

_libs: dict[str, ctypes.CDLL] = {}
# one lock per source, so that different sources can build in parallel
_locks: dict[str, threading.Lock] = {}
_locks_lock = threading.Lock()
# seconds spent compiling in this process, by source name
build_seconds: dict[str, float] = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") \
        or "/usr/local/cuda"
    cand = Path(home) / "bin" / "nvcc"
    if cand.is_file():
        return str(cand)
    raise RuntimeError(
        "nvcc not found (searched PATH and CUDA_HOME/bin); the CUDA toolkit "
        "is required to build xrft_tpu_torch's kernels"
    )


def load(name: str) -> ctypes.CDLL:
    """The shared library built from ``csrc/<name>.cu`` (built on first
    use, cached per process).  Calls for different sources from several
    threads build in parallel."""
    with _locks_lock:
        lock = _locks.setdefault(name, threading.Lock())
    with lock:
        lib = _libs.get(name)
        if lib is None:
            lib = ctypes.CDLL(str(_build(name)))
            _libs[name] = lib
        return lib


def digest(name: str) -> str:
    """Hash of ``csrc/<name>.cu``, the headers ``csrc/*.cuh`` (names and
    bytes) and the nvcc flags: the build's cache key."""
    h = hashlib.sha256((CSRC / f"{name}.cu").read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        h.update(header.name.encode() + b"\0" + header.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return h.hexdigest()[:16]


def _build(name: str) -> Path:
    src = CSRC / f"{name}.cu"
    out = BUILD_DIR / f"{name}-{digest(name)}.so"
    if out.is_file():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(src)]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(
            f"nvcc failed on {src.name} (rc={proc.returncode}):\n"
            f"{' '.join(cmd)}\n{proc.stdout}{proc.stderr}"
        )
    build_seconds[name] = time.perf_counter() - t0
    os.replace(tmp, out)  # atomic: a concurrent loader sees all or nothing
    return out
