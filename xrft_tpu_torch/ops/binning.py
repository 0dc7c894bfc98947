"""Binned sums over static frequency grids, and K3 (``csrc/binned_sum.cu``).

Counterpart of ``xrft_tpu/ops/binning.py``.  The bin of each point depends
only on the static frequency grid, so it is computed once on the host:
:func:`cut_codes` reproduces ``pd.cut``'s equal-width, right-closed codes in
numpy alone (code -1: out of range or NaN), and a :class:`BinPlan` holds the
codes with K3's tile plan, the plain route's sorted plan and their device
copies.

:func:`binned_sum` launches kernel K3 for a CUDA tensor and runs
:func:`binned_sum_plain`, the JAX package's non-TPU route in torch, for a CPU
tensor; any other device raises.  The plain version takes the one-hot matmul
for small grids and the sorted gather with a blocked prefix difference for
large ones; it uses no ``index_add_``/``scatter_add_``, so it repeats bit
for bit on the card as well.

K3 streams the data in natural order, as the TPU kernel did: the points are
cut into tiles of ``TILE`` consecutive points, and each tile's plan is the
stable sort of its codes as 16-bit offsets into the tile (dropped points
left out), cut into runs of one bin.  Pass 1 sums each run out of the tile
in shared memory into its partial slot; pass 2 adds each bin's slots, which
lie side by side in tile order (:meth:`BinPlan.host`).
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from ..config import full_fp32

__all__ = ["BinPlan", "binned_mean_np", "binned_sum", "binned_sum_plain",
           "cut_codes"]

# above this many one-hot entries (points * bins) the plain version takes the
# sorted route, as ``xrft_tpu/ops/binning.py:63`` does
ONEHOT_MAX_ELEMENTS = 64 * 1024 * 1024
# consecutive points of one K3 tile: a power of two, at most 65536 so that
# an offset into the tile fits 16 bits; one component of a tile (64 KB of
# float32, 128 KB of float64) fills a block's shared memory
# (``csrc/binned_sum.cu`` has the arithmetic)
TILE = 16384
# the most points of one K3 run (one thread's serial sum); a bin's stretch
# of a tile that is longer is cut into several runs
RUN_MAX = 128
# pass-1 blocks K3 aims to launch: the rows are cut into groups, a block to
# each (tile, group), so that there are about this many; a block reads its
# tile's offsets once for its whole group (``csrc/binned_sum.cu``)
TARGET_BLOCKS = 1024
_ENTRY = {torch.float32: "binned_sum_f32", torch.float64: "binned_sum_f64"}


def _codes_dtype(nbins: int):
    """The smallest int dtype pandas gives categorical codes of nbins
    categories (``pandas.core.dtypes.cast.coerce_indexer_dtype``)."""
    for dt in (np.int8, np.int16, np.int32):
        if nbins < np.iinfo(dt).max:
            return dt
    return np.int64


def cut_codes(values: np.ndarray, nbins: int):
    """``pd.cut(np.ravel(values), nbins)`` codes, equal-width and
    right-closed, in numpy alone: (codes, nbins), with code -1 for NaN and
    out-of-range points (``xrft_tpu/ops/binning.py:30-36``)."""
    v = np.ravel(values)
    if nbins < 1:
        raise ValueError("`bins` should be a positive integer.")
    if v.size == 0:
        raise ValueError("Cannot cut empty array")
    mn, mx = np.nanmin(v), np.nanmax(v)
    if np.isinf(mn) or np.isinf(mx):
        raise ValueError(
            "cannot specify integer `bins` when input data contains infinity")
    if mn == mx:
        mn -= 0.001 * abs(mn) if mn != 0 else 0.001
        mx += 0.001 * abs(mx) if mx != 0 else 0.001
        bins = np.linspace(mn, mx, nbins + 1, endpoint=True)
    else:
        bins = np.linspace(mn, mx, nbins + 1, endpoint=True)
        bins[0] -= (mx - mn) * 0.001
    ids = np.searchsorted(bins, v, side="left")
    codes = ids.astype(_codes_dtype(nbins)) - 1
    codes[np.isnan(v) | (ids == nbins + 1)] = -1
    return codes, nbins


def binned_mean_np(values: np.ndarray, codes: np.ndarray,
                   nbins: int) -> np.ndarray:
    """Host per-bin mean (for static quantities like the radial
    coordinate); empty bins give 0 (``xrft_tpu/ops/binning.py:39-49``)."""
    flat = np.ravel(values)
    mask = codes >= 0
    sums = np.bincount(codes[mask], weights=flat[mask], minlength=nbins)
    counts = np.bincount(codes[mask], minlength=nbins)
    out = np.zeros(nbins, dtype=np.float64)
    nz = counts > 0
    out[nz] = sums[nz] / counts[nz]
    return out


def _onehot(codes: np.ndarray, nbins: int, rdtype) -> np.ndarray:
    oh = np.zeros((codes.size, nbins), dtype=rdtype)
    mask = codes >= 0
    oh[np.nonzero(mask)[0], codes[mask]] = 1.0
    return oh


def _sorted_plan(codes: np.ndarray, nbins: int):
    """A stable argsort placing same-bin points contiguously (dropped, code
    -1, points first) and the per-bin segment boundaries
    (``xrft_tpu/ops/binning.py:66-74``)."""
    order = np.argsort(codes, kind="stable")
    sorted_codes = codes[order]
    starts = np.searchsorted(sorted_codes, np.arange(nbins), side="left")
    ends = np.searchsorted(sorted_codes, np.arange(nbins), side="right")
    return order, starts, ends


def _tile_plan(codes: np.ndarray, nbins: int, tile: int) -> dict:
    """K3's plan: each tile's kept points in the stable order of their
    codes (a radix argsort of the tile's pandas-width codes, which stays in
    cache); the runs of one bin in that order, cut at ``RUN_MAX`` points;
    each run's partial slot, bin-major and in tile order within a bin, so
    that a bin's slots are ``bin_off[b]:bin_off[b+1]``."""
    if not 1 <= tile <= 65536:
        raise ValueError(f"K3's tile of {tile} points does not fit 16 bits")
    ntiles = -(-codes.size // tile)
    local, starts, bins, nruns = [], [], [], np.zeros(ntiles, np.int64)
    pos = 0
    for t in range(ntiles):
        seg = codes[t * tile:(t + 1) * tile]
        o = np.argsort(seg, kind="stable")
        s = seg[o]
        first = int(np.searchsorted(s, 0))      # code -1 sorts first
        if first == s.size:
            continue
        o, s = o[first:], s[first:]
        head = np.flatnonzero(np.concatenate([[True], s[1:] != s[:-1]]))
        local.append(o.astype(np.uint16))
        starts.append(head + pos)
        bins.append(s[head])
        nruns[t] = head.size
        pos += s.size
    if not starts:
        starts, bins, local = [[np.zeros(0, np.int64)]] * 3
    start, run_bin = np.concatenate(starts), np.concatenate(bins)
    run_tile = np.repeat(np.arange(ntiles), nruns)
    # cut runs longer than RUN_MAX into pieces of RUN_MAX
    pieces = -(-np.diff(np.append(start, pos)) // RUN_MAX)
    within = np.arange(pieces.sum()) - np.repeat(np.cumsum(pieces) - pieces,
                                                 pieces)
    start = np.repeat(start, pieces) + within * RUN_MAX
    run_bin, run_tile = np.repeat(run_bin, pieces), np.repeat(run_tile, pieces)
    by_bin = np.argsort(run_bin, kind="stable")
    run_slot = np.empty(run_bin.size, np.int64)
    run_slot[by_bin] = np.arange(run_bin.size)
    i32 = np.int32
    return {"local": np.concatenate(local).astype(np.uint16),
            "run_start": np.append(start, pos).astype(i32),
            "run_slot": run_slot.astype(i32),
            "tile_run": np.searchsorted(run_tile,
                                        np.arange(ntiles + 1)).astype(i32),
            "bin_off": np.searchsorted(run_bin[by_bin],
                                       np.arange(nbins + 1)).astype(i32),
            "tile": tile}


class BinPlan:
    """The static binning of ``size`` points into ``nbins`` bins: the codes,
    K3's tile plan and the plain route's sorted plan (host, each built at
    first use), and the copies of those on each device they were used on."""

    def __init__(self, codes: np.ndarray, nbins: int):
        self.codes = np.ravel(codes)
        self.nbins = int(nbins)
        if self.codes.size >= 2 ** 31:
            raise ValueError(f"{self.codes.size} points exceed int32 indices")
        self._host = {}
        self._dev = {}

    @property
    def size(self) -> int:
        return self.codes.size

    def restrict(self, grid, ranges) -> "BinPlan":
        """The plan of the block ``[lo, hi)`` per axis (``ranges``) of the
        points read as a C-order array of shape ``grid``: itself when the
        block is the whole grid, else a plan of the block's codes, built
        once and kept."""
        grid, ranges = tuple(grid), tuple(ranges)
        if ranges == tuple((0, n) for n in grid):
            return self
        key = ("sub", grid, ranges)
        if key not in self._host:
            block = self.codes.reshape(grid)[
                tuple(slice(lo, hi) for lo, hi in ranges)]
            self._host[key] = BinPlan(np.ascontiguousarray(block), self.nbins)
        return self._host[key]

    def host(self) -> dict:
        """K3's tile plan of ``TILE`` points a tile: local (uint16 offsets
        into their tile, the kept points in (tile, code) order), run_start
        (int32, each run's first entry of local, and the end), run_slot
        (int32), tile_run (int32, each tile's first run, and the end),
        bin_off (int32, each bin's first slot, and the end), tile."""
        if "tiles" not in self._host:
            self._host["tiles"] = _tile_plan(self.codes, self.nbins, TILE)
        return self._host["tiles"]

    def sorted_host(self) -> dict:
        """The plain route's plan: order (int32, the stable argsort of the
        codes), starts/ends (int64, each bin's segment of it)."""
        if "sorted" not in self._host:
            order, starts, ends = _sorted_plan(self.codes, self.nbins)
            self._host["sorted"] = {"order": order.astype(np.int32),
                                    "starts": starts, "ends": ends}
        return self._host["sorted"]

    def on(self, device, part: str = "tiles") -> dict:
        """The host plan ``part`` ("tiles": :meth:`host`, "sorted":
        :meth:`sorted_host`) as tensors on ``device``, copied there once."""
        device = torch.device(device)
        if device.type == "cuda" and device.index is None:
            device = torch.device("cuda", torch.cuda.current_device())
        got = self._dev.get((device, part))
        if got is None:
            host = self.host() if part == "tiles" else self.sorted_host()
            got = {k: torch.as_tensor(v, device=device)
                   for k, v in host.items() if isinstance(v, np.ndarray)}
            self._dev[device, part] = got
        return got


def _check(x: torch.Tensor, plan: BinPlan, what: str):
    if x.dtype not in (torch.float32, torch.float64, torch.complex64,
                       torch.complex128):
        raise ValueError(f"{what} takes float32/float64/complex64/complex128,"
                         f" got {x.dtype}")
    if x.ndim < 1 or x.shape[-1] != plan.size:
        raise ValueError(f"{what}: trailing axis of {tuple(x.shape)} is not "
                         f"the plan's {plan.size} points")


def _plain_real(x: torch.Tensor, plan: BinPlan) -> torch.Tensor:
    """Per-bin sums of a real ``(..., P)`` tensor by the JAX package's
    non-TPU route (``xrft_tpu/ops/binning.py:170-202``)."""
    nbins, dev = plan.nbins, x.device
    if plan.size * nbins <= ONEHOT_MAX_ELEMENTS:
        rdtype = np.float64 if x.dtype == torch.float64 else np.float32
        with full_fp32():
            return x @ torch.as_tensor(_onehot(plan.codes, nbins, rdtype),
                                       device=dev)
    t = plan.on(dev, "sorted")
    # pairwise-accuracy prefix: blocked two-level cumsum.  The JAX package
    # runs it in float32 for every dtype; here float64 data stay float64
    # (ROADMAP.md, Queue 3)
    blk = 1024
    xs = x.index_select(-1, t["order"])
    pad = (-plan.size) % blk
    if pad:
        xs = torch.nn.functional.pad(xs, (0, pad))
    within = torch.cumsum(xs.reshape(xs.shape[:-1] + (-1, blk)), dim=-1)
    block_tot = within[..., -1]
    block_off = torch.cumsum(block_tot, dim=-1) - block_tot
    prefix = (within + block_off[..., None]).reshape(xs.shape)
    # csum0[i] = sum of sorted[:i]; bin b = csum0[end] - csum0[start]
    csum0 = torch.cat([prefix.new_zeros(prefix.shape[:-1] + (1,)), prefix],
                      dim=-1)
    return (csum0.index_select(-1, t["ends"])
            - csum0.index_select(-1, t["starts"]))


def binned_sum_plain(x: torch.Tensor, plan: BinPlan) -> torch.Tensor:
    """Plain torch version of K3 (the CPU route and the oracle on the card):
    ``(..., P) -> (..., nbins)`` per-bin sums, code -1 dropped, complex data
    reduced per component."""
    _check(x, plan, "binned_sum_plain")
    if x.is_complex():
        return torch.complex(_plain_real(x.real, plan),
                             _plain_real(x.imag, plan))
    return _plain_real(x, plan)


def binned_sum(x: torch.Tensor, plan: BinPlan) -> torch.Tensor:
    """Per-bin sums over the trailing axis, ``(..., P) -> (..., nbins)``:
    ``out[..., b] = sum of x[..., p] over the points p with code b``.
    float32 and complex64 accumulate in float32, float64 and complex128 in
    float64; complex data reduce both components in one launch."""
    _check(x, plan, "binned_sum")
    if x.device.type == "cpu":
        return binned_sum_plain(x, plan)
    if x.device.type != "cuda":
        raise ValueError(f"binned_sum runs on cuda or cpu tensors, not "
                         f"{x.device.type}")
    if not x.is_contiguous():
        raise ValueError("binned_sum needs a contiguous input")
    xr = torch.view_as_real(x.resolve_conj()) if x.is_complex() else x
    comps = 2 if x.is_complex() else 1
    rows = x.numel() // plan.size if plan.size else 0
    out = torch.empty(x.shape[:-1] + (plan.nbins,), dtype=x.dtype,
                      device=x.device)
    if out.numel() == 0:
        return out
    h = plan.host()
    ntiles = h["tile_run"].size - 1
    # rows a pass-1 block sums, reusing its tile's offsets: as many as keep
    # about TARGET_BLOCKS blocks
    group = min(rows, max(1, rows * ntiles // TARGET_BLOCKS))
    if ntiles >= 2 ** 31 or -(-rows // group) > 65535:
        raise ValueError(f"{rows} rows of {ntiles} tiles exceed the kernel's "
                         f"grid")
    from ._build import load

    with torch.cuda.device(x.device):
        t = plan.on(x.device)
        nslots = t["run_slot"].numel()
        partial = torch.empty((rows, max(nslots, 1), comps), dtype=xr.dtype,
                              device=x.device)
        fn = getattr(load("binned_sum"), _ENTRY[xr.dtype])
        fn.argtypes = [ctypes.c_void_p, ctypes.c_int] + \
            [ctypes.c_void_p] * 7 + [ctypes.c_longlong] * 2 + \
            [ctypes.c_int] * 5 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        err = fn(xr.data_ptr(), comps, t["local"].data_ptr(),
                 t["run_start"].data_ptr(), t["run_slot"].data_ptr(),
                 t["tile_run"].data_ptr(), t["bin_off"].data_ptr(),
                 partial.data_ptr(), out.data_ptr(), rows, plan.size,
                 ntiles, nslots, plan.nbins, h["tile"], group,
                 torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"binned_sum kernel launch failed: CUDA error {err}")
    binned_sum.launches += 1
    return out


binned_sum.launches = 0
