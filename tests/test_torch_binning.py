"""The port's binning layer against pandas and xrft_tpu on the CPU.

``cut_codes`` must give ``pd.cut``'s codes bit for bit (the port may not
import pandas).  ``binned_sum_plain`` (the CPU route of kernel K3) is held
against ``xrft_tpu.ops.binning.binned_sum`` on its three routes: the one-hot
matmul, the sorted prefix difference and the Pallas kernel in interpret mode.
Tolerances: 1e-12 in float64; rtol 2e-6 / atol 1e-4 in float32, as
``tests/test_isotropic.py`` holds the JAX routes to each other.  K3's own
work split (the tile plan) is replayed in numpy against a float64 oracle.
"""

import numpy as np
import numpy.testing as npt
import pandas as pd
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp

from xrft_tpu.config import config as ref_config
from xrft_tpu.ops import binning as ref_binning
from xrft_tpu_torch.ops import binning

F32 = dict(rtol=2e-6, atol=1e-4)


def _radial(shape, dx=1.0, shift=True):
    ks = [np.fft.fftfreq(n, dx) for n in shape]
    if shift:
        ks = [np.fft.fftshift(k) for k in ks]
    grids = np.meshgrid(*ks, indexing="ij", sparse=True)
    return np.sqrt(sum(g**2 for g in grids))


@pytest.mark.parametrize("shape,dx,shift", [
    ((96, 96), 1.0, True), ((97, 97), 1.0, True), ((64, 64), 0.5, False),
    ((257, 257), 0.3, False), ((45, 32), 2.0, True), ((12, 13, 14), 1.0, True),
    ((16, 16, 16), 0.7, False),
])
def test_cut_codes_match_pandas_on_radial_grids(shape, dx, shift):
    fr = _radial(shape, dx, shift)
    nbins = min(shape) // 4
    codes, n = binning.cut_codes(fr, nbins)
    ref = pd.cut(fr.ravel(), nbins)
    assert n == ref.categories.size
    assert codes.dtype == np.asarray(ref.codes).dtype
    npt.assert_array_equal(codes, np.asarray(ref.codes))


@pytest.mark.parametrize("values,nbins", [
    (np.linspace(0.0, 1.0, 11), 10),                 # every value on an edge
    (np.arange(20.0) - 7.0, 5),
    (np.array([np.nan, 1.0, 1.0, 1.0]), 3),          # NaN and constant
    (np.zeros(5), 4),                                # constant zero
    (np.array([2.5, np.nan, -1.0, 7.25, np.nan, 2.5]), 200),
    (np.random.RandomState(0).randn(3000), 130),     # int16 codes
])
def test_cut_codes_edges_nan_constant(values, nbins):
    codes, n = binning.cut_codes(values, nbins)
    ref = pd.cut(values, nbins)
    assert n == ref.categories.size
    assert codes.dtype == np.asarray(ref.codes).dtype
    npt.assert_array_equal(codes, np.asarray(ref.codes))


def test_cut_codes_errors_match_pandas():
    for values, nbins in ((np.arange(4.0), 0), (np.zeros(0), 3),
                          (np.array([0.0, np.inf]), 3)):
        with pytest.raises(ValueError) as ref:
            pd.cut(values, nbins)
        with pytest.raises(ValueError, match=str(ref.value)):
            binning.cut_codes(values, nbins)


def test_binned_mean_np_matches_reference():
    fr = _radial((40, 34))
    codes, n = binning.cut_codes(fr, 8)
    npt.assert_array_equal(binning.binned_mean_np(fr, codes, n),
                           ref_binning.binned_mean_np(fr, codes, n))


def _case(P=3001, nbins=37, batch=(2, 3), dtype=np.float64, seed=1):
    """Codes with -1 and an empty bin, unaligned P and nbins, batch dims."""
    rng = np.random.RandomState(seed)
    codes = rng.randint(-1, nbins, P)
    codes[codes == 5] = 6                          # bin 5 stays empty
    x = rng.randn(*batch, P)
    if np.dtype(dtype).kind == "c":
        x = x + 1j * rng.randn(*batch, P)
    return codes, nbins, x.astype(dtype)


def _oracle(x, codes, nbins):
    """float64 per-bin sums by np.bincount, per component."""
    if np.iscomplexobj(x):
        return _oracle(x.real, codes, nbins) + 1j * _oracle(x.imag, codes,
                                                            nbins)
    keep = codes >= 0
    flat = x.reshape(-1, x.shape[-1]).astype(np.float64)
    out = np.stack([np.bincount(codes[keep], weights=row[keep],
                                minlength=nbins) for row in flat])
    return out.reshape(x.shape[:-1] + (nbins,))


def _ref_route(x, codes, nbins, route, monkeypatch):
    """xrft_tpu's binned_sum on one of its three routes."""
    if route == "pallas_interpret":
        monkeypatch.setattr(ref_config, "binned_sum_impl", "pallas_interpret")
    elif route == "sorted":
        monkeypatch.setattr(ref_binning, "ONEHOT_MAX_ELEMENTS", 1)
    out = ref_binning.binned_sum(jnp.asarray(x), codes, nbins)
    monkeypatch.undo()
    return np.asarray(out)


def _assert_close(got, ref, dtype):
    if np.dtype(dtype) in (np.float64, np.complex128):
        npt.assert_allclose(got, ref, rtol=0, atol=1e-12 * np.abs(ref).max())
    else:
        npt.assert_allclose(got, ref, **F32)


@pytest.mark.parametrize("dtype", [np.float32, np.float64, np.complex64,
                                   np.complex128])
@pytest.mark.parametrize("route", ["onehot", "sorted", "pallas_interpret"])
def test_binned_sum_plain_matches_reference_routes(route, dtype, monkeypatch):
    codes, nbins, x = _case(dtype=dtype)
    plan = binning.BinPlan(codes, nbins)
    if route == "sorted":
        monkeypatch.setattr(binning, "ONEHOT_MAX_ELEMENTS", 1)
    got = binning.binned_sum(torch.as_tensor(x), plan)
    monkeypatch.undo()
    assert got.dtype == torch.as_tensor(x).dtype
    assert tuple(got.shape) == x.shape[:-1] + (nbins,)
    got = got.numpy()
    # the JAX sorted route runs its prefix in float32 for every dtype; the
    # port keeps float64 data in float64, so float64 is held against the
    # float64 oracle there (ROADMAP.md, Queue 3)
    wide = np.dtype(dtype) in (np.float64, np.complex128)
    ref = _oracle(x, codes, nbins) if route == "sorted" and wide else \
        _ref_route(x, codes, nbins, route, monkeypatch)
    _assert_close(got, ref, dtype)
    assert np.all(got[..., 5] == 0)


def test_reference_sorted_route_is_float32_grade_in_float64(monkeypatch):
    """The divergence above, pinned: xrft_tpu's sorted route loses float64
    precision; the port's agrees with the float64 oracle to 1e-12."""
    codes, nbins, x = _case(P=20000, nbins=50, batch=(2,))
    ref = _oracle(x, codes, nbins)
    jax_err = np.abs(_ref_route(x, codes, nbins, "sorted", monkeypatch)
                     - ref).max() / np.abs(ref).max()
    monkeypatch.setattr(binning, "ONEHOT_MAX_ELEMENTS", 1)
    got = binning.binned_sum(torch.as_tensor(x),
                             binning.BinPlan(codes, nbins)).numpy()
    assert jax_err > 1e-9
    assert np.abs(got - ref).max() <= 1e-12 * np.abs(ref).max()


def _replay_k3(x, plan):
    """K3's two passes (csrc/binned_sum.cu) in numpy float64 over the tile
    plan: pass 1 sums each run of each tile out of the tile's natural-order
    copy into its slot, pass 2 adds each bin's slots in order.  Also counts
    the reads of every point."""
    h = plan.host()
    tile, local, start = h["tile"], h["local"], h["run_start"]
    rows = x.reshape(-1, plan.size).astype(np.float64)
    nslots = h["run_slot"].size
    partial = np.full((rows.shape[0], nslots), np.nan)
    reads = np.zeros(plan.size, np.int64)
    for t in range(h["tile_run"].size - 1):
        seg = rows[:, t * tile:(t + 1) * tile]          # the copied tile
        for k in range(h["tile_run"][t], h["tile_run"][t + 1]):
            offs = local[start[k]:start[k + 1]].astype(np.int64)
            reads[t * tile + offs] += 1
            partial[:, h["run_slot"][k]] = seg[:, offs].sum(axis=-1)
    off = h["bin_off"]
    out = np.stack([partial[:, off[b]:off[b + 1]].sum(axis=-1)
                    for b in range(plan.nbins)], axis=-1)
    return out.reshape(x.shape[:-1] + (plan.nbins,)), reads


@pytest.mark.parametrize("run_max", [5, 128])
@pytest.mark.parametrize("tile", [1, 7, 64, 4096])
def test_k3_tile_plan_replay_reads_every_point_once(tile, run_max,
                                                    monkeypatch):
    monkeypatch.setattr(binning, "TILE", tile)
    monkeypatch.setattr(binning, "RUN_MAX", run_max)
    codes, nbins, x = _case(P=2500, nbins=23, batch=(3,))
    plan = binning.BinPlan(codes, nbins)
    h = plan.host()
    assert h["tile"] == tile and h["tile_run"].size == -(-2500 // tile) + 1
    got, reads = _replay_k3(x, plan)
    npt.assert_array_equal(reads, (codes >= 0).astype(np.int64))
    runs = np.diff(h["run_start"])
    assert runs.min() >= 1 and runs.max() <= run_max     # no empty run
    ref = _oracle(x, codes, nbins)
    npt.assert_allclose(got, ref, rtol=0, atol=1e-12 * np.abs(ref).max())
    assert np.all(got[..., 5] == 0)                      # the empty bin


def test_k3_tile_plan_with_every_point_dropped():
    plan = binning.BinPlan(np.full(10, -1), 4)
    h = plan.host()
    assert h["local"].size == 0 and h["run_start"].tolist() == [0]
    assert h["tile_run"].tolist() == [0, 0]
    assert h["bin_off"].tolist() == [0, 0, 0, 0, 0]
    x = np.ones((2, 10))
    got, reads = _replay_k3(x, plan)
    npt.assert_array_equal(got, np.zeros((2, 4)))
    assert not reads.any()
    npt.assert_array_equal(binning.binned_sum(torch.ones(2, 10), plan),
                           np.zeros((2, 4)))


def test_k3_tile_plan_with_a_tile_all_dropped(monkeypatch):
    monkeypatch.setattr(binning, "TILE", 8)
    codes = np.arange(40) % 5
    codes[8:16] = -1                                     # tile 1
    codes[35:] = -1                                      # half of tile 4
    plan = binning.BinPlan(codes, 5)
    h = plan.host()
    assert h["tile_run"][1] == h["tile_run"][2]          # tile 1: no run
    x = np.random.RandomState(2).randn(2, 40)
    got, reads = _replay_k3(x, plan)
    npt.assert_array_equal(reads, (codes >= 0).astype(np.int64))
    ref = _oracle(x, codes, 5)
    npt.assert_allclose(got, ref, rtol=0, atol=1e-12 * np.abs(ref).max())


def test_k3_tile_at_the_16_bit_limit(monkeypatch):
    """65536 points a tile: the last offset is 65535, the most 16 bits
    hold; one more point a tile is refused."""
    monkeypatch.setattr(binning, "TILE", 65536)
    rng = np.random.RandomState(3)
    codes = rng.randint(-1, 9, 70000)
    codes[65535] = 4
    plan = binning.BinPlan(codes, 9)
    h = plan.host()
    assert h["local"].dtype == np.uint16 and h["local"].max() == 65535
    x = rng.randn(1, 70000)
    got, reads = _replay_k3(x, plan)
    npt.assert_array_equal(reads, (codes >= 0).astype(np.int64))
    ref = _oracle(x, codes, 9)
    npt.assert_allclose(got, ref, rtol=0, atol=1e-12 * np.abs(ref).max())
    monkeypatch.setattr(binning, "TILE", 65537)
    with pytest.raises(ValueError, match="16 bits"):
        binning.BinPlan(codes, 9).host()


def test_k3_tile_plan_dtypes_and_radial_bin_ranges(monkeypatch):
    """The offsets take 2 bytes a kept point and the run tables int32; on a
    radial grid each tile (a band of whole grid rows) touches one
    contiguous range of bins in order (a bin's stretch longer than RUN_MAX
    cut into several runs), and a bin's slots are in tile order."""
    monkeypatch.setattr(binning, "TILE", 4 * 64)
    monkeypatch.setattr(binning, "RUN_MAX", 16)
    codes, nbins = binning.cut_codes(_radial((64, 64)), 16)
    plan = binning.BinPlan(codes, nbins)
    h = plan.host()
    assert h["local"].dtype == np.uint16
    assert h["local"].size == np.count_nonzero(codes >= 0)
    for k in ("run_start", "run_slot", "tile_run", "bin_off"):
        assert h[k].dtype == np.int32
    slot_bin = np.repeat(np.arange(nbins), np.diff(h["bin_off"]))
    slot_tile = np.empty(h["run_slot"].size, np.int64)
    cut = False             # a bin's stretch of a tile cut at RUN_MAX
    for t in range(h["tile_run"].size - 1):
        runs = np.arange(h["tile_run"][t], h["tile_run"][t + 1])
        bins = slot_bin[h["run_slot"][runs]]
        assert np.all(np.diff(bins) >= 0)
        npt.assert_array_equal(np.unique(bins),
                               np.arange(bins[0], bins[-1] + 1))
        slot_tile[h["run_slot"][runs]] = t
        cut |= bins.size > np.unique(bins).size
    assert cut and np.diff(h["run_start"]).max() <= binning.RUN_MAX
    for b in range(nbins):       # a bin's slots in tile order
        assert np.all(np.diff(slot_tile[h["bin_off"][b]:h["bin_off"][b + 1]])
                      >= 0)


def test_binned_sum_checks_its_input():
    plan = binning.BinPlan(np.arange(6) % 3, 3)
    before = binning.binned_sum.launches
    with pytest.raises(ValueError, match="float32/float64"):
        binning.binned_sum(torch.arange(6), plan)
    with pytest.raises(ValueError, match="6 points"):
        binning.binned_sum(torch.zeros(2, 5), plan)
    with pytest.raises(ValueError, match="cuda or cpu"):
        binning.binned_sum(torch.zeros(2, 6, device="meta"), plan)
    binning.binned_sum(torch.zeros(2, 6), plan)       # CPU: the plain route
    assert binning.binned_sum.launches == before


def test_bin_plan_restrict_to_blocks():
    """The plan of a block of the grid: itself for the whole grid, else the
    block's codes, built once; the blocks' sums add up to the whole's."""
    rng = np.random.RandomState(5)
    grid, nbins = (12, 10), 7
    codes = rng.randint(-1, nbins, size=grid)
    plan = binning.BinPlan(codes.ravel(), nbins)
    assert plan.restrict(grid, [(0, 12), (0, 10)]) is plan
    x = torch.as_tensor(rng.randn(3, *grid))
    total = torch.zeros(3, nbins, dtype=x.dtype)
    for rows in [(0, 6), (6, 12)]:
        for cols in [(0, 5), (5, 10)]:
            sub = plan.restrict(grid, [rows, cols])
            assert plan.restrict(grid, [rows, cols]) is sub
            assert sub.nbins == nbins
            block = x[:, rows[0]:rows[1], cols[0]:cols[1]]
            npt.assert_array_equal(
                sub.codes, codes[rows[0]:rows[1], cols[0]:cols[1]].ravel())
            total += binning.binned_sum(block.reshape(3, -1).contiguous(),
                                        sub)
    npt.assert_allclose(total.numpy(), binning.binned_sum_plain(
        x.reshape(3, -1), plan).numpy(), rtol=1e-13, atol=1e-13)
