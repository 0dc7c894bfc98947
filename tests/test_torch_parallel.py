"""The sharded path of xrft_tpu_torch (``xrft_tpu_torch.parallel``) on the
CPU, in gloo process groups of 2 ranks (meshes ``{"p": 2}`` and ``{"p": 2,
"u": 1}``, whose axis u of one rank stands for a one-card mesh) and 4 ranks
(meshes ``{"p1": 2, "p2": 2}``, a DCN-hinted ``{"q1": (2, "dcn"),
"q2": (2, "ici")}`` and the benchmark's slab mesh ``{"fp": 4}``), against
``xrft_tpu`` computed in this process, and the benchmark's 3-D cell against
its plain reference (``benchmark/reference``).

Each mesh's ranks start once per module as a pool that takes cases from a
queue (``tests/torch_dist_cases.py``), so every case stays its own test;
every answer is awaited at most ``TIMEOUT`` seconds, so a hang fails the
case instead of the suite.  Each rank answers with its block's shape and
placement and the collectives it issued; rank 0 adds the gathered value.
The tests hold the values to ``xrft_tpu``'s (1e-12 of the largest value in
float64, 2e-6 in float32), the placement to the planned one
(``xrft_tpu.parallel.pencil.plan_forward_layout``), and each block's shape
to its placement, so that no rank holds more than its shard.
"""

import multiprocessing
import queue
import socket
import warnings

import numpy as np
import numpy.testing as npt
import pytest

import xrft_tpu
from xrft_tpu.parallel.pencil import plan_forward_layout

import torch_dist_cases

TIMEOUT = 60
MESHES = {
    2: {"p": {"p": 2}, "pu": {"p": 2, "u": 1}},
    4: {"q": {"p1": 2, "p2": 2}, "dcn": {"q1": (2, "dcn"), "q2": (2, "ici")},
        "fp": {"fp": 4}},
}
SIZES = {"p": 2, "p1": 2, "p2": 2, "q1": 2, "q2": 2, "u": 1, "fp": 4}


class _Pool:
    """``world`` gloo ranks serving cases (started at first use)."""

    def __init__(self, world):
        self.world = world
        self.procs = None

    def _start(self):
        ctx = multiprocessing.get_context("spawn")
        with socket.socket() as s:
            s.bind(("127.0.0.1", 0))
            port = s.getsockname()[1]
        self.inqs = [ctx.Queue() for _ in range(self.world)]
        self.outq = ctx.Queue()
        self.procs = [ctx.Process(
            target=torch_dist_cases.serve,
            args=(r, self.world, port, MESHES[self.world], self.inqs[r],
                  self.outq), daemon=True) for r in range(self.world)]
        for p in self.procs:
            p.start()
        for rank, status, info in self._collect():
            if status != "ready":
                self.close()
                pytest.fail(f"rank {rank} did not start:\n{info}")

    def _collect(self):
        out = []
        try:
            for _ in range(self.world):
                out.append(self.outq.get(timeout=TIMEOUT))
        except queue.Empty:
            self.close()
            pytest.fail(f"a rank did not answer within {TIMEOUT} s")
        return sorted(out, key=lambda t: t[0])

    def run(self, **case):
        """Every rank's answer to ``case``; raises the ranks' error (same
        type name and message on every rank) when the case raised."""
        if self.procs is None:
            self._start()
        for q in self.inqs:
            q.put(case)
        answers = self._collect()
        raised = [info for _, status, info in answers if status == "raised"]
        if raised:
            kinds = {(t, m) for t, m, _ in raised}
            if len(raised) != self.world or len(kinds) != 1:
                pytest.fail(f"ranks disagree: {answers}")
            return _Raised(*raised[0][:2], raised[0][2])
        return [info for _, _, info in answers]

    def close(self):
        if self.procs is None:
            return
        for q in self.inqs:
            try:
                q.put(None)
            except Exception:
                pass
        for p in self.procs:
            p.join(10)
            if p.is_alive():
                p.terminate()
                p.join(5)
        self.procs = None


class _Raised:
    def __init__(self, kind, message, tb):
        self.kind, self.message, self.tb = kind, message, tb


@pytest.fixture(scope="module")
def pool2():
    pool = _Pool(2)
    yield pool
    pool.close()


@pytest.fixture(scope="module")
def pool4():
    pool = _Pool(4)
    yield pool
    pool.close()


def labeled(values, dims, coords=None, name=None, chunks=None):
    """(xrft_tpu LabeledArray, the same as a case spec)."""
    ref = xrft_tpu.LabeledArray(np.asarray(values), dims=dims,
                                coords=coords or {}, name=name)
    if chunks:
        ref = ref.chunk(chunks)
    return ref, dict(values=np.asarray(values), dims=tuple(dims),
                     coords=coords or {}, name=name, chunks=chunks)


def tol(x):
    return 2e-6 if np.asarray(x).dtype in (np.float32, np.complex64) \
        else 1e-12


def assert_values(got, ref, rtol=None):
    """Within ``rtol`` of the largest |reference value| (default: 2e-6
    where either side is float32, 1e-12 otherwise)."""
    ref = np.asarray(ref)
    scale = max(np.abs(ref).max(), 1e-300)
    assert got.shape == ref.shape, (got.shape, ref.shape)
    npt.assert_allclose(got / scale, ref / scale, rtol=0,
                        atol=rtol or max(tol(got), tol(ref)))


def assert_labeled(res, ref, rtol=None):
    """Rank 0's gathered result against an xrft_tpu LabeledArray: dims,
    name, coordinate values and data values."""
    r0 = res[0]
    assert r0["dims"] == tuple(ref.dims)
    assert r0["name"] == ref.name
    assert set(r0["coords"]) == set(ref.coords)
    for c in ref.coords:
        npt.assert_allclose(r0["coords"][c], np.asarray(ref[c].values),
                            rtol=1e-14)
    assert_values(r0["value"], xrft_tpu.ops.carray.to_numpy(ref.data), rtol)


def assert_layout(res, placement):
    """Every rank holds its planned shard and no more: the placement is the
    planned one and each block is ceil(n / P) long on each sharded axis,
    whole on the others."""
    for r in res:
        assert r["placement"] == placement, (r["placement"], placement)
        want = tuple(-(-n // SIZES[placement[a]]) if a in placement else n
                     for a, n in enumerate(r["global_shape"]))
        assert r["local_shape"] == want, (r["local_shape"], want)


def calls(res, name):
    counts = {r["calls"][name] for r in res}
    assert len(counts) == 1, counts
    return counts.pop()


def planned(shape, chain, sharding, banned=(), mesh="q"):
    links = {"q1": "dcn", "q2": "ici"} if mesh == "dcn" else None
    return plan_forward_layout(shape, chain, sharding, SIZES, banned,
                               axis_links=links)[1]


# ---------------------------------------------------------------------------
# pencil_fftn
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("kind", ["fft", "ifft"])
def test_pencil_1axis_sharded(pool2, kind):
    rng = np.random.RandomState(0)
    x = rng.randn(32, 48) + 1j * rng.randn(32, 48)
    res = pool2.run(fn="pencil_fftn", mesh="p", x=x, axes=[0, 1],
                    axis_sharding={0: "p"}, kind=kind)
    ref = np.fft.fftn(x) if kind == "fft" else np.fft.ifftn(x)
    assert_values(res[0]["value"], ref)
    # forward: p parks on axis 1 after the second axis' move back;
    # inverse of a plain input: the output returns to the space layout
    want = planned(x.shape, [0, 1], {0: "p"}) if kind == "fft" else {0: "p"}
    assert_layout(res, want)


def test_pencil_2d_mesh_3d_fft(pool4):
    """Two sharded transform axes on a 2 x 2 mesh: one all_to_all per
    planned move (p1 parks on axis 2, which moves it again)."""
    rng = np.random.RandomState(1)
    x = rng.randn(16, 32, 24) + 1j * rng.randn(16, 32, 24)
    res = pool4.run(fn="pencil_fftn", mesh="q", x=x, axes=[0, 1, 2],
                    axis_sharding={0: "p1", 1: "p2"}, kind="fft")
    assert_values(res[0]["value"], np.fft.fftn(x))
    assert_layout(res, planned(x.shape, [0, 1, 2], {0: "p1", 1: "p2"}))
    steps, _ = plan_forward_layout(x.shape, [0, 1, 2], {0: "p1", 1: "p2"},
                                   SIZES)
    assert calls(res, "all_to_all_single") == \
        sum(s[0] == "move" for s in steps) == 3


def test_config5_sharded_3d_fft_parity(pool4):
    """Config 5 (tests/test_baseline_configs.py:113) at 32^3 on 2 x 2."""
    rng = np.random.RandomState(4)
    x = rng.randn(32, 32, 32) + 1j * rng.randn(32, 32, 32)
    res = pool4.run(fn="pencil_fftn", mesh="q", x=x, axes=[0, 1, 2],
                    axis_sharding={0: "p1", 1: "p2"}, kind="fft")
    assert_values(res[0]["value"], np.fft.fftn(x))
    assert_layout(res, planned(x.shape, [0, 1, 2], {0: "p1", 1: "p2"}))


def test_pencil_rfft_roundtrip(pool2):
    rng = np.random.RandomState(2)
    x = rng.randn(32, 64)
    res = pool2.run(fn="pencil_fftn", mesh="p", x=x, axes=[0, 1],
                    axis_sharding={0: "p"}, kind="rfft")
    assert_values(res[0]["value"], np.fft.rfftn(x))
    back = pool2.run(fn="pencil_fftn", mesh="p", x=x, axes=[0, 1],
                     axis_sharding={0: "p"}, kind="rfft", then="irfft")
    assert_values(back[0]["value"], x)
    assert_layout(back, {0: "p"})


@pytest.mark.parametrize("axis_sharding,kind,match", [
    ({1: "p"}, "rfft", "unsharded"),
    ({0: "p"}, "fft", "buddy"),
])
def test_pencil_errors(pool2, axis_sharding, kind, match):
    x = np.random.RandomState(3).randn(*((32, 64) if kind == "rfft"
                                         else (32,))) + 0j
    if kind == "rfft":
        x = x.real
    res = pool2.run(fn="pencil_fftn", mesh="p", x=x,
                    axes=list(range(x.ndim)), axis_sharding=axis_sharding,
                    kind=kind)
    assert isinstance(res, _Raised) and res.kind == "ValueError"
    assert match in res.message


def test_pencil_batch_only_sharding(pool2):
    """A sharded non-transform axis: batch parallelism, no collective."""
    rng = np.random.RandomState(3)
    x = rng.randn(16, 32) + 1j * rng.randn(16, 32)
    res = pool2.run(fn="pencil_fftn", mesh="p", x=x, axes=[1],
                    axis_sharding={0: "p"}, kind="fft")
    assert_values(res[0]["value"], np.fft.fft(x, axis=1))
    assert_layout(res, {0: "p"})
    assert calls(res, "all_to_all_single") == 0


def test_forward_chain_one_collective_per_axis(pool4):
    """One all_to_all per sharded transform axis, the planned layout, and
    the reverse chain back to the space layout
    (tests/test_parallel.py:156-186)."""
    rng = np.random.RandomState(7)
    x = rng.randn(8, 16, 32).astype(np.float32)
    res = pool4.run(fn="pencil_fftn", mesh="q", x=x, axes=[1, 2],
                    axis_sharding={1: "p1", 2: "p2"}, kind="fft")
    assert calls(res, "all_to_all_single") == 2
    assert_layout(res, {0: "p1", 1: "p2"})
    assert planned((8, 16, 32), [1, 2], {1: "p1", 2: "p2"}) == \
        {0: "p1", 1: "p2"}
    ref = np.fft.fftn(x.astype(np.float64), axes=[1, 2])
    assert_values(res[0]["value"], ref, rtol=2e-6)
    back = pool4.run(fn="pencil_fftn", mesh="q", x=x, axes=[1, 2],
                     axis_sharding={1: "p1", 2: "p2"}, kind="fft",
                     then="ifft")
    assert calls(back, "all_to_all_single") == 4
    assert_layout(back, {1: "p1", 2: "p2"})
    assert_values(back[0]["value"].real, x, rtol=2e-6)


def test_pencil_overlap_chunks(pool2):
    """config.pencil_overlap_chunks = 4: four asynchronous all_to_alls,
    the same values."""
    rng = np.random.RandomState(8)
    x = rng.randn(8, 16, 32).astype(np.float32)
    res = pool2.run(fn="pencil_fftn", mesh="p", x=x, axes=[1],
                    axis_sharding={1: "p"}, kind="fft",
                    config={"pencil_overlap_chunks": 4})
    assert calls(res, "all_to_all_single") == 4
    assert_values(res[0]["value"], np.fft.fft(x.astype(np.float64), axis=1),
                  rtol=2e-6)
    assert_layout(res, planned(x.shape, [1], {1: "p"}))
    back = pool2.run(fn="pencil_fftn", mesh="p", x=x, axes=[1],
                     axis_sharding={1: "p"}, kind="fft", then="ifft",
                     config={"pencil_overlap_chunks": 4})
    assert calls(back, "all_to_all_single") == 8
    assert_values(back[0]["value"].real, x, rtol=2e-6)


@pytest.mark.parametrize("kind", ["fft", "ifft", "rfft"])
def test_pencil_with_stacked_engine(pool2, kind):
    rng = np.random.RandomState(12)
    x = rng.randn(32, 64)
    if kind != "rfft":
        x = x + 1j * rng.randn(32, 64)
    ref = {"fft": np.fft.fftn, "ifft": np.fft.ifftn,
           "rfft": np.fft.rfftn}[kind](x)
    res = pool2.run(fn="pencil_fftn", mesh="p", x=x, axes=[0, 1],
                    axis_sharding={0: "p"}, kind=kind,
                    config={"fft_impl": "matmul"})
    assert_values(res[0]["value"], ref)


def test_pencil_matmul_engine_irfft(pool2):
    """The pencil irfft under "matmul": the chained axis walks back on the
    stacked engine, the resident real axis takes the pair engine's packed
    inverse; against numpy.fft.irfftn."""
    real = np.random.RandomState(12).randn(32, 64)
    x = np.fft.rfftn(real)
    res = pool2.run(fn="pencil_fftn", mesh="p", x=x, axes=[0, 1],
                    axis_sharding={0: "p"}, kind="irfft",
                    config={"fft_impl": "matmul"})
    assert_values(res[0]["value"], np.fft.irfftn(x, axes=[0, 1]))
    assert_values(res[0]["value"], real)


@pytest.mark.parametrize("kind", ["fft", "ifft", "rfft", "irfft"])
def test_pencil_hp(pool2, kind):
    """precision="hp": complex128 through the chain (float32 input too)."""
    rng = np.random.RandomState(13)
    x = rng.randn(32, 64)
    if kind in ("fft", "ifft"):
        xin = x + 1j * rng.randn(32, 64)
        ref = np.fft.fftn(xin) if kind == "fft" else np.fft.ifftn(xin)
        xin = xin.astype(np.complex64)
        ref = (np.fft.fftn if kind == "fft" else np.fft.ifftn)(
            xin.astype(np.complex128))
    elif kind == "rfft":
        xin = x.astype(np.float32)
        ref = np.fft.rfftn(xin.astype(np.float64))
    else:
        xin = np.fft.rfftn(x)
        ref = x
    res = pool2.run(fn="pencil_fftn", mesh="p", x=xin, axes=[0, 1],
                    axis_sharding={0: "p"}, kind=kind, precision="hp")
    assert res[0]["value"].dtype == (np.float64 if kind == "irfft"
                                     else np.complex128)
    assert_values(res[0]["value"], ref, rtol=1e-12)


def test_pencil_fftn_dcn_mesh_parity(pool4):
    rng = np.random.RandomState(21)
    x = rng.randn(8, 16, 32)
    res = pool4.run(fn="pencil_fftn", mesh="dcn", x=x, axes=[1, 2],
                    axis_sharding={1: "q1", 2: "q2"}, kind="fft")
    assert_values(res[0]["value"], np.fft.fftn(x, axes=[1, 2]))
    assert_layout(res, planned(x.shape, [1, 2], {1: "q1", 2: "q2"},
                               mesh="dcn"))


# ---------------------------------------------------------------------------
# sharded_fft and the spectra
# ---------------------------------------------------------------------------


def test_sharded_fft_batch(pool2):
    N = 32
    ref, spec = labeled(np.random.RandomState(4).randn(8, N), ["b", "x"],
                        {"x": np.arange(N) * 0.5 - 3.0, "b": np.arange(8)})
    res = pool2.run(fn="sharded_fft", mesh="p", arrays=[spec],
                    dim_shards={"b": "p"},
                    kwargs=dict(dim=["x"], true_phase=True,
                                true_amplitude=True))
    assert_labeled(res, xrft_tpu.fft(ref, dim=["x"], true_phase=True,
                                     true_amplitude=True))
    assert_layout(res, {0: "p"})


def test_sharded_fft_transform_dim_sharded(pool2):
    N = 64
    ref, spec = labeled(np.random.RandomState(5).randn(N, 16), ["x", "b"],
                        {"x": np.arange(N) * 0.25, "b": np.arange(16)})
    res = pool2.run(fn="sharded_fft", mesh="p", arrays=[spec],
                    dim_shards={"x": "p"},
                    kwargs=dict(dim=["x"], true_phase=True,
                                true_amplitude=True))
    assert_labeled(res, xrft_tpu.fft(ref, dim=["x"], true_phase=True,
                                     true_amplitude=True))
    assert_layout(res, planned((N, 16), [0], {0: "p"}))


def test_sharded_fft_shift_on_sharded_axis(pool2):
    """A 2-D transform whose chain leaves y sharded: the fftshift of y rides
    the chain's second all_to_all and the true-phase ifftshift of y, before
    the transform, is an explicit exchange; the layout stays the planned
    one, and a decreasing x coordinate is flipped on its block."""
    N = 32
    ref, spec = labeled(np.random.RandomState(6).randn(N, 16), ["y", "x"],
                        {"y": np.arange(N) * 0.5,
                         "x": np.arange(16)[::-1] * 1.0})
    kw = dict(dim=["y", "x"], shift=True, true_phase=True,
              true_amplitude=True)
    res = pool2.run(fn="sharded_fft", mesh="p", arrays=[spec],
                    dim_shards={"y": "p"}, kwargs=kw)
    assert_labeled(res, xrft_tpu.fft(ref, **kw))
    want = planned((N, 16), [0, 1], {0: "p"})
    assert want == {0: "p"}
    assert_layout(res, want)


FOLDS = ["fft-two-moves", "fft-one-move", "fft-3d-fp", "psd-roundtrip",
         "psd-dns-fp", "ifft-inverse", "fft-true-phase", "fft-odd-ranks"]


def _fold_cases():
    """{id: (pool, case, reference, planned layout, tolerance, all_to_alls,
    all_reduces, chain_shifts)} of the pencil chain's folded shifts."""
    rng = np.random.RandomState(31)
    N = 32
    yx = {"y": np.arange(N) * 0.5, "x": np.arange(16) * 1.0}
    ref2, spec2 = labeled(rng.randn(N, 16), ["y", "x"], yx)
    # true_phase, the default, adds an ifftshift before the transform
    shift = dict(shift=True, true_phase=False, true_amplitude=True)
    c = rng.randn(N, 48) + 1j * rng.randn(N, 48)
    cube = rng.randn(16, 16, 8)
    ref3, spec3 = labeled(cube, ["z", "y", "x"],
                          {d: np.arange(n) * 1.0
                           for d, n in zip("zyx", cube.shape)})
    psd = dict(dim=["y", "x"], window="hann", detrend="linear")
    refp, specp = labeled(rng.randn(N, N).astype(np.float32), ["y", "x"],
                          {"y": np.arange(N) * 0.5, "x": np.arange(N) * 0.5})
    _, specd = dns_cube(16, seed=23)
    refd, _ = labeled(specd["values"].astype(np.float64), DNS_DIMS,
                      specd["coords"])

    def fft(ref, **kw):
        return lambda: xrft_tpu.fft(ref, **kw)

    cases = [
        # y moves to x and back: the second all_to_all splits y again
        ("fft-two-moves", "pool2",
         dict(fn="sharded_fft", mesh="p", arrays=[spec2],
              dim_shards={"y": "p"}, kwargs=dict(dim=["y", "x"], **shift)),
         fft(ref2, dim=["y", "x"], **shift), {0: "p"}, None, 2, 0, 1),
        # x first, resident; then y's one move splits the shifted x
        ("fft-one-move", "pool2",
         dict(fn="sharded_fft", mesh="p", arrays=[spec2],
              dim_shards={"y": "p"}, kwargs=dict(dim=["x", "y"], **shift)),
         fft(ref2, dim=["x", "y"], **shift), {1: "p"}, None, 1, 0, 1),
        ("fft-3d-fp", "pool4",
         dict(fn="sharded_fft", mesh="fp", arrays=[spec3],
              dim_shards={"z": "fp"},
              kwargs=dict(dim=["z", "y", "x"], **shift)),
         fft(ref3, dim=["z", "y", "x"], **shift), {0: "fp"}, None, 2, 0, 1),
        # y has no destination: the roundtrip's return splits it again;
        # the mirror's flip along y is its one more all_to_all
        ("psd-roundtrip", "pool2",
         dict(fn="sharded_power_spectrum", mesh="p", arrays=[specp],
              dim_shards={"y": "p"}, kwargs=psd),
         lambda: xrft_tpu.power_spectrum(refp, **psd), {0: "p"}, None, 3, 1,
         1),
        ("psd-dns-fp", "pool4",
         dict(fn="sharded_power_spectrum", mesh="fp", arrays=[specd],
              dim_shards={"z": "fp"}, kwargs=DNS_KW),
         lambda: xrft_tpu.power_spectrum(refd, **DNS_KW), {1: "fp"},
         DNS_TOL, 3, 1, 1),
        # the inverse walks the chain back: each move's exchange splits its
        # transformed axis, so both ifftshifts ride them
        ("ifft-inverse", "pool2",
         dict(fn="pencil_fftn", mesh="p", x=c, axes=[0, 1],
              axis_sharding={0: "p"}, kind="ifft", post_shift_axes=[0, 1],
              post_kind="ifftshift"),
         lambda: np.fft.ifftshift(np.fft.ifftn(c)), {0: "p"}, None, 2, 0,
         2),
        # the true-phase ifftshift before the transform stays on
        # shards.take: one all_to_all of its own
        ("fft-true-phase", "pool2",
         dict(fn="sharded_fft", mesh="p", arrays=[spec2],
              dim_shards={"y": "p"},
              kwargs=dict(shift, dim=["y", "x"], true_phase=True)),
         fft(ref2, **dict(shift, dim=["y", "x"], true_phase=True)),
         {0: "p"}, None, 3, 0, 1),
        # one rank on the mesh axis: half of y is no whole chunk, so its
        # fftshift stays on shards.take
        ("fft-odd-ranks", "pool2",
         dict(fn="sharded_fft", mesh="pu", arrays=[spec2],
              dim_shards={"y": "u"}, kwargs=dict(dim=["y", "x"], **shift)),
         fft(ref2, dim=["y", "x"], **shift), {0: "u"}, None, 3, 0, 0),
    ]
    return {f[0]: f[1:] for f in cases}


@pytest.mark.parametrize("fold", FOLDS)
def test_chain_folds_the_shift_of_a_split_axis(request, fold):
    """The shift after the transform of an axis that an exchange of the
    pencil chain splits again over an even number of ranks rides that
    exchange: each rank's block is bit for bit the unfolded route's (the
    chain without the shift, then ``ops.shards``), the values and layout
    are the unsharded reference's, the spies see the chain's all_to_alls,
    the mirror's flip and the detrend's all_reduce and nothing for the
    shift, and ``chain_shifts`` counts the folded axes."""
    pool, case, ref, layout, rtol, a2a, reduce, folded = \
        _fold_cases()[fold]
    res = request.getfixturevalue(pool).run(unfolded=True, **case)
    for r in res:
        assert r["same_as_unfolded"] is True
        assert r["counted"]["chain_shifts"] == folded
    assert calls(res, "all_to_all_single") == a2a
    assert calls(res, "all_reduce") == reduce
    if case["fn"] == "pencil_fftn":
        assert_values(res[0]["value"], ref())
    else:
        assert_labeled(res, ref(), rtol)
    assert_layout(res, layout)


def test_sharded_power_spectrum_2d(pool4):
    """The PSD with linear detrend and hann over both sharded dims of a
    2 x 2 mesh: the moments and the window cross the shards."""
    N = 32
    ref, spec = labeled(np.random.RandomState(6).randn(N, N), ["y", "x"],
                        {"y": np.arange(N), "x": np.arange(N)})
    kw = dict(dim=["y", "x"], window="hann", detrend="linear")
    res = pool4.run(fn="sharded_power_spectrum", mesh="q", arrays=[spec],
                    dim_shards={"y": "p1", "x": "p2"}, kwargs=kw)
    assert_labeled(res, xrft_tpu.power_spectrum(ref, **kw))
    for r in res:
        assert r["placement"]  # sharded, not gathered
    assert_layout(res, res[0]["placement"])


@pytest.mark.parametrize("mirror_impl", ["kernel", "plain"])
def test_sharded_psd_flagship_layout(pool2, mirror_impl):
    """The flagship's layout at small size, (8, 32, 32) float32 with y
    sharded: the chain parks the sharding on the batch axis, so K1 runs
    once on each rank's (4, 32, 32) block with no gather; under "plain"
    the expansion runs on the block too."""
    N = 32
    vals = np.random.RandomState(9).randn(8, N, N).astype(np.float32)
    ref, spec = labeled(vals, ["time", "y", "x"],
                        {"time": np.arange(8.0), "y": np.arange(N) * 0.5,
                         "x": np.arange(N) * 0.5})
    kw = dict(dim=["y", "x"], window="hann", detrend="linear")
    res = pool2.run(fn="sharded_power_spectrum", mesh="p", arrays=[spec],
                    dim_shards={"y": "p"}, kwargs=kw,
                    config={"psd_mirror_impl": mirror_impl})
    assert_labeled(res, xrft_tpu.power_spectrum(ref, **kw))
    assert planned((8, N, N), [1], {1: "p"}, banned=(2,)) == {0: "p"}
    assert_layout(res, {0: "p"})
    assert calls(res, "mirror_psd") == (mirror_impl == "kernel")
    assert calls(res, "all_to_all_single") == 1


def test_sharded_psd_kernel_route(pool2):
    """fft_impl="kernel" on the CPU: the plain versions of K2 (float32)
    in each rank's local FFTs, at a length K2 takes (256)."""
    vals = np.random.RandomState(19).randn(4, 256, 256).astype(np.float32)
    c = {"y": np.arange(256) * 1.0, "x": np.arange(256) * 1.0}
    ref, spec = labeled(vals, ["b", "y", "x"], c)
    kw = dict(dim=["y", "x"], window="hann")
    res = pool2.run(fn="sharded_power_spectrum", mesh="p", arrays=[spec],
                    dim_shards={"y": "p"}, kwargs=kw,
                    config={"fft_impl": "kernel"})
    assert_labeled(res, xrft_tpu.power_spectrum(ref, **kw))
    assert_layout(res, {0: "p"})


def test_sharded_one_sided_psd(pool4):
    N = 32
    ref, spec = labeled(
        np.random.RandomState(9).randn(8, N, N).astype(np.float32),
        ["b", "y", "x"], {"y": np.arange(N) * 0.5, "x": np.arange(N) * 0.5})
    kw = dict(dim=["y", "x"], window="hann")
    res = pool4.run(fn="sharded_power_spectrum", mesh="q", arrays=[spec],
                    dim_shards={"b": "p1", "y": "p2"}, kwargs=kw)
    assert_labeled(res, xrft_tpu.power_spectrum(ref, **kw))
    want = planned((8, N, N), [1], {0: "p1", 1: "p2"}, banned=(2,))
    assert_layout(res, want)


def test_sharded_psd_dcn_mesh(pool4):
    N = 32
    ref, spec = labeled(np.random.RandomState(22).randn(N, N), ["y", "x"],
                        {"y": np.arange(N), "x": np.arange(N)})
    kw = dict(dim=["y", "x"], window="hann")
    res = pool4.run(fn="sharded_power_spectrum", mesh="dcn", arrays=[spec],
                    dim_shards={"y": "q1", "x": "q2"}, kwargs=kw)
    assert_labeled(res, xrft_tpu.power_spectrum(ref, **kw))


def test_sharded_psd_hp(pool2):
    """engine="hp" over the mesh: complex128 through the chain, equal to
    xrft_tpu's hp PSD to 1e-12."""
    N = 32
    vals = np.random.RandomState(24).randn(4, N, N).astype(np.float32)
    ref, spec = labeled(vals, ["b", "y", "x"],
                        {"y": np.arange(N) * 0.5, "x": np.arange(N) * 0.5})
    kw = dict(dim=["y", "x"], window="hann", detrend="linear")
    res = pool2.run(fn="sharded_power_spectrum", mesh="p", arrays=[spec],
                    dim_shards={"y": "p"}, kwargs=dict(kw, engine="hp"))
    assert res[0]["dtype"] == "torch.float64"
    assert_labeled(res, xrft_tpu.power_spectrum(ref, engine="hp", **kw),
                   rtol=1e-12)


def test_sharded_cross_spectrum(pool4):
    N = 32
    rng = np.random.RandomState(10)
    c = {"y": np.arange(N) * 0.5, "x": np.arange(N) * 0.5}
    r1, s1 = labeled(rng.randn(8, N, N), ["b", "y", "x"], c)
    r2, s2 = labeled(rng.randn(8, N, N), ["b", "y", "x"], c)
    res = pool4.run(fn="sharded_cross_spectrum", mesh="q", arrays=[s1, s2],
                    dim_shards={"b": "p1", "y": "p2"},
                    kwargs=dict(dim=["y", "x"]))
    assert_labeled(res, xrft_tpu.cross_spectrum(r1, r2, dim=["y", "x"]))
    assert_layout(res, planned((8, N, N), [1], {0: "p1", 1: "p2"},
                               banned=(2,)))


def test_sharded_cross_phase(pool2):
    rng = np.random.RandomState(15)
    c = {"x": np.arange(64) * 0.5, "b": np.arange(8)}
    r1, s1 = labeled(rng.randn(8, 64), ["b", "x"], c, name="u")
    r2, s2 = labeled(rng.randn(8, 64), ["b", "x"], c, name="v")
    res = pool2.run(fn="sharded_cross_phase", mesh="p", arrays=[s1, s2],
                    dim_shards={"x": "p"}, kwargs=dict(dim=["x"]))
    ref = xrft_tpu.cross_phase(r1, r2, dim=["x"])
    assert res[0]["name"] == ref.name == "u_v_phase"
    # a real negative cross spectrum has phase pi or -pi by the sign of a
    # zero imaginary part: compare on the circle
    wrapped = np.angle(np.exp(1j * (res[0]["value"] - np.asarray(ref.data))))
    assert np.abs(wrapped).max() <= 1e-12
    assert_layout(res, planned((8, 64), [1], {1: "p"}))


def test_sharded_coherence(pool2):
    N, SEG = 128, 16
    rng = np.random.RandomState(21)
    tt = np.arange(N) * 0.25
    shared = np.sin(2 * np.pi * 0.5 * tt)
    c = {"b": np.arange(8), "t": tt}
    r1, s1 = labeled(shared + 0.5 * rng.randn(8, N), ["b", "t"], c,
                     name="u", chunks={"t": SEG})
    r2, s2 = labeled(0.5 * shared + 0.5 * rng.randn(8, N), ["b", "t"], c,
                     name="v", chunks={"t": SEG})
    kw = dict(dim="t", real_dim="t", chunks_to_segments=True,
              segment_overlap=SEG // 2)
    res = pool2.run(fn="sharded_coherence", mesh="p", arrays=[s1, s2],
                    dim_shards={"b": "p"}, kwargs=kw)
    assert_labeled(res, xrft_tpu.coherence(r1, r2, **kw))
    assert_layout(res, {0: "p"})


@pytest.mark.parametrize("which", ["welch", "csd"])
def test_sharded_welch_and_csd(pool2, which):
    N, SEG = 128, 16
    rng = np.random.RandomState(23)
    c = {"b": np.arange(8), "t": np.arange(N) * 0.25}
    r1, s1 = labeled(rng.randn(8, N), ["b", "t"], c, name="u")
    r2, s2 = labeled(rng.randn(8, N), ["b", "t"], c, name="v")
    if which == "welch":
        res = pool2.run(fn="sharded_welch", mesh="p", arrays=[s1],
                        dim_shards={"b": "p"}, kwargs=dict(dim="t",
                                                           seglen=SEG))
        assert_labeled(res, xrft_tpu.welch(r1, dim="t", seglen=SEG))
    else:
        res = pool2.run(fn="sharded_csd", mesh="p", arrays=[s1, s2],
                        dim_shards={"b": "p"}, kwargs=dict(dim="t",
                                                           seglen=SEG))
        assert_labeled(res, xrft_tpu.csd(r1, r2, dim="t", seglen=SEG))
    assert_layout(res, {0: "p"})


def test_sharded_welch_segments_sharded(pool2):
    """Welch with the segments sharded (the transform dim is the only
    dim): the segment mean is one all_reduce, the estimate replicated."""
    N, SEG = 256, 32
    ref, spec = labeled(np.random.RandomState(25).randn(N), ["t"],
                        {"t": np.arange(N) * 0.5}, name="u")
    res = pool2.run(fn="sharded_welch", mesh="p", arrays=[spec],
                    dim_shards={"t": "p"},
                    kwargs=dict(dim="t", seglen=SEG, segment_overlap=0))
    assert_labeled(res, xrft_tpu.welch(ref, dim="t", seglen=SEG,
                                       segment_overlap=0))
    assert_layout(res, {})
    assert calls(res, "all_reduce") >= 1
    assert calls(res, "all_to_all_single") == 0


@pytest.mark.parametrize("overlap", [None, 8])
def test_sharded_segmented_power_spectrum(pool2, overlap):
    """chunks_to_segments moves the chunked dim's shard to its segment
    axis: every block holds whole segments (tests/test_parallel.py:
    410-459)."""
    N, SEG = (128 if overlap is None else 136), 16
    ref, spec = labeled(np.random.RandomState(11).randn(N, 24), ["x", "y"],
                        {"x": np.arange(N) * 0.5, "y": np.arange(24) * 1.0},
                        chunks={"x": SEG})
    kw = dict(dim=["x"], window="hann", chunks_to_segments=True)
    if overlap:
        kw["segment_overlap"] = overlap
    res = pool2.run(fn="sharded_power_spectrum", mesh="p", arrays=[spec],
                    dim_shards={"x": "p"}, kwargs=kw)
    assert_labeled(res, xrft_tpu.power_spectrum(ref, **kw))
    seg_ax = res[0]["dims"].index("x_segment")
    assert_layout(res, {seg_ax: "p"})
    assert calls(res, "all_to_all_single") == 0


def test_sharded_segmented_unchunked_dim_keeps_pencil(pool2):
    N = 64
    ref, spec = labeled(np.random.RandomState(12).randn(N, 8), ["x", "b"],
                        {"x": np.arange(N) * 1.0, "b": np.arange(8)},
                        chunks={"b": 4})
    kw = dict(dim=["x"], chunks_to_segments=True, true_phase=True,
              true_amplitude=True)
    res = pool2.run(fn="sharded_fft", mesh="p", arrays=[spec],
                    dim_shards={"x": "p"}, kwargs=kw)
    assert_labeled(res, xrft_tpu.fft(ref, **kw))
    assert calls(res, "all_to_all_single") >= 1


def test_sharded_segmented_cross_spectrum(pool2):
    N, SEG = 128, 16
    rng = np.random.RandomState(13)
    c = {"x": np.arange(N) * 0.5}
    r1, s1 = labeled(rng.randn(N), ["x"], c, chunks={"x": SEG})
    r2, s2 = labeled(rng.randn(N), ["x"], c, chunks={"x": SEG})
    kw = dict(dim=["x"], chunks_to_segments=True)
    res = pool2.run(fn="sharded_cross_spectrum", mesh="p", arrays=[s1, s2],
                    dim_shards={"x": "p"}, kwargs=kw)
    assert_labeled(res, xrft_tpu.cross_spectrum(r1, r2, **kw))
    assert_layout(res, {0: "p"})


# ---------------------------------------------------------------------------
# the isotropic spectra
# ---------------------------------------------------------------------------


def test_sharded_isotropic_resident(pool2):
    """Spectral dims resident after the chain (y's shard parked on the
    batch): the binned sum runs per rank on its block (K3's entry point on
    the card), with no reduction, the result sharded over the batch."""
    N = 32
    ref, spec = labeled(np.random.RandomState(11).randn(8, N, N),
                        ["b", "y", "x"],
                        {"y": np.arange(N) * 1.0, "x": np.arange(N) * 1.0})
    kw = dict(dim=["y", "x"], truncate=True)
    res = pool2.run(fn="sharded_isotropic_power_spectrum", mesh="p",
                    arrays=[spec], dim_shards={"y": "p"}, kwargs=kw)
    assert_labeled(res, xrft_tpu.isotropic_power_spectrum(ref, **kw))
    assert_layout(res, {0: "p"})
    assert calls(res, "binned_sum") == 1
    assert calls(res, "binned_sum_plain") == 0


def test_sharded_isotropic_spectral_sharded(pool4):
    """A 2-D field sharded over both spectral dims: each rank bins its
    stretch of the grid with that stretch's plan (K3's entry point on the
    card) and the sums meet in all_reduces; the result is replicated."""
    N = 32
    c = {"y": np.arange(N) * 0.5, "x": np.arange(N) * 0.5}
    rng = np.random.RandomState(16)
    r1, s1 = labeled(rng.randn(N, N), ["y", "x"], c)
    r2, s2 = labeled(rng.randn(N, N), ["y", "x"], c)
    res = pool4.run(fn="sharded_isotropic_power_spectrum", mesh="q",
                    arrays=[s1], dim_shards={"y": "p1", "x": "p2"},
                    kwargs=dict(dim=["y", "x"]))
    assert_labeled(res, xrft_tpu.isotropic_power_spectrum(r1,
                                                          dim=["y", "x"]))
    assert_layout(res, {})
    assert calls(res, "binned_sum") == 1
    assert calls(res, "binned_sum_plain") == 0
    assert calls(res, "all_reduce") == 2
    res = pool4.run(fn="sharded_isotropic_cross_spectrum", mesh="q",
                    arrays=[s1, s2], dim_shards={"y": "p1", "x": "p2"},
                    kwargs=dict(dim=["y", "x"]))
    assert_labeled(res, xrft_tpu.isotropic_cross_spectrum(r1, r2,
                                                          dim=["y", "x"]))


def test_sharded_spectral_dim_on_one_rank_axis(pool2):
    """y sharded over a mesh axis of one rank: each rank's y block is the
    whole axis, so K1 mirrors the local block and K3 bins it with the whole
    plan, as for resident dims; the chain's exchange still runs."""
    N = 32
    c = {"y": np.arange(N) * 0.5, "x": np.arange(N) * 0.5}
    ref, spec = labeled(np.random.RandomState(17).randn(N, N), ["y", "x"], c)
    kw = dict(dim=["y", "x"], window="hann", detrend="linear")
    res = pool2.run(fn="sharded_power_spectrum", mesh="pu", arrays=[spec],
                    dim_shards={"y": "u"}, kwargs=kw)
    assert_labeled(res, xrft_tpu.power_spectrum(ref, **kw))
    assert_layout(res, {0: "u"})
    assert calls(res, "mirror_psd") == 1
    assert calls(res, "all_to_all_single") >= 1
    kw = dict(dim=["y", "x"])
    res = pool2.run(fn="sharded_isotropic_power_spectrum", mesh="pu",
                    arrays=[spec], dim_shards={"y": "u"}, kwargs=kw)
    assert_labeled(res, xrft_tpu.isotropic_power_spectrum(ref, **kw))
    assert calls(res, "binned_sum") == 1
    assert calls(res, "binned_sum_plain") == 0


def test_sharded_isotropic_3d_shells(pool4):
    N = 16
    ref, spec = labeled(np.random.RandomState(15).randn(4, N, N, N),
                        ["b", "z", "y", "x"],
                        {"z": np.arange(N) * 1.0, "y": np.arange(N) * 1.0,
                         "x": np.arange(N) * 1.0})
    kw = dict(dim=["z", "y", "x"], truncate=False)
    res = pool4.run(fn="sharded_isotropic_power_spectrum", mesh="q",
                    arrays=[spec], dim_shards={"b": "p1", "z": "p2"},
                    kwargs=kw)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        local = xrft_tpu.isotropic_power_spectrum(ref, **kw)
    assert_labeled(res, local)
    assert_layout(res, {0: "p1"})


# ---------------------------------------------------------------------------
# the generic sharded() wrapper
# ---------------------------------------------------------------------------

_T = np.arange(256) * 0.5


@pytest.mark.parametrize("name,args,kw", [
    ("spectrogram", (), dict(dim="t", seglen=64, window="hann")),
    ("stft", (), dict(dim="t", seglen=64, window="hann")),
    ("dct", (), dict(dim="t", type=2, norm="ortho")),
    ("hilbert", (), dict(dim="t")),
    ("resample", (), dict(num=128, dim="t")),
    ("resample_poly", (2, 3), dict(dim="t")),
    ("decimate", (4,), dict(dim="t")),
    ("periodogram", (), dict(dim="t", window="hann")),
])
def test_sharded_generic_batch_estimators(pool2, name, args, kw):
    ref, spec = labeled(np.random.RandomState(11).randn(8, 256), ["b", "t"],
                        {"t": _T, "b": np.arange(8)})
    res = pool2.run(fn="sharded", name=name, mesh="p", arrays=[spec],
                    args=args, dim_shards={"b": "p"}, kwargs=kw)
    local = getattr(xrft_tpu, name)(ref, *args, **kw)
    assert_labeled(res, local)
    assert_layout(res, {0: "p"})
    assert calls(res, "all_to_all_single") == 0


@pytest.mark.parametrize("name,kw", [
    ("hilbert2", dict(dim=["y", "x"])),
    ("dctn", dict(dim=["y", "x"], norm="ortho")),
    ("idstn", dict(dim=["y", "x"])),
])
def test_sharded_generic_multi_dim(pool2, name, kw):
    ref, spec = labeled(np.random.RandomState(14).randn(8, 24, 16),
                        ["b", "y", "x"], {"b": np.arange(8)})
    res = pool2.run(fn="sharded", name=name, mesh="p", arrays=[spec],
                    dim_shards={"b": "p"}, kwargs=kw)
    assert_labeled(res, getattr(xrft_tpu, name)(ref, **kw))
    assert_layout(res, {0: "p"})


@pytest.mark.parametrize("name", ["fftconvolve", "oaconvolve", "correlate"])
def test_sharded_generic_two_input(pool2, name):
    rng = np.random.RandomState(12)
    ref, spec = labeled(rng.randn(8, 200), ["b", "t"],
                        {"t": np.arange(200) * 1.0, "b": np.arange(8)})
    rk, sk = labeled(rng.randn(15), ["t"], {"t": np.arange(15) * 1.0})
    kw = dict(dims="t", mode="same")
    res = pool2.run(fn="sharded", name=name, mesh="p", arrays=[spec, sk],
                    dim_shards={"b": "p"}, kwargs=kw)
    assert_labeled(res, getattr(xrft_tpu, name)(ref, rk, **kw))
    assert_layout(res, {0: "p"})


@pytest.mark.parametrize("name,extra,kw,shard", [
    ("spectrogram", False, dict(dim="t", seglen=64), {"t": "p"}),
    ("dct", False, dict(dim="t"), {"t": "p"}),
    ("hilbert", False, dict(dim="t"), {"t": "p"}),
    ("fftconvolve", True, dict(dims="t"), {"t": "p"}),
    ("hilbert2", False, dict(dim=["b", "t"]), {"t": "p"}),
    ("dctn", False, dict(), {"b": "p"}),
])
def test_sharded_generic_rejects_transform_dim(pool2, name, extra, kw,
                                               shard):
    rng = np.random.RandomState(13)
    _, spec = labeled(rng.randn(8, 256), ["b", "t"],
                      {"t": _T, "b": np.arange(8)})
    arrays = [spec]
    if extra:
        arrays.append(labeled(rng.randn(15), ["t"],
                              {"t": np.arange(15) * 1.0})[1])
    res = pool2.run(fn="sharded", name=name, mesh="p", arrays=arrays,
                    dim_shards=shard, kwargs=kw)
    assert isinstance(res, _Raised) and res.kind == "ValueError"
    assert "no distributed-transform" in res.message


def test_sharded_generic_pencil_dispatch(pool2):
    ref, spec = labeled(np.random.RandomState(14).randn(64, 8), ["x", "b"],
                        {"x": np.arange(64) * 0.25, "b": np.arange(8)})
    res = pool2.run(fn="sharded", name="power_spectrum", mesh="p",
                    arrays=[spec], dim_shards={"x": "p"},
                    kwargs=dict(dim=["x"]))
    assert_labeled(res, xrft_tpu.power_spectrum(ref, dim=["x"]))
    assert calls(res, "all_to_all_single") >= 1


@pytest.mark.parametrize("name,match", [("nonsense", "unknown estimator"),
                                        ("pad", "no mesh route")])
def test_sharded_generic_unknown_and_unroutable(pool2, name, match):
    _, spec = labeled(np.zeros((4, 8)), ["b", "t"],
                      {"t": np.arange(8) * 1.0})
    res = pool2.run(fn="sharded", name=name, mesh="p", arrays=[spec],
                    dim_shards={})
    assert isinstance(res, _Raised) and match in res.message


def test_sharded_istft_roundtrip(pool2):
    vals = np.random.RandomState(17).randn(8, 256)
    _, spec = labeled(vals, ["b", "t"], {"t": _T, "b": np.arange(8)})
    res = pool2.run(fn="sharded", name="stft", then="istft", mesh="p",
                    arrays=[spec], dim_shards={"b": "p"},
                    kwargs=dict(dim="t", seglen=64, window="hann"))
    npt.assert_allclose(res[0]["value"][:, :256], vals, atol=1e-9)
    assert_layout(res, {0: "p"})


# ---------------------------------------------------------------------------
# detrend and window on a sharded transform dim
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("op", ["constant", "linear", "hann"])
def test_sharded_detrend_and_window_keep_shards(pool4, op):
    """The moments cross the shards in all_reduces (one per mesh axis for
    the linear fit's stacked moments); the result keeps its placement."""
    rng = np.random.RandomState(26)
    ref, spec = labeled(rng.randn(4, 16, 12), ["b", "y", "x"],
                        {"y": np.arange(16) * 1.0, "x": np.arange(12) * 1.0})
    res = pool4.run(fn="local_op", op=op, mesh="q", arrays=[spec],
                    dim_shards={"y": "p1", "x": "p2"},
                    kwargs=dict(dim=["y", "x"]))
    if op == "hann":
        from xrft_tpu.ops.window import apply_window

        want = apply_window(ref, ["y", "x"], "hann")[1]
        assert calls(res, "all_reduce") == 0
    else:
        want = xrft_tpu.detrend(ref, ["y", "x"], op)
        assert calls(res, "all_reduce") == 2
    assert_labeled(res, want)
    assert_layout(res, {1: "p1", 2: "p2"})


# ---------------------------------------------------------------------------
# meshes and shard_labeled
# ---------------------------------------------------------------------------


def test_shard_labeled_placement_and_unknown_dim(pool2):
    _, spec = labeled(np.random.RandomState(27).randn(16, 8), ["a", "b"])
    res = pool2.run(fn="shard_labeled", mesh="p", arrays=[spec],
                    dim_shards={"a": "p"})
    assert_layout(res, {0: "p"})
    npt.assert_array_equal(res[0]["value"], spec["values"])
    res = pool2.run(fn="shard_labeled", mesh="p", arrays=[spec],
                    dim_shards={"zz": "p"})
    assert isinstance(res, _Raised) and "shard dim 'zz'" in res.message


def test_make_mesh_needs_a_process_group():
    """No process group in this process: make_mesh says what to do."""
    from xrft_tpu_torch.parallel import make_mesh

    with pytest.raises(RuntimeError, match="init_process_group"):
        make_mesh({"p": 1}, device="cpu")


def test_axis_links_warns_once_on_an_unhinted_multi_host_mesh(monkeypatch):
    """Hosts are the mesh's ranks over LOCAL_WORLD_SIZE: an unhinted mesh
    over two hosts warns once that every axis is taken for ICI."""
    from xrft_tpu_torch.parallel import axis_links
    from xrft_tpu_torch.parallel import mesh as mesh_mod

    class _Mesh:
        mesh_dim_names = ("p",)

        def size(self):
            return 4

    m = _Mesh()
    monkeypatch.setenv("LOCAL_WORLD_SIZE", "4")
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        assert axis_links(m) == {"p": "ici"}
    monkeypatch.setenv("LOCAL_WORLD_SIZE", "2")
    with pytest.warns(RuntimeWarning, match="assume every axis is ICI"):
        assert axis_links(m) == {"p": "ici"}
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        assert axis_links(m) == {"p": "ici"}
    mesh_mod._MESH_LINKS[m] = {"p": "dcn"}
    assert axis_links(m) == {"p": "dcn"}


def test_make_mesh_axis_links_and_order(pool4):
    """DCN axes outermost, the hints registered (tests/test_parallel.py:
    506-519); plain sizes are ICI."""
    res = pool4.run(fn="make_mesh",
                    axis_shapes={"fp": (2, "ici"), "dp": (2, "dcn")})
    for r in res:
        assert r["names"] == ("dp", "fp") and r["shape"] == (2, 2)
        assert r["links"] == {"dp": "dcn", "fp": "ici"}
    res = pool4.run(fn="make_mesh", axis_shapes={"p": 4})
    assert all(r["links"] == {"p": "ici"} for r in res)
    res = pool4.run(fn="make_mesh", axis_shapes={"p": 3})
    assert isinstance(res, _Raised) and "has 3 ranks" in res.message


# ---------------------------------------------------------------------------
# the dns-2048 cell's call at a test size: the 3-D PSD of a (component, z, y,
# x) cube with z in four slabs, held to the benchmark's plain reference
# ---------------------------------------------------------------------------

DNS_DIMS = ["component", "z", "y", "x"]
DNS_KW = dict(dim=["z", "y", "x"], window="hann", detrend="linear")
# float32 data, float32 transforms of 32^3 points: the spectrum's rounding
# is a few 1e-7 of its largest value (the float32 tolerance of this file,
# ``tol``); the TF32 control of the 2048^3 cell reads 1e-3 (PERF.md)
DNS_TOL = 2e-6


def dns_cube(n=32, seed=20):
    """One velocity component of a seeded n^3 cube far from zero mean
    (290 + 2 N(0, 1)), unit spacing, as the cell's configuration states."""
    x = (290.0 + 2.0 * np.random.RandomState(seed).randn(1, n, n, n)) \
        .astype(np.float32)
    coords = {"component": np.zeros(1)}
    coords.update({d: np.arange(n, dtype=float) for d in DNS_DIMS[1:]})
    return labeled(x, DNS_DIMS, coords)


def bench_reference(name):
    """``benchmark/reference/<name>.py``, the plain reference the benchmark
    holds the card to, imported as a package of its own."""
    import importlib
    import importlib.util
    import sys
    from pathlib import Path

    pkg = "bench_reference"
    if pkg not in sys.modules:
        where = Path(__file__).resolve().parents[1] / "benchmark" / \
            "reference"
        spec = importlib.util.spec_from_file_location(
            pkg, where / "__init__.py", submodule_search_locations=[
                str(where)])
        mod = importlib.util.module_from_spec(spec)
        sys.modules[pkg] = mod
        spec.loader.exec_module(mod)
    return importlib.import_module(f"{pkg}.{name}")


def dns_plane(x, at):
    """The reference's two-sided PSD of the cube ``x`` at the indices
    ``at`` (the component and one frequency index of z or y)."""
    import torch

    ref = bench_reference("sharded_power_spectrum")
    n = x.shape[1]
    coords = {d: np.arange(n, dtype=float) for d in DNS_DIMS[1:]}
    coords["component"] = np.zeros(1)
    t = torch.from_numpy(x)
    return ref.plane(lambda k: t[:, k], tuple(x.shape), 1, DNS_DIMS,
                     coords, DNS_KW, at).numpy()


def test_dns_cell_call_against_the_plain_reference(pool4):
    """``sharded_power_spectrum`` over (z, y, x), Hann, linear detrend, z
    over {"fp": 4}: the gathered spectrum, plane by plane along freq_z, and
    one freq_y plane, against the benchmark's streamed reference; the
    coordinates and dims against ``xrft_tpu`` (given the float64 values:
    its float32 detrend of data far from zero mean is 5e-3 off); z split as
    the plan leaves it."""
    _, spec = dns_cube()
    ref, _ = labeled(spec["values"].astype(np.float64), DNS_DIMS,
                     spec["coords"])
    res = pool4.run(fn="sharded_power_spectrum", mesh="fp", arrays=[spec],
                    dim_shards={"z": "fp"}, kwargs=DNS_KW)
    x = spec["values"]
    got = res[0]["value"]
    want = np.stack([dns_plane(x, {0: 0, 1: k})
                     for k in range(x.shape[1])])[None]
    assert_values(got, want, DNS_TOL)
    assert_values(got[0, :, 11], dns_plane(x, {0: 0, 2: 11}), DNS_TOL)
    assert_labeled(res, xrft_tpu.power_spectrum(ref, **DNS_KW), DNS_TOL)
    assert_layout(res, {1: "fp"})
    assert res[0]["dtype"] == "torch.float32"


def test_dns_cell_call_through_k6s_plan(pool4):
    """The cell's call with the prologue on K6's route, its launches
    replayed on the host (``k6_replay.py``): each rank's plan of its z
    slab, the window's stretch of z, the four moments summed over the ranks
    in the detrend's one all_reduce; three launches a rank, the exchanges
    of the plain route, and the spectrum against the benchmark's streamed
    reference, plane by plane along freq_z."""
    _, spec = dns_cube()
    res = pool4.run(fn="sharded_power_spectrum", mesh="fp", arrays=[spec],
                    dim_shards={"z": "fp"}, kwargs=DNS_KW, k6=True)
    x = spec["values"]
    for me, r in enumerate(res):
        count, sent = _dns_exchanges(x.shape, 4, me)
        assert r["k6_launches"] == 3, me
        assert r["counted"] == {"calls": 1, "exchanges": count,
                                "exchange_bytes": sent,
                                "chain_shifts": 1}, me
    want = np.stack([dns_plane(x, {0: 0, 1: k})
                     for k in range(x.shape[1])])[None]
    assert_values(res[0]["value"], want, DNS_TOL)
    assert_layout(res, {1: "fp"})


def _sent_by_take(index, n, parts, me, row_bytes):
    """Bytes rank ``me`` sends in ``ops.shards.take`` of an axis of ``n``
    split over ``parts`` ranks by the host ``index``: the rows it owns of
    every other rank's block of the result."""
    from xrft_tpu_torch.ops.shards import chunk_range

    c = -(-n // parts)
    rows = 0
    for r in range(parts):
        if r != me:
            a, b = chunk_range(len(index), parts, r)
            rows += int(np.count_nonzero(index[a:b] // c == me))
    return rows * row_bytes


def _dns_exchanges(shape, parts, me):
    """(exchanges, exchange_bytes) of rank ``me`` in the cell's call on a
    float32 (1, n, n, n) cube, worked out from the plan and the shapes:
    the detrend's one all_reduce of its four float64 moments; one
    all_to_all of the complex64 half spectrum for each planned move, each
    rank keeping 1 / parts of it, the last of which also carries the
    fftshift of z; the flip of the mirrored columns of the real PSD along
    z."""
    from xrft_tpu_torch.parallel.pencil import plan_forward_layout

    _, n, ny, nx = shape
    half = (1, n, ny, nx // 2 + 1)
    steps, final = plan_forward_layout(half, [1, 2], {1: "fp"},
                                       {"fp": parts}, banned=(3,))
    assert final == {1: "fp"}
    block = 8 * int(np.prod(half)) // parts
    moves = sum(s[0] == "move" for s in steps)
    count = 1 + moves + 1
    sent = 2 * (parts - 1) * (4 * 8) // parts
    sent += moves * (block - block // parts)
    # the Hermitian expansion: the mirrored columns of x, flipped along z
    # (rows of (y, mirrored x) float32)
    ks = (np.arange(nx) - nx // 2) % nx
    mirrored = int(np.count_nonzero(ks > nx // 2))
    sent += _sent_by_take((2 * (n // 2) - np.arange(n)) % n, n, parts, me,
                          ny * mirrored * 4)
    return count, sent


def test_dns_cell_call_counts_its_exchanges(pool4):
    """Each rank's ``exchanges`` and ``exchange_bytes`` in the cell's call
    equal what the plan and the shapes give; one call counted; every
    collective the spies saw is one of them."""
    _, spec = dns_cube()
    res = pool4.run(fn="sharded_power_spectrum", mesh="fp", arrays=[spec],
                    dim_shards={"z": "fp"}, kwargs=DNS_KW)
    for me, r in enumerate(res):
        count, sent = _dns_exchanges(spec["values"].shape, 4, me)
        assert r["counted"] == {"calls": 1, "exchanges": count,
                                "exchange_bytes": sent,
                                "chain_shifts": 1}, me
        assert r["calls"]["all_to_all_single"] + \
            r["calls"]["all_reduce"] == count
    assert _dns_exchanges((1, 2048, 2048, 2048), 4, 0)[1] / 2 ** 30 > 12.0

