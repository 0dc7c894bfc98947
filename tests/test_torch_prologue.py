"""The prologue of the port's transforms, ``detrend.detrend_and_window``,
on the CPU: which stacks kernel K6 takes (``detrend.k6_takes``), the plain
version the CPU runs (``detrend`` followed by ``apply_window``, bit for bit
and in metadata), and K6's arithmetic replayed in torch on the host
(``k6_replay.py``) through the wrapper's plan and metadata, against the
plain version.  The kernel itself runs on the card only
(``test_torch_cuda.py::test_k6_matches_plain``).
"""

import importlib
import warnings

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import xrft_tpu_torch as xt
from xrft_tpu_torch.ops import prologue
from xrft_tpu_torch.ops.window import apply_window

from k6_replay import install
from test_torch_detrend_far import CASES, DIMS, field
from torch_parity import pair

# the module (the package's ``detrend`` is the function)
det = importlib.import_module("xrft_tpu_torch.detrend")

F32, F64 = torch.float32, torch.float64
SHAPE = (6, 40, 64)
COORDS = {"z": np.arange(6) * 3.0, "y": np.arange(40) * 0.25,
          "x": np.arange(64) * 0.5}


@pytest.mark.parametrize("dtype,device,shape,axes,kind,window,contig,takes", [
    (F32, "cuda", (64, 4096, 4096), (1, 2), "linear", "hann", True, True),
    (F64, "cuda", (64, 4096, 4096), (1, 2), "linear", "hann", True, True),
    (F32, "cuda", (64, 2041, 4320), (2, 1), "linear", "hann", True, True),
    (F32, "cuda", (3, 257, 1001), (2,), "constant", None, True, True),
    (F32, "cuda", (1001,), (0,), "linear", "tukey", True, True),
    (F32, "cuda", (40, 64), (0, 1), "constant", True, True, True),
    (F32, "cuda", (3, 40, 64), (1, 2), "linear", "tukey", True, True),
    (F32, "cpu", (3, 40, 64), (1, 2), "linear", "hann", True, False),
    (F32, "cuda", (3, 40, 64), (1,), "linear", "hann", True, False),
    (F32, "cuda", (3, 40, 64), (0, 1), "linear", "hann", True, False),
    (F32, "cuda", (3, 40, 64), (0, 1, 2), "linear", None, True, True),
    (F32, "cuda", (1, 512, 2048, 2048), (1, 2, 3), "linear", "hann", True,
     True),
    (F64, "cuda", (2, 48, 256, 384), (3, 1, 2), "constant", None, True,
     True),
    (F32, "cuda", (2, 48, 256, 384), (0, 1, 2), "linear", "hann", True,
     False),
    (F32, "cuda", (2, 3, 40, 64), (0, 1, 2, 3), "linear", None, True, False),
    (F32, "cuda", (3, 40, 64), (0, 2), "constant", None, True, False),
    (F32, "cuda", (3, 40, 64), (1, 2), None, "hann", True, False),
    (F32, "cuda", (3, 40, 64), (1, 2), "linear", "no-such", True, False),
    (F32, "cuda", (3, 40, 64), (1, 2), "linear", "hann", False, False),
    (F32, "cuda", (3, 0, 64), (1, 2), "linear", "hann", True, False),
    (torch.float16, "cuda", (3, 40, 64), (1, 2), "linear", None, True,
     False),
    (torch.bfloat16, "cuda", (3, 40, 64), (2,), "constant", None, True,
     False),
    (torch.complex64, "cuda", (3, 40, 64), (1, 2), "linear", None, True,
     False),
    (torch.complex128, "cuda", (3, 40, 64), (1, 2), "constant", "hann", True,
     False),
    (torch.int16, "cuda", (3, 40, 64), (1, 2), "linear", None, True, False),
    (torch.uint8, "cuda", (3, 40, 64), (2,), "constant", "hann", True, False),
])
def test_which_stacks_k6_takes(dtype, device, shape, axes, kind, window,
                               contig, takes):
    """Real float32/float64 CUDA data, contiguous and not empty; a constant
    or linear detrend over the trailing axis or the two or three trailing
    axes, in any order; any window or none.  Nothing else: not three
    leading axes, not four."""
    assert det.k6_takes(dtype, device, shape, axes, kind, window,
                        contig) is takes


def assert_identical(got, want):
    """Equal bit for bit, in dtype, dims, name, attrs and coordinates."""
    assert got.dtype == want.dtype and tuple(got.dims) == tuple(want.dims)
    assert got.name == want.name and got.attrs == want.attrs
    assert set(got.coords) == set(want.coords)
    for c in want.coords:
        np.testing.assert_array_equal(got.coords[c].values,
                                      want.coords[c].values)
        assert got.coords[c].attrs == want.coords[c].attrs
    assert torch.equal(got.data, want.data)


def labeled(dtype, name, shape=SHAPE, seed=11):
    vals = field(name, dtype, shape, seed)
    coords = {d: COORDS[d][:n] for d, n in zip("zyx", shape)}
    _, da = pair(vals, ("z", "y", "x"), coords=coords, name="f",
                 attrs={"units": "K"})
    return da


@pytest.mark.parametrize("window", [None, "hann", "tukey"])
@pytest.mark.parametrize("ndim", sorted(DIMS))
@pytest.mark.parametrize("kind", [None, "constant", "linear"])
@pytest.mark.parametrize("dtype,name", CASES)
def test_the_cpu_prologue_is_detrend_then_window(dtype, name, kind, ndim,
                                                 window):
    """On the CPU the prologue is the two steps it replaces, as they are:
    the same values bit for bit, and the same metadata."""
    da = labeled(dtype, name)
    dims = DIMS[ndim]
    got = det.detrend_and_window(da, dims, kind, window)
    want = xt.detrend(da, dims, kind)
    if window is not None:
        _, want = apply_window(want, dims, window)
    assert_identical(got, want)


@pytest.fixture
def replay(monkeypatch):
    """A switch to K6's route on the CPU: ``k6_takes`` asked as for a CUDA
    tensor, and the kernel's launch replaced by ``k6_replay``."""
    return lambda: install(monkeypatch.setattr)


FAR = ["counts", "sst", "pressure"]


@pytest.mark.parametrize("window", [None, "hann", True])
@pytest.mark.parametrize("dims", ["x", ("y", "x"), ("x", "y"),
                                  ("z", "y", "x"), ("x", "z", "y"),
                                  ("y", "x", "z")])
@pytest.mark.parametrize("kind", ["constant", "linear"])
@pytest.mark.parametrize("shape", [SHAPE, (3, 1, 33), (2, 7, 1), (1, 9, 17)])
@pytest.mark.parametrize("dtype", ["float32", "float64"])
@pytest.mark.parametrize("name", FAR)
def test_k6s_arithmetic_is_the_plain_versions(replay, name, dtype, shape,
                                              kind, dims, window):
    """The wrapper's plan and metadata, with the kernel's arithmetic
    replayed, against the plain version, over one, two or three axes in
    any order, a length-1 axis among them: bit for bit where every moment
    sums exactly (12-bit counts), else within 2^-22 (float32) or 1e-13
    (float64) of the plain result's largest |value|; the same metadata
    either way, and three launches."""
    da = labeled(dtype, name, shape)
    dims = list(dims)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", FutureWarning)      # window=True
        want = xt.detrend(da, dims, kind)
        if window is not None:
            _, want = apply_window(want, dims, window)
        replayed = replay()
        got = det.detrend_and_window(da, dims, kind, window)
    assert replayed.launches == 3
    if name == "counts":
        assert_identical(got, want)
        return
    tol = 2.0 ** -22 if dtype == "float32" else 1e-13
    diff = (got.data.double() - want.data.double()).abs().max()
    assert diff <= tol * want.data.double().abs().max()
    assert_identical(got.copy(data=want.data), want)
    assert got.dtype == want.dtype


def test_the_plain_prologue_counts_on_a_cuda_tensor_only(monkeypatch):
    """``prologue_plain_cuda`` counts the prologues of CUDA data that K6
    does not take; CPU data are not counted."""
    from xrft_tpu_torch import telemetry

    da = labeled("float32", "sst")
    telemetry.reset()
    det.detrend_and_window(da, ["z", "y", "x"], "linear", "hann")
    det.detrend_and_window(da, ["y", "x"], "linear", "hann")
    assert telemetry.snapshot()["prologue_plain_cuda"] == 0
    telemetry.reset()


@pytest.mark.parametrize("rows,nx,want", [
    (64 * 4096, 4096, (1, 4096)),       # the flagship: whole rows
    (64 * 2041, 4320, (1, 4320)),
    (8, 1 << 22, (512, 8192)),          # long rows: cut into chunks
    (1, 5000, (1, 5000)),
    (4, 100, (1, 100)),                 # short rows stay whole
    (1, 8193, (2, 8192)),               # one column past a chunk
])
def test_rows_are_cut_only_where_too_few_fill_the_card(rows, nx, want):
    """A row is one warp's task up to 8192 columns and is cut into chunks
    of 8192 beyond, however many rows there are (8 rows of 2^22 values give
    4096 warps)."""
    nchunks, cw = prologue.chunking(nx)
    assert (nchunks, cw) == want
    assert (nchunks - 1) * cw < nx <= nchunks * cw


def test_plan_of_a_sharded_block():
    """The centred coordinates of a block start at its global offset; the
    count and sums of squares are the whole field's; over two axes and
    over three, z split."""
    p = prologue.plan((4, 32, 48), (4, 16, 48), (1, 2), True, {1: 16, 2: 0})
    assert (p.batch, p.ny, p.nx, p.order) == (4, 16, 48, 2 | 3 << 2)
    assert (p.cy0, p.cx0) == (16 - 15.5, -23.5)
    assert p.n_el == 32 * 48
    c = np.arange(32) - 15.5
    assert p.css_y == float(np.sum(c ** 2)) * 48
    q = prologue.plan((5, 9), (5, 9), (1,), False, {1: 0})
    assert (q.batch, q.ny, q.nx, q.order, q.cy0) == (5, 1, 9, 0, 0.0)
    assert q.css_x == q.css_y == 0.0
    # the dns-2048 slab: z split over four ranks, this the third
    s = prologue.plan((1, 2048, 2048, 2048), (1, 512, 2048, 2048),
                      (1, 2, 3), True, {1: 1024, 2: 0, 3: 0})
    assert (s.batch, s.nz, s.ny, s.nx, s.naxes) == (1, 512, 2048, 2048, 3)
    assert (s.cz0, s.cy0, s.cx0) == (1024 - 1023.5, -1023.5, -1023.5)
    assert s.n_el == 2048.0 ** 3
    c = np.arange(2048) - 1023.5
    assert s.css_z == s.css_y == s.css_x == float(np.sum(c ** 2)) * 2048 ** 2
    assert (s.order, s.wlast) == (1 | 2 << 2 | 3 << 4, 0)
    # any order, a length-1 axis left out of the fit, the window's last
    # factor that of the first axis
    t = prologue.plan((4, 1, 6, 8), (4, 1, 3, 8), (3, 1, 2), True,
                      {3: 0, 1: 0, 2: 3})
    assert (t.batch, t.nz, t.ny, t.nx, t.cy0) == (4, 1, 3, 8, 3 - 2.5)
    assert (t.order, t.wlast, t.css_z, t.n_el) == (3 | 2 << 2, 2, 0.0, 48.0)


@pytest.mark.parametrize("shape,axes,linear,code", [
    ((4, 6, 8), (1, 2), True, (6, 0)),
    ((4, 6, 8), (2, 1), True, (4, 0)),
    ((4, 6, 8), (1, 2), False, (0, 0)),
    ((4, 1, 8), (1, 2), True, (3, 0)),
    ((4, 6, 1), (2, 1), True, (1, 0)),
    ((4, 8), (1,), True, (3, 0)),
    ((4, 8), (1,), False, (0, 0)),
    ((2, 4, 6, 8), (1, 2, 3), True, (8, 1)),
    ((2, 4, 6, 8), (3, 1, 2), True, (5, 1)),
    ((2, 4, 6, 8), (2, 3, 1), True, (7, 0)),
    ((2, 4, 6, 8), (2, 1, 3), True, (8, 0)),
    ((2, 4, 6, 8), (1, 3, 2), True, (7, 1)),
    ((2, 4, 6, 8), (1, 2, 3), False, (0, 0)),
    ((4, 1, 6, 8), (3, 1, 2), True, (4, 0)),
    ((2, 4, 1, 8), (1, 2, 3), True, (6, 1)),
    ((2, 4, 6, 1), (3, 2, 1), True, (2, 0)),
    ((2, 4, 1, 1), (1, 2, 3), True, (1, 1)),
])
def test_two_axis_kernel_code_of_each_order(shape, axes, linear, code):
    """The apply kernel's trend, derived once from the plan's fitted order
    (``trend_code``), over one, two or three axes in any order, length-1
    axes left out of the fit: its shape (1 r, 2 r r, 3 x, 4 x r, 5 x r r,
    6 r x, 7 r x r, 8 r r x; x the column's slope, r a row term, the first
    with the mean) and whether its first row term is z's."""
    p = prologue.plan(shape, shape, axes, linear, {a: 0 for a in axes})
    assert prologue.trend_code(p.order) == code
