"""The port's detrend of data far from zero mean, held to float64.

Fields users take spectra of sit far from zero: sea-surface temperature in
kelvin (290 +- 2), surface pressure in pascal (101325 +- 500), geopotential
height in metres (5500 +- 50), an imager's 12-bit counts (0-4095).  A
float32 trend of such a field rounds at the data's magnitude (3e-5 at 290,
7.8e-3 at 101325), and that rounding lands at DC.  The port keeps its
moments and trend in float64 until the subtraction
(``xrft_tpu_torch/detrend.py::_detrended``), so its float32 and complex64
results are held to ``xrft_tpu`` on the same values cast to float64, at
2e-6 of the largest |value|; ``xrft_tpu`` on the float32 values errs by
1e-5 to 2e-4 there, a defect of the reference that the port does not
repeat (``ROADMAP.md`` Queue 3).  The card's side of it is
``test_torch_cuda.py::test_detrend_far_from_zero_mean_on_the_card``.

  * ``detrend`` itself, constant and linear, over 1, 2 and 3 dims, on
    float32, complex64, uint16 and int16 data;
  * the estimators of ``test_torch_fuzz_parity.FAR_NAMES`` under the three
    routes, with the two-part check of
    :func:`torch_parity.assert_nearer_float64`;
  * the hp path on float64 data, at 1e-10 of numpy's float64 closed form;
  * the sharded PSD over 2 gloo ranks against the unsharded call.
"""

import functools
import warnings

import numpy as np
import pytest
import scipy.signal as sps

torch = pytest.importorskip("torch")

import xrft_tpu
import xrft_tpu_torch as xt
from xrft_tpu_torch.config import fft_impl

from test_torch_fuzz_parity import ENTRIES, FAR_NAMES, inputs
from torch_parity import IMPLS, assert_nearer_float64, assert_same, pair

TOL = 2e-6

# (mean, spread) of each field; counts are uniform on [0, 4096)
FIELDS = {"sst": (290.0, 2.0), "pressure": (101325.0, 500.0),
          "geopotential": (5500.0, 50.0), "counts": None}


def field(name, dtype, shape, seed):
    """Seeded values of field ``name`` in ``dtype``; a complex field holds
    two draws."""
    rng = np.random.default_rng(seed)
    dtype = np.dtype(dtype)

    def draw():
        if FIELDS[name] is None:
            return rng.integers(0, 4096, shape).astype(np.float64)
        mean, spread = FIELDS[name]
        x = mean + spread * rng.standard_normal(shape)
        return np.round(x) if dtype.kind in "iu" else x

    x = draw()
    if dtype.kind == "c":
        x = x + 1j * draw()
    return x.astype(dtype)


def as_float64(values):
    """The same values in double precision."""
    return values.astype(np.complex128 if values.dtype.kind == "c"
                         else np.float64)


# ---------------------------------------------------------------------------
# detrend itself
# ---------------------------------------------------------------------------

CASES = [("float32", f) for f in FIELDS] + \
    [("complex64", f) for f in FIELDS] + \
    [(d, f) for d in ("uint16", "int16") for f in ("counts", "geopotential")]
DIMS = {1: "x", 2: ["y", "x"], 3: ["z", "y", "x"]}


@pytest.mark.parametrize("ndim", sorted(DIMS))
@pytest.mark.parametrize("kind", ["constant", "linear"])
@pytest.mark.parametrize("dtype,name", CASES)
def test_detrend_far_from_zero_mean_at_float32_grade(dtype, name, kind,
                                                     ndim):
    """Within 2e-6 of max |residual| of xrft_tpu's detrend of the same
    values in float64, in single precision."""
    vals = field(name, dtype, (6, 40, 64), 11)
    coords = {"z": np.arange(6) * 3.0, "y": np.arange(40) * 0.25,
              "x": np.arange(64) * 0.5}
    dims = ("z", "y", "x")
    _, da = pair(vals, dims, coords=coords, name="f", attrs={"units": "K"})
    truth_in, _ = pair(as_float64(vals), dims, coords=coords, name="f",
                       attrs={"units": "K"})
    truth = xrft_tpu.detrend(truth_in, DIMS[ndim], kind)
    got = xt.detrend(da, DIMS[ndim], kind)
    assert got.dtype == (torch.complex64 if vals.dtype.kind == "c"
                         else torch.float32)
    assert_same(got, truth, TOL)


# ---------------------------------------------------------------------------
# the estimators: PSD, fft, cross spectra, Welch, csd, spectrogram, isotropic
# ---------------------------------------------------------------------------


def far(name):
    """``make`` of test_torch_fuzz_parity.inputs: field ``name`` drawn in
    float32 and then cast to the asked dtype."""
    return lambda dtype, shape, seed: field(name, "float32", shape,
                                            seed).astype(dtype)


@functools.lru_cache(maxsize=None)
def references(entry, name):
    """xrft_tpu on the float32 values and on the same values in float64."""
    kind, _, call = ENTRIES[entry]
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        return tuple(call(xrft_tpu, *inputs(dtype, kind, make=far(name))[0])
                     for dtype in ("float32", "float64"))


@pytest.mark.parametrize("impl", IMPLS)
@pytest.mark.parametrize("name", ["sst", "pressure"])
@pytest.mark.parametrize("entry", FAR_NAMES)
def test_estimators_far_from_zero_mean_at_float32_grade(entry, name, impl):
    kind, _, call = ENTRIES[entry]
    want, truth = references(entry, name)
    _, (pa, pb) = inputs("float32", kind, make=far(name))
    with warnings.catch_warnings(), fft_impl(impl):
        warnings.simplefilter("ignore")
        got = call(xt, pa, pb)
    single = {np.dtype(np.float64): np.float32,
              np.dtype(np.complex128): np.complex64}
    assert got.values.dtype == single[np.asarray(truth.values).dtype]
    assert_nearer_float64(got, want, truth, TOL)


# ---------------------------------------------------------------------------
# hp: float64 throughout
# ---------------------------------------------------------------------------


def psd_closed_form(v, dx, linear):
    """numpy's float64 density PSD of one (N, N) field: the mean or the
    plane removed, a periodic Hann window on both dims."""
    n = v.shape[0]
    i = np.arange(n) - (n - 1) / 2
    vd = v - v.mean()
    if linear:
        css = (i ** 2).sum() * n
        vd = vd - (vd * i[:, None]).sum() / css * i[:, None] \
            - (vd * i[None, :]).sum() / css * i[None, :]
    w = sps.windows.hann(n, sym=False)
    f = np.fft.fftshift(np.fft.fftn(vd * (w[:, None] * w[None, :]))) * dx ** 2
    return np.abs(f) ** 2 * (1.0 / (n * dx)) ** 2


@pytest.mark.parametrize("impl", ["torch", "kernel"])
@pytest.mark.parametrize("kind", ["constant", "linear"])
@pytest.mark.parametrize("name", ["sst", "pressure", "geopotential"])
def test_hp_psd_far_from_zero_mean(name, kind, impl):
    """The hp PSD of float64 data far from zero mean, within 1e-10 of
    numpy's float64 closed form."""
    n, dx = 64, 0.5
    vals = field(name, "float64", (n, n), 12)
    _, da = pair(vals, ("y", "x"),
                 coords={"y": np.arange(n) * dx, "x": np.arange(n) * dx})
    with fft_impl(impl):
        got = xt.power_spectrum(da, dim=["y", "x"], window="hann",
                                detrend=kind, engine="hp").values
    want = psd_closed_form(vals, dx, kind == "linear")
    assert got.dtype == np.float64
    assert np.abs(got - want).max() <= 1e-10 * np.abs(want).max()


# ---------------------------------------------------------------------------
# the sharded path
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def pool2():
    from test_torch_parallel import _Pool

    pool = _Pool(2)
    yield pool
    pool.close()


@pytest.mark.parametrize("kind", ["constant", "linear"])
def test_sharded_psd_of_sst(pool2, kind):
    """The PSD of SST with y sharded over 2 gloo ranks: one all_reduce for
    the detrend's moments, within 2e-6 of max of the unsharded call, and
    both within 2e-6 of xrft_tpu on the same values in float64."""
    from test_torch_parallel import assert_labeled, assert_values, calls, \
        labeled

    vals = field("sst", "float32", (4, 32, 32), 13)
    coords = {"y": np.arange(32) * 1.0, "x": np.arange(32) * 0.5}
    _, spec = labeled(vals, ["b", "y", "x"], coords)
    truth_in, _ = labeled(as_float64(vals), ["b", "y", "x"], coords)
    kw = dict(dim=["y", "x"], window="hann", detrend=kind)
    res = pool2.run(fn="sharded_power_spectrum", mesh="p", arrays=[spec],
                    dim_shards={"y": "p"}, kwargs=kw)
    _, da = pair(vals, ("b", "y", "x"), coords=coords)
    unsharded = xt.power_spectrum(da, **kw).values
    assert res[0]["dtype"] == "torch.float32"
    assert calls(res, "all_reduce") == 1
    assert_values(res[0]["value"], unsharded, TOL)
    assert_labeled(res, xrft_tpu.power_spectrum(truth_in, **kw), TOL)
