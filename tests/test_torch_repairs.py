"""The port's dtype and naming faults against ``xrft_tpu``, repaired:
integer, bool and float16 input through the prologue and the transforms,
the hp ``fft``'s name, and ``pad`` of complex data in the modes that order
complex values.

Each case runs the same seeded numpy input through ``xrft_tpu`` on the CPU
(x64, as ``conftest.py`` sets it up) and through ``xrft_tpu_torch`` on
``device="cpu"``, under each ``fft_impl`` where a transform runs.  The
port's result dtype is ``xrft_tpu``'s, except where ``xrft_tpu`` lifts
data it computes in single precision to double with its float64 host
constants (the window, the density scale): the port keeps single
precision there, as for float32 input (``ROADMAP.md``, the divergence
"float32 data stay float32").  Values agree to 1e-12 of the largest
|value| in double precision and 2e-6 in single.
"""

import warnings

import numpy as np
import numpy.testing as npt
import pytest

torch = pytest.importorskip("torch")

import xrft_tpu
import xrft_tpu_torch as xt
from xrft_tpu_torch.config import fft_impl

from torch_parity import IMPLS, assert_same, pair

RFFT16 = "RFFT input must be float32 or float64, got float16"
SINGLE = {np.dtype(np.float64): np.dtype(np.float32),
          np.dtype(np.complex128): np.dtype(np.complex64)}


def values(dtype, shape, seed):
    """Seeded data of ``dtype``: counts for integers, a coin for bool,
    a trend plus noise for floats."""
    rng = np.random.default_rng(seed)
    dtype = np.dtype(dtype)
    if dtype == np.bool_:
        return rng.random(shape) > 0.5
    if dtype.kind in "iu":
        return rng.integers(0, 200, shape).astype(dtype)
    # a zero-mean trend; data far from zero mean are held in
    # test_torch_fuzz_parity.py and by test_uint16_psd_errs_at_most_as_the_
    # reference
    x = rng.standard_normal(shape) * 3 + \
        (np.arange(shape[-1]) - shape[-1] / 2) * 0.05
    if dtype.kind == "c":
        x = x + 1j * rng.standard_normal(shape)
    return x.astype(dtype)


def grid(dtype, shape=(8, 256), seed=0, name="f"):
    """(xrft_tpu, port) arrays on a (y, x) grid; x is 256 long, a length
    the float32 kernel K2 takes."""
    return pair(values(dtype, shape, seed), ("y", "x"),
                coords={"y": np.arange(shape[0]) * 2.0,
                        "x": np.arange(shape[1]) * 0.5}, name=name)


def tol(dtype):
    return 2e-6 if np.dtype(dtype) in (np.float32, np.complex64) else 1e-12


def held(got, want, single, tolerance=None):
    """The port's result against the reference's: its dtype is the
    reference's, or that dtype's single-precision counterpart where the
    data were computed in single precision (``single``)."""
    rd = np.asarray(want.values).dtype
    expect = SINGLE.get(rd, rd) if single else rd
    assert got.values.dtype == expect, (got.values.dtype, expect)
    assert_same(got, want, tolerance or tol(expect))


# ---------------------------------------------------------------------------
# integer and bool data through the prologue
# ---------------------------------------------------------------------------


def test_linear_detrend_removes_an_exact_integer_line():
    """An int32 line 3i + 1 is its own trend: the residual is 0 in float64
    (the port once cast the centred index to int32 and kept +-3.39)."""
    line = (3 * np.arange(12) + 1).astype(np.int32)
    ref, da = pair(line, ("x",), coords={"x": np.arange(12.0)})
    got = xt.detrend(da, "x", "linear")
    want = xrft_tpu.detrend(ref, "x", "linear")
    assert got.values.dtype == np.float64
    npt.assert_allclose(got.values, 0.0, atol=1e-13)
    held(got, want, single=False)


# the dtype each prologue computes integer and bool data in: numpy's
# result_type(dtype, float32) for "linear", JAX's float for "constant"
PROLOGUE_SINGLE = {
    "linear": {"int16": True, "int32": False, "int64": False,
               "uint8": True, "uint16": True, "bool": True},
    "constant": {"int16": True, "int32": True, "int64": False,
                 "uint8": True, "uint16": True, "bool": True},
}


@pytest.mark.parametrize("dtype", sorted(PROLOGUE_SINGLE["linear"]))
@pytest.mark.parametrize("kind", ["constant", "linear"])
def test_detrend_of_integer_and_bool_data(kind, dtype):
    ref, da = grid(dtype)
    got = xt.detrend(da, ["y", "x"], kind)
    want = xrft_tpu.detrend(ref, ["y", "x"], kind)
    # detrend alone returns the reference's dtype exactly
    assert got.values.dtype == np.asarray(want.values).dtype
    held(got, want, PROLOGUE_SINGLE[kind][dtype])


ESTIMATORS = {
    "power_spectrum": lambda m, a, b, kind: m.power_spectrum(
        a, dim="x", window="hann", detrend=kind),
    "cross_spectrum": lambda m, a, b, kind: m.cross_spectrum(
        a, b, dim="x", window="hann", detrend=kind),
    "welch": lambda m, a, b, kind: m.welch(a, dim="x", seglen=256,
                                           detrend=kind),
    "csd": lambda m, a, b, kind: m.csd(a, b, dim="x", seglen=256,
                                       detrend=kind),
    "spectrogram": lambda m, a, b, kind: m.spectrogram(
        a, dim="x", seglen=256, detrend=kind),
    "periodogram": lambda m, a, b, kind: m.periodogram(a, dim="x",
                                                       detrend=kind),
}


@pytest.mark.parametrize("impl", IMPLS)
@pytest.mark.parametrize("dtype", ["int16", "int32", "uint8", "bool"])
@pytest.mark.parametrize("kind", ["constant", "linear"])
@pytest.mark.parametrize("name", sorted(ESTIMATORS))
def test_estimators_of_integer_and_bool_data(name, kind, dtype, impl):
    """Each estimator at detrend="constant" (it raised) and "linear" (it
    was wrong by up to 7e4 of max for uint8) under every route, on 512
    samples in 256-sample segments."""
    (ra, pa), (rb, pb) = grid(dtype, (4, 512), 1, "a"), \
        grid(dtype, (4, 512), 2, "b")
    fn = ESTIMATORS[name]
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        want = fn(xrft_tpu, ra, rb, kind)
        with fft_impl(impl):
            got = fn(xt, pa, pb, kind)
    held(got, want, PROLOGUE_SINGLE[kind][dtype])


@pytest.mark.parametrize("impl", IMPLS)
def test_isotropic_spectra_of_integer_data(impl):
    """The isotropic spectra at a constant detrend (the cross spectrum
    raised) and a linear one, on int32 and uint8 256^2 grids."""
    for dtype in ("int32", "uint8"):
        (ra, pa), (rb, pb) = grid(dtype, (256, 256), 3, "a"), \
            grid(dtype, (256, 256), 4, "b")
        for kind in ("constant", "linear"):
            kw = dict(dim=["y", "x"], detrend=kind, window="hann")
            want = xrft_tpu.isotropic_power_spectrum(ra, **kw)
            with fft_impl(impl):
                got = xt.isotropic_power_spectrum(pa, **kw)
            held(got, want, PROLOGUE_SINGLE[kind][dtype])
            want = xrft_tpu.isotropic_cross_spectrum(ra, rb, **kw)
            with fft_impl(impl):
                got = xt.isotropic_cross_spectrum(pa, pb, **kw)
            held(got, want, PROLOGUE_SINGLE[kind][dtype])


@pytest.mark.parametrize("impl", IMPLS)
def test_cross_phase_of_integer_data(impl):
    """cross_phase of int32 data at a linear detrend, away from the bins
    whose cross spectrum is 0 up to rounding (DC, after the detrend)."""
    (ra, pa), (rb, pb) = grid("int32", seed=5, name="a"), \
        grid("int32", seed=6, name="b")
    kw = dict(dim="x", detrend="linear", window="hann")
    want = xrft_tpu.cross_phase(ra, rb, **kw)
    with fft_impl(impl):
        got = xt.cross_phase(pa, pb, **kw)
    assert got.values.dtype == np.float64
    cs = np.abs(np.asarray(xrft_tpu.cross_spectrum(ra, rb, **kw).values))
    keep = cs > 1e-6 * cs.max()
    d = np.angle(np.exp(1j * (got.values - np.asarray(want.values))))
    assert np.abs(d[keep]).max() <= 1e-10


@pytest.mark.parametrize("impl", IMPLS)
@pytest.mark.parametrize("dtype", ["int64", "int32", "uint8", "bool"])
def test_fft_of_integer_data_takes_jax_dtype(dtype, impl):
    """A transform with no prologue promotes as JAX's fft: 64-bit integers
    to complex128 (the port gave complex64), the rest to complex64."""
    ref, da = grid(dtype)
    want = xrft_tpu.fft(ref, dim="x")
    with fft_impl(impl):
        got = xt.fft(da, dim="x")
        got_r = xt.fft(da, dim="x", real_dim="x")
    assert got.values.dtype == np.asarray(want.values).dtype
    assert_same(got, want, tol(got.values.dtype))
    want_r = xrft_tpu.fft(ref, dim="x", real_dim="x")
    assert got_r.values.dtype == np.asarray(want_r.values).dtype
    assert_same(got_r, want_r, tol(got_r.values.dtype))


def test_phase_27_uint16_flagship_shape_small():
    """The flagship call of chip_smoke's phase 27 on uint16 counts at a
    small size: float32 as the JAX package computes it, within 2e-6 of the
    same values given as float64."""
    ref, da = grid("uint16", (256, 256))
    kw = dict(dim=["y", "x"], window="hann", detrend="linear")
    want = xrft_tpu.power_spectrum(ref, **kw)
    for impl in IMPLS:
        with fft_impl(impl):
            got = xt.power_spectrum(da, **kw)
            f64 = xt.power_spectrum(da.copy(data=da.data.double()), **kw)
        held(got, want, single=True)
        assert np.abs(got.values - f64.values).max() <= \
            2e-6 * np.abs(f64.values).max()


# ---------------------------------------------------------------------------
# the hp name
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("kw", [dict(window="hann"),
                                dict(detrend="constant"),
                                dict(detrend="linear", window="hann"),
                                dict(real_dim="x", window="hann")])
def test_hp_fft_keeps_the_name(kw):
    ref, da = grid("float32", name="sst")
    want = xrft_tpu.fft(ref, dim=["y", "x"], engine="hp", **kw)
    got = xt.fft(da, dim=["y", "x"], engine="hp", **kw)
    assert got.name == want.name == "sst"
    assert_same(got, want, 1e-12)


def test_hp_power_spectrum_keeps_the_reference_name():
    ref, da = grid("int16", name="sst")
    kw = dict(dim=["y", "x"], engine="hp", window="hann", detrend="linear")
    want = xrft_tpu.power_spectrum(ref, **kw)
    got = xt.power_spectrum(da, **kw)
    assert got.name == want.name
    assert_same(got, want, 1e-12)


# ---------------------------------------------------------------------------
# complex pad
# ---------------------------------------------------------------------------


COMPLEX_PADS = {
    "maximum": (dict(mode="maximum"), {}),
    "maximum_stat": (dict(mode="maximum", stat_length=dict(t=(3, 5))),
                     dict(stat_length=((3, 3), (3, 5)))),
    "minimum": (dict(mode="minimum"), {}),
    "minimum_stat": (dict(mode="minimum", stat_length=dict(t=4)),
                     dict(stat_length=((4, 4), (4, 4)))),
    "median_odd": (dict(mode="median", stat_length=dict(t=7)),
                   dict(stat_length=((7, 7), (7, 7)))),
    "median_even": (dict(mode="median"), {}),
    "linear_ramp": (dict(mode="linear_ramp"), {}),
    "linear_ramp_ends": (dict(mode="linear_ramp",
                              end_values=dict(t=(1.5 - 2j, -3.0))),
                         dict(end_values=((0, 0), (1.5 - 2j, -3.0)))),
}


def complex_series(dtype, n=40, seed=7):
    """(xrft_tpu, port) complex series with ties in the real part, so the
    imaginary part decides the order."""
    rng = np.random.default_rng(seed)
    x = np.round(rng.standard_normal((3, n)) * 2) + \
        1j * rng.standard_normal((3, n))
    return pair(x.astype(dtype), ("time", "t"),
                coords={"time": np.arange(3.0), "t": np.arange(n) * 0.5},
                name="z")


@pytest.mark.parametrize("dtype", [np.complex64, np.complex128])
@pytest.mark.parametrize("case", sorted(COMPLEX_PADS))
def test_complex_pad_matches_numpy_and_reference(case, dtype):
    """Bit for bit against numpy.pad (lexicographic order of (real, imag);
    the ramp's complex arithmetic per component), and against xrft_tpu.pad
    at the dtype's tolerance."""
    ref, da = complex_series(dtype)
    kw, np_kw = COMPLEX_PADS[case]
    got = xt.pad(da, dict(t=(5, 6)), **kw)
    want = np.pad(da.values, ((0, 0), (5, 6)), mode=kw["mode"], **np_kw)
    assert got.values.dtype == want.dtype
    npt.assert_array_equal(got.values, want)
    assert_same(got, xrft_tpu.pad(ref, dict(t=(5, 6)), **kw), tol(dtype))


def test_complex_pad_propagates_nan_as_numpy():
    """numpy's complex maximum and minimum keep the first value with a NaN
    part; its median of such values is the last in its sort order."""
    x = np.array([[1 + 1j, np.nan + 2j, 3 + np.nan * 1j, 5 + 0j, 2 - 1j],
                  [4 + 0j, 4 - 1j, 4 + 3j, -1 + 0j, 0 + 0j]])
    da = xt.LabeledArray(torch.as_tensor(x), dims=("a", "t"))
    for mode in ("maximum", "minimum", "median"):
        got = xt.pad(da, dict(t=(2, 1)), mode=mode).values
        want = np.pad(x, ((0, 0), (2, 1)), mode=mode)
        npt.assert_array_equal(got, want)


# ---------------------------------------------------------------------------
# float16
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("impl", IMPLS)
def test_float16_real_transform_raises_the_reference_error(impl):
    ref, da = grid("float16")
    with pytest.raises(ValueError, match=RFFT16):
        xrft_tpu.fft(ref, dim="x", real_dim="x")
    with fft_impl(impl), pytest.raises(ValueError, match=RFFT16):
        xt.fft(da, dim="x", real_dim="x")
    # a 2-D power_spectrum without a prologue takes the real transform too
    with pytest.raises(ValueError, match=RFFT16):
        xrft_tpu.power_spectrum(ref, dim=["y", "x"])
    with fft_impl(impl), pytest.raises(ValueError, match=RFFT16):
        xt.power_spectrum(da, dim=["y", "x"])


@pytest.mark.parametrize("impl", IMPLS)
def test_float16_complex_transform_promotes(impl):
    ref, da = grid("float16")
    want = xrft_tpu.fft(ref, dim="x")
    with fft_impl(impl):
        got = xt.fft(da, dim="x")
    assert got.values.dtype == np.asarray(want.values).dtype == np.complex64
    assert_same(got, want, 2e-6)


@pytest.mark.parametrize("impl", IMPLS)
@pytest.mark.parametrize("kw", [dict(detrend="linear"),
                                dict(window="hann"),
                                dict(detrend="constant", window="hann")])
def test_float16_estimators_with_a_prologue_return_values(kw, impl):
    """A linear detrend (to float32) or a window lifts float16 data to a
    dtype the real transform takes, in both packages.  xrft_tpu rounds the
    linear fit's mean to float16, which the port does not repeat (ROADMAP.md,
    Queue 3): under "linear" the port equals the reference on the same
    values in float32; elsewhere both compute in float16 first, held at
    float16's grade."""
    ref, da = grid("float16")
    linear = kw.get("detrend") == "linear"
    if linear:
        ref = ref.copy(data=ref.data.astype(np.float32))
    want = xrft_tpu.power_spectrum(ref, dim="x", **kw)
    with fft_impl(impl):
        got = xt.power_spectrum(da, dim="x", **kw)
    held(got, want, single=True, tolerance=None if linear else 4e-3)


def test_fft_core_takes_the_reference_dtypes_on_every_route():
    """ops.fft_core promotes and rejects at its entry, whatever the route."""
    from xrft_tpu_torch.ops import fft_core

    x16 = torch.ones(2, 256, dtype=torch.float16)
    for impl in IMPLS:
        with fft_impl(impl):
            assert fft_core.fftn(x16, [1]).dtype == torch.complex64
            assert fft_core.ifftn(x16, [1]).dtype == torch.complex64
            assert fft_core.fftn(x16.to(torch.int64), [1]).dtype == \
                torch.complex128
            assert fft_core.rfftn(x16.to(torch.int32), [1]).dtype == \
                torch.complex64
            with pytest.raises(ValueError, match=RFFT16):
                fft_core.rfftn(x16, [1])
            with pytest.raises(ValueError, match="only real valued inputs "
                               "supported for rfft"):
                fft_core.rfftn(x16.to(torch.complex64), [1])


@pytest.mark.parametrize("impl", IMPLS)
def test_fft_core_hands_float_and_complex_data_on_as_they_are(
        impl, monkeypatch):
    """Only what lax.fft would reject is converted: float32 and float64
    data reach the route real (K2's and K5a's real-input modes), complex
    data as they are, and integer data as JAX's float."""
    from xrft_tpu_torch.ops import fft_core

    seen = []
    for name in ("matmul_fft_nd", "fft_last", "fftn64"):
        orig = getattr(fft_core, name)

        def spy(x, *a, _orig=orig, **k):
            seen.append(x.dtype)
            return _orig(x, *a, **k)
        monkeypatch.setattr(fft_core, name, spy)
    for dtype in (torch.float32, torch.float64, torch.complex64,
                  torch.complex128, torch.int16, torch.int64):
        x = torch.arange(2 * 256).reshape(2, 256).to(dtype)
        want = {torch.int16: torch.float32,
                torch.int64: torch.float64}.get(dtype, dtype)
        for fn in (fft_core.fftn, fft_core.ifftn):
            seen.clear()
            with fft_impl(impl):
                fn(x, [1])
            assert impl == "torch" or seen[:1] == [want], (fn, dtype, seen)
        if not dtype.is_complex:
            assert fft_core._input(x, real=False).dtype == want
            assert fft_core._input(x, real=True).dtype == want
        if dtype in (torch.float32, torch.float64, torch.complex64,
                     torch.complex128):
            assert fft_core._input(x, real=False) is x


@pytest.mark.parametrize("impl", IMPLS)
def test_uint16_psd_errs_at_most_as_the_reference(impl):
    """12-bit counts (mean 2048, spread 1182) as uint16: both packages
    compute the flagship PSD in float32; xrft_tpu's rounding of the fit at
    the data's magnitude shows at DC against the float64 values, the
    port's residual fit does not: its error is float32 grade and no larger
    than xrft_tpu's."""
    rng = np.random.default_rng(27)
    counts = rng.integers(0, 4096, (2, 1024, 1024)).astype(np.uint16)
    dims = ("time", "y", "x")
    coords = {"y": np.arange(1024) * 1.0, "x": np.arange(1024) * 1.0}
    ref, da = pair(counts, dims, coords=coords, name="f")
    ref64, _ = pair(counts.astype(np.float64), dims, coords=coords, name="f")
    kw = dict(dim=["y", "x"], window="hann", detrend="linear")
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        truth = np.asarray(xrft_tpu.power_spectrum(ref64, **kw).values)
        want = np.asarray(xrft_tpu.power_spectrum(ref, **kw).values)
        with fft_impl(impl):
            got = xt.power_spectrum(da, **kw).values
    assert got.dtype == np.float32
    scale = np.abs(truth).max()
    err = np.abs(got - truth).max() / scale
    err_ref = np.abs(want - truth).max() / scale
    assert 0 < err <= err_ref, (err, err_ref)
    assert err <= 2e-6, err


# ---------------------------------------------------------------------------
# the sharded path: the same promotion on each rank's block
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def pool2():
    from test_torch_parallel import _Pool

    pool = _Pool(2)
    yield pool
    pool.close()


@pytest.mark.parametrize("dtype,single", [("int32", False), ("uint8", True)])
def test_sharded_psd_of_integer_data(pool2, dtype, single):
    """The linear detrend's moments on each rank's block of integer data
    (y sharded over 2 gloo ranks), in the reference's dtype."""
    from test_torch_parallel import assert_labeled, labeled

    vals = values(dtype, (4, 32, 32), 30)
    ref, spec = labeled(vals, ["b", "y", "x"],
                        {"y": np.arange(32) * 1.0, "x": np.arange(32) * 0.5})
    kw = dict(dim=["y", "x"], window="hann", detrend="linear")
    res = pool2.run(fn="sharded_power_spectrum", mesh="p", arrays=[spec],
                    dim_shards={"y": "p"}, kwargs=kw)
    want = xrft_tpu.power_spectrum(ref, **kw)
    assert res[0]["dtype"] == ("torch.float32" if single
                               else "torch.float64")
    assert_labeled(res, want, rtol=2e-6 if single else 1e-12)


def test_sharded_welch_of_int16_data(pool2):
    """welch at its default constant detrend (it raised on integer data)
    with the batch sharded: float32, as the JAX package's mean gives."""
    from test_torch_parallel import assert_labeled, labeled

    vals = values("int16", (8, 128), 31)
    ref, spec = labeled(vals, ["b", "t"], {"b": np.arange(8),
                                           "t": np.arange(128) * 0.25},
                        name="u")
    res = pool2.run(fn="sharded_welch", mesh="p", arrays=[spec],
                    dim_shards={"b": "p"}, kwargs=dict(dim="t", seglen=16))
    assert res[0]["dtype"] == "torch.float32"
    assert_labeled(res, xrft_tpu.welch(ref, dim="t", seglen=16), rtol=2e-6)


@pytest.mark.parametrize("dtype", ["uint16", "int32", "bool"])
def test_integer_psd_takes_the_mirror_kernel(dtype, monkeypatch):
    """The flagship PSD of integer and bool data reaches K1's wrapper (its
    plain version on the CPU): the transform promotes first, so the half
    spectrum is complex64 or complex128, which K1 takes."""
    from xrft_tpu_torch.ops import mirror

    calls = []
    real = mirror.mirror_psd

    def counting(*a, **k):
        calls.append(a[0].dtype)
        return real(*a, **k)

    monkeypatch.setattr(mirror, "mirror_psd", counting)
    ref, da = grid(dtype, (16, 256))
    kw = dict(dim=["y", "x"], window="hann", detrend="linear")
    got = xt.power_spectrum(da, **kw)
    single = PROLOGUE_SINGLE["linear"][dtype]
    assert calls == [torch.complex64 if single else torch.complex128]
    held(got, xrft_tpu.power_spectrum(ref, **kw), single)


# ---------------------------------------------------------------------------
# the LabeledArray surface that xrft_tpu has
# ---------------------------------------------------------------------------


def surface_pair():
    rng = np.random.default_rng(40)
    x = rng.standard_normal((3, 5))
    x[1, 2] = np.nan
    return pair(x, ("a", "b"), coords={"a": np.array([0.0, np.nan, 2.0]),
                                       "b": np.arange(5) * 0.5,
                                       "c": (("b",), np.arange(5.0))},
                name="v", attrs={"units": "m"})


def mask_like(da):
    """A bool LabeledArray along b, in ``da``'s package."""
    mask = np.array([True, False, True, True, False])
    if isinstance(da, xt.LabeledArray):
        return xt.LabeledArray(torch.as_tensor(mask), dims=("b",))
    return xrft_tpu.LabeledArray(mask, dims=("b",))


SURFACE = {
    "max": lambda d: d.max("b"), "min": lambda d: d.min(),
    "std": lambda d: d.std("a"), "var": lambda d: d.var(["a", "b"]),
    "median": lambda d: d.median("b"), "real": lambda d: d.real,
    "imag": lambda d: d.imag, "abs": lambda d: abs(d), "neg": lambda d: -d,
    "astype": lambda d: d.astype(np.float32), "fillna": lambda d: d.fillna(7),
    "rename": lambda d: d.rename("w"), "drop_vars": lambda d: d.drop_vars("c"),
    "sel": lambda d: d.sel(b=[0.5, 1.5]),
    "sel_nearest": lambda d: d.sel(b=1.1, method="nearest"),
    "where": lambda d: d.where(mask_like(d)),
    "dropna_a": lambda d: d.dropna("a"), "dropna_b": lambda d: d.dropna("b"),
}


@pytest.mark.parametrize("name", sorted(SURFACE))
def test_labeled_array_methods_of_the_reference(name):
    ref, da = surface_pair()
    fn = SURFACE[name]
    want, got = fn(ref), fn(da)
    assert got.values.dtype == np.asarray(want.values).dtype
    assert_same(got, want, 2e-6 if name == "astype" else 1e-12)


def test_labeled_array_accessors_of_the_reference():
    ref, da = surface_pair()
    assert (da.ndim, da.size, len(da)) == (ref.ndim, ref.size, len(ref))
    npt.assert_array_equal(np.asarray(da), np.asarray(ref))
    assert da.isel(a=0, b=0).item() == ref.isel(a=0, b=0).item()
    c, rc = da["c"], ref["c"]
    assert (c.size, c.dtype, len(c), c.max(), c.min(), c[1]) == \
        (rc.size, rc.dtype, len(rc), rc.max(), rc.min(), rc[1])
    npt.assert_array_equal(np.asarray(c), np.asarray(rc))
    with pytest.raises(KeyError, match="no coordinate 'z'"):
        da["z"]
    with pytest.raises(TypeError, match="positional indexing"):
        da[0]
