"""The scipy-namesake estimators of xrft_tpu_torch (welch, csd,
periodogram, spectrogram, coherence), pad/unpad and the hp segments,
against xrft_tpu on the CPU, each under ``fft_impl="torch"`` and
``"matmul"`` (xrft_tpu's ``fft_engine("xla")`` and ``("matmul")``).

Tolerances, relative to the largest |value|: 1e-12 in float64, 2e-6 in
float32.
"""

import warnings

import numpy as np
import numpy.testing as npt
import pytest

torch = pytest.importorskip("torch")

import xrft_tpu
import xrft_tpu_torch as xt
from xrft_tpu_torch.config import fft_impl
from xrft_tpu_torch.interop import from_reference

TOL = {np.float32: 2e-6, np.float64: 1e-12}
ENGINES = {"torch": "xla", "matmul": "matmul"}


def _series(n=1000, dtype=np.float64, seed=0, name="sig", t=None):
    rng = np.random.RandomState(seed)
    t = np.arange(n) * 0.01 if t is None else t
    ref = xrft_tpu.LabeledArray(
        (rng.randn(3, n) + np.sin(2 * np.pi * 7.0 * np.arange(n) * 0.01))
        .astype(dtype), dims=("time", "t"),
        coords={"time": np.arange(3.0), "t": t}, name=name)
    return ref, from_reference(ref, device="cpu")


def assert_same(got, ref, tol):
    """Same dims, name, attrs, coordinates (dims, values, attrs) and values
    to ``tol`` of the largest |value|."""
    assert tuple(got.dims) == tuple(ref.dims)
    assert got.name == ref.name
    assert dict(got.attrs) == dict(ref.attrs)
    assert set(got.coords) == set(ref.coords)
    for c in ref.coords:
        assert tuple(got.coords[c].dims) == tuple(ref.coords[c].dims)
        npt.assert_array_equal(got.coords[c].values, ref.coords[c].values)
        assert got.coords[c].attrs.keys() == ref.coords[c].attrs.keys()
        for k, v in ref.coords[c].attrs.items():
            npt.assert_array_equal(got.coords[c].attrs[k], v)
    r = np.asarray(ref.values)
    g = got.values
    assert g.shape == r.shape and g.dtype.kind == r.dtype.kind
    assert np.abs(g - r).max() <= tol * np.abs(r).max()


def _both(impl, ref_fn, port_fn):
    """(port result, reference result) under one engine, warnings kept
    apart and compared."""
    with warnings.catch_warnings(record=True) as w_ref:
        warnings.simplefilter("always")
        with xrft_tpu.fft_engine(ENGINES[impl]):
            want = ref_fn()
    with warnings.catch_warnings(record=True) as w_got:
        warnings.simplefilter("always")
        with fft_impl(impl):
            got = port_fn()
    assert [str(w.message) for w in w_got] == \
        [str(w.message) for w in w_ref]
    return got, want


WELCH = {
    "default": dict(seglen=128),
    "seglen256": dict(seglen=256, segment_overlap=0.25),
    "no_overlap_tail": dict(seglen=96, segment_overlap=0),
    "spectrum": dict(seglen=64, scaling="spectrum", detrend="linear"),
    "two_sided": dict(seglen=128, real_dim=None),
    "too_long": dict(seglen=2048),
}


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
@pytest.mark.parametrize("impl", ["torch", "matmul"])
@pytest.mark.parametrize("case", sorted(WELCH))
def test_welch_matches_reference(case, impl, dtype):
    ref, da = _series(dtype=dtype, seed=len(case))
    kw = WELCH[case]
    if case == "too_long" and impl == "matmul":
        kw = dict(seglen=1024)  # the 1000-point clamp has factor 125
        ref, da = _series(n=800, dtype=dtype)
    got, want = _both(impl, lambda: xrft_tpu.welch(ref, dim="t", **kw),
                      lambda: xt.welch(da, dim="t", **kw))
    assert_same(got, want, TOL[dtype])


@pytest.mark.parametrize("impl", ["torch", "matmul"])
@pytest.mark.parametrize("n2", [1000, 900])
def test_csd_and_coherence_match_reference(impl, n2):
    r1, d1 = _series(seed=1, name="a")
    r2, d2 = _series(n=n2, seed=2, name="b")
    got, want = _both(impl,
                      lambda: xrft_tpu.csd(r1, r2, dim="t", seglen=128),
                      lambda: xt.csd(d1, d2, dim="t", seglen=128))
    assert_same(got, want, TOL[np.float64])
    if n2 != 1000:
        return
    kw = dict(dim="t", chunks_to_segments=True, segment_overlap=0.5,
              real_dim="t")
    got, want = _both(
        impl,
        lambda: xrft_tpu.coherence(r1.chunk({"t": 128}),
                                   r2.chunk({"t": 128}), **kw),
        lambda: xt.coherence(d1.chunk({"t": 128}), d2.chunk({"t": 128}),
                             **kw))
    assert_same(got, want, TOL[np.float64])


@pytest.mark.parametrize("impl", ["torch", "matmul"])
@pytest.mark.parametrize("kw", [dict(), dict(window="hann"),
                                dict(detrend=False, scaling="spectrum")])
def test_periodogram_matches_reference(impl, kw):
    ref, da = _series(n=256)
    got, want = _both(impl, lambda: xrft_tpu.periodogram(ref, dim="t", **kw),
                      lambda: xt.periodogram(da, dim="t", **kw))
    assert_same(got, want, TOL[np.float64])


@pytest.mark.parametrize("impl", ["torch", "matmul"])
@pytest.mark.parametrize("coord", ["numeric", "datetime64", "decreasing"])
def test_spectrogram_matches_reference(impl, coord):
    n = 1000
    t = {"numeric": np.arange(n) * 0.01,
         "datetime64": np.datetime64("2000-01-01T00:00:00")
         + np.arange(n) * np.timedelta64(10, "ms"),
         "decreasing": np.arange(n)[::-1] * 0.01}[coord]
    ref, da = _series(n=n, t=t)
    kw = dict(dim="t", seglen=128)
    got, want = _both(impl, lambda: xrft_tpu.spectrogram(ref, **kw),
                      lambda: xt.spectrogram(da, **kw))
    assert_same(got, want, TOL[np.float64])


@pytest.mark.parametrize("impl", ["torch", "matmul"])
def test_hp_segments_match_reference(impl):
    """hp Welch and the hp segmented power and cross spectra in float64."""
    r1, d1 = _series(seed=3, name="a")
    r2, d2 = _series(seed=4, name="b")
    got, want = _both(
        impl, lambda: xrft_tpu.welch(r1, dim="t", seglen=128, engine="hp"),
        lambda: xt.welch(d1, dim="t", seglen=128, engine="hp"))
    assert got.dtype == torch.float64
    assert_same(got, want, TOL[np.float64])
    kw = dict(dim="t", real_dim="t", chunks_to_segments=True,
              segment_overlap=0.5, window="hann", window_correction=True,
              engine="hp")
    c1, c2 = r1.chunk({"t": 128}), r2.chunk({"t": 128})
    e1, e2 = d1.chunk({"t": 128}), d2.chunk({"t": 128})
    got, want = _both(impl, lambda: xrft_tpu.power_spectrum(c1, **kw),
                      lambda: xt.power_spectrum(e1, **kw))
    assert_same(got, want, TOL[np.float64])
    got, want = _both(impl, lambda: xrft_tpu.cross_spectrum(c1, c2, **kw),
                      lambda: xt.cross_spectrum(e1, e2, **kw))
    assert_same(got, want, TOL[np.float64])


PADS = {
    "constant": (dict(t=(3, 5)), dict()),
    "constant_value": (dict(t=4), dict(constant_values=1.5)),
    "reflect": (dict(t=(2, 6)), dict(mode="reflect")),
    "edge_2d": (dict(t=3, time=1), dict(mode="edge")),
    "reflect_wide": (dict(t=(50, 1)), dict(mode="reflect")),
    "symmetric_2d": (dict(t=(4, 2), time=2), dict(mode="symmetric")),
    "wrap": (dict(t=(45, 3)), dict(mode="wrap")),
    "constant_per_dim": (dict(t=2, time=1),
                         dict(constant_values=dict(t=(1.0, 2.0), time=-3.0))),
    "reflect_odd": (dict(t=3), dict(mode="reflect", reflect_type="odd")),
    "linear_ramp": (dict(t=(2, 3)), dict(mode="linear_ramp",
                                         end_values=dict(t=(1.0, 2.0)))),
    "mean": (dict(t=4), dict(mode="mean", stat_length=dict(t=5))),
}


@pytest.mark.parametrize("case", sorted(PADS))
def test_pad_unpad_match_reference(case):
    ref, da = _series(n=40)
    widths, kw = PADS[case]
    want = xrft_tpu.pad(ref, widths, **kw)
    got = xt.pad(da, widths, **kw)
    # the modes that compute new values round as numpy, not as XLA
    tol = TOL[np.float64] if kw.get("mode") in ("linear_ramp", "mean") \
        else 0.0
    assert_same(got, want, tol)
    assert_same(xt.unpad(got), xrft_tpu.unpad(want), tol)
    assert_same(xt.unpad(got, widths), xrft_tpu.unpad(want, widths), tol)
    with pytest.raises(ValueError, match="not a padded one|doesn't seem"):
        xt.unpad(da)


def _meta_series():
    """A series whose data lie on no CPU: the meta device stands in for the
    card."""
    return xt.LabeledArray(torch.empty((3, 40), device="meta"),
                           dims=("time", "t"),
                           coords={"t": np.arange(40) * 0.01})


@pytest.mark.parametrize("mode", ["constant", "edge", "reflect", "symmetric",
                                  "wrap"])
def test_pad_device_modes_stay_on_the_device(mode):
    got = xt.pad(_meta_series(), dict(t=(2, 3)), mode=mode)
    assert got.data.device.type == "meta" and got.shape == (3, 45)


@pytest.mark.parametrize("mode,kw", [
    ("linear_ramp", {}), ("linear_ramp", dict(end_values=dict(t=(1.0, 2.0)))),
    ("mean", {}), ("median", dict(stat_length=3)), ("maximum", {}),
    ("minimum", dict(stat_length=dict(t=(2, 5)))),
    ("reflect", dict(reflect_type="odd")),
    ("symmetric", dict(reflect_type="odd")),
])
def test_pad_computed_modes_stay_on_the_device(mode, kw):
    """The modes that compute new values pad on the data's device too (the
    meta device stands in for the card): no host round trip, no raise."""
    got = xt.pad(_meta_series(), dict(t=(2, 45)), mode=mode, **kw)
    assert got.data.device.type == "meta" and got.shape == (3, 87)


# the modes numpy computes, each on 1-D and 2-D widths: (pad_width, the
# port's and xrft_tpu's keywords, numpy.pad's keywords on (time, t))
COMPUTED_PADS = {
    "ramp": (dict(t=(3, 5)), dict(mode="linear_ramp"), {}),
    "ramp_ends": (dict(t=(4, 2)),
                  dict(mode="linear_ramp", end_values=dict(t=(1.5, -2.0))),
                  dict(end_values=((0, 0), (1.5, -2.0)))),
    "ramp_2d": (dict(t=(3, 6), time=(1, 2)),
                dict(mode="linear_ramp", end_values=0.5),
                dict(end_values=0.5)),
    "maximum": (dict(t=(2, 3)), dict(mode="maximum", stat_length=4),
                dict(stat_length=4)),
    "minimum_2d": (dict(t=3, time=(2, 1)), dict(mode="minimum"), {}),
    "mean_2d": (dict(t=(4, 1), time=1),
                dict(mode="mean", stat_length=dict(t=(3, 7), time=2)),
                dict(stat_length=((2, 2), (3, 7)))),
    "median": (dict(t=(5, 2)), dict(mode="median", stat_length=dict(t=6)),
               dict(stat_length=((3, 3), (6, 6)))),
    "median_2d": (dict(t=2, time=(1, 3)), dict(mode="median"), {}),
    "reflect_odd_wide": (dict(t=(90, 7)),
                         dict(mode="reflect", reflect_type="odd"),
                         dict(reflect_type="odd")),
    "symmetric_odd_2d": (dict(t=(3, 50), time=2),
                         dict(mode="symmetric", reflect_type="odd"),
                         dict(reflect_type="odd")),
}


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("case", sorted(COMPUTED_PADS))
def test_pad_computed_modes_match_reference_and_numpy(case, dtype):
    """Held to xrft_tpu.pad (jnp.pad, XLA's arithmetic) at TOL of max: a
    ramp, a mean or a median may round apart from XLA's.  Held to numpy.pad
    (whose steps the port repeats) bit for bit, except the mean, whose sum
    numpy takes in another order: 1e-12 in float64, 2e-6 in float32."""
    ref, da = _series(n=40, dtype=dtype)
    widths, kw, np_kw = COMPUTED_PADS[case]
    got = xt.pad(da, widths, **kw)
    want_ref = xrft_tpu.pad(ref, widths, **kw)
    assert_same(got, want_ref, TOL[dtype])
    np_widths = [widths.get(d, 0) for d in da.dims]
    np_widths = [(w, w) if isinstance(w, int) else w for w in np_widths]
    want = np.pad(da.values, np_widths, mode=kw["mode"], **np_kw)
    assert got.values.dtype == want.dtype
    if kw["mode"] == "mean":
        npt.assert_allclose(got.values, want, rtol=0,
                            atol=TOL[dtype] * np.abs(want).max())
    else:
        npt.assert_array_equal(got.values, want)
    assert_same(xt.unpad(got), xrft_tpu.unpad(want_ref), TOL[dtype])


@pytest.mark.parametrize("mode", ["mean", "median", "linear_ramp"])
def test_pad_rounds_integer_data_as_numpy(mode):
    """Integer data: the mean and median round half to even, the ramp
    floors, as numpy.pad does."""
    x = np.array([[1, 2, 4, 7, 8], [0, -3, 5, 2, 9]], dtype=np.int32)
    da = xt.LabeledArray(torch.as_tensor(x), dims=("time", "t"),
                         coords={"t": np.arange(5) * 0.5})
    kw = dict(end_values=dict(t=(-7, 3))) if mode == "linear_ramp" else {}
    got = xt.pad(da, dict(t=(3, 4)), mode=mode, **kw)
    np_kw = dict(end_values=((0, 0), (-7, 3))) if kw else {}
    want = np.pad(x, ((0, 0), (3, 4)), mode=mode, **np_kw)
    assert got.data.dtype == torch.int32
    npt.assert_array_equal(got.values, want)
