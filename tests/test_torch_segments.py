"""Welch segmenting in xrft_tpu_torch against xrft_tpu on the CPU:
``chunk``/``isel``, the segment plan and stack, ``fft(...,
chunks_to_segments=True)`` and the segmented power and cross spectra, with
integer and fractional overlap: dims, coordinates with their attrs, attrs,
name, values, warnings and errors.

Tolerances, relative to the largest |value|: 1e-12 in float64, 2e-6 in
float32 (the reference promotes float32 through its float64 window).
"""

import warnings

import numpy as np
import numpy.testing as npt
import pytest

torch = pytest.importorskip("torch")

import xrft_tpu
from xrft_tpu import transform as ref_tr
import xrft_tpu_torch as xt
from xrft_tpu_torch import transform as tr
from xrft_tpu_torch.interop import from_reference

TOL = {np.float32: 2e-6, np.float64: 1e-12}


def _pair(shape=(3, 24, 40), dtype=np.float64, seed=0, name="eta",
          chunks=None):
    rng = np.random.RandomState(seed)
    ref = xrft_tpu.LabeledArray(
        rng.randn(*shape).astype(dtype), dims=("time", "y", "x"),
        coords={"time": np.arange(shape[0], dtype=np.float64),
                "y": np.arange(shape[1]) * 0.5,
                "x": np.arange(shape[2]) * 0.25 + 3.0},
        attrs={"units": "m"}, name=name)
    if chunks:
        ref = ref.chunk(chunks)
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


def test_chunk_and_isel_match_reference():
    ref, da = _pair()
    for kw in ({"x": 8}, {"x": 8, "y": 6}):
        assert da.chunk(kw).chunks == ref.chunk(kw).chunks
    with pytest.raises(ValueError, match="chunk dim"):
        da.chunk({"z": 3})
    got = da.chunk(x=8).isel(x=slice(2, 30), time=1)
    want = ref.chunk(x=8).isel(x=slice(2, 30), time=1)
    assert_same(got, want, 0.0)
    assert_same(da.isel(y=[0, 3, 5]), ref.isel(y=[0, 3, 5]), 0.0)
    # declared chunks survive arithmetic, as dask chunks do
    assert (da.chunk(x=8) * 2.0).chunks == (ref.chunk(x=8) * 2.0).chunks
    w = xt.LabeledArray(np.ones(40), dims=("x",), device="cpu")
    w_ref = xrft_tpu.LabeledArray(np.ones(40), dims=("x",))
    assert (da.chunk(x=8) * w).attrs == (ref.chunk(x=8) * w_ref).attrs


@pytest.mark.parametrize("overlap", [None, 3, 0.5, {"x": 2}])
@pytest.mark.parametrize("dims", [["x"], ["y", "x"]])
def test_stack_segments_matches_reference(dims, overlap):
    ref, da = _pair(chunks={"x": 8, "y": 6})
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        want = ref_tr._stack_segments(ref, dims, overlap=overlap)
        got = tr._stack_segments(da, dims, overlap=overlap)
        plan = tr._segment_plan(da, dims, overlap=overlap)
        ref_plan = ref_tr._segment_plan(ref, dims, overlap=overlap)
    assert plan[0] == ref_plan[0] and plan[1] == ref_plan[1]
    assert plan[3] == ref_plan[3]
    assert_same(got, want, 0.0)
    if overlap is not None:
        assert got.data.is_contiguous()


def test_segment_warnings_and_errors():
    ref, da = _pair(chunks={"x": 16})
    for pkg, arr in ((ref_tr, ref), (tr, da)):
        with pytest.warns(UserWarning, match="drops the last 4 samples"):
            pkg._segment_plan(arr, ["x"], overlap=6)
        with pytest.raises(ValueError, match="must be in \\[0, seglen=16\\)"):
            pkg._segment_plan(arr, ["x"], overlap=16)
        with pytest.raises(ValueError, match="fractional segment_overlap"):
            pkg._segment_plan(arr, ["x"], overlap=1.5)
        with pytest.raises(ValueError, match="non-transform dims"):
            pkg._segment_plan(arr, ["x"], overlap={"y": 2})
    ref7, da7 = _pair(chunks={"x": 7})
    for pkg, arr in ((xrft_tpu, ref7), (xt, da7)):
        with pytest.raises(ValueError, match="Chunk lengths need to be the "
                                             "same."):
            pkg.fft(arr, dim="x", chunks_to_segments=True)
    for pkg, arr in ((xrft_tpu, ref), (xt, da)):
        with pytest.raises(ValueError, match="requires chunks_to_segments"):
            pkg.fft(arr, dim="x", segment_overlap=2)


FFT_CASES = {
    "plain": dict(dim="x"),
    "overlap": dict(dim="x", segment_overlap=4),
    "real": dict(dim=["y", "x"], real_dim="x", segment_overlap=0.25),
    "window_detrend": dict(dim=["y", "x"], window="hann", detrend="linear"),
}


@pytest.mark.parametrize("case", sorted(FFT_CASES))
def test_fft_segments_match_reference(case):
    ref, da = _pair(chunks={"x": 8, "y": 12})
    kw = dict(FFT_CASES[case], chunks_to_segments=True)
    want = xrft_tpu.fft(ref, **kw)
    got = xt.fft(da, **kw)
    assert_same(got, want, TOL[np.float64])


def test_ifft_segments_match_reference():
    """Segments of a frequency axis whose first segment is centred on zero
    (each segment takes the first one's coordinate)."""
    rng = np.random.RandomState(5)
    z = rng.randn(2, 32) + 1j * rng.randn(2, 32)
    ref = xrft_tpu.LabeledArray(
        z, dims=("time", "f"), coords={"f": (np.arange(32) - 8) * 0.5},
        name="z").chunk({"f": 16})
    da = from_reference(ref, device="cpu").chunk({"f": 16})
    for kw in (dict(lag=0.0), dict(lag=1.5, true_amplitude=False)):
        kw.update(dim="f", chunks_to_segments=True)
        assert_same(xt.ifft(da, **kw), xrft_tpu.ifft(ref, **kw),
                    TOL[np.float64])
        assert_same(xt.ifft(da, engine="hp", **kw),
                    xrft_tpu.ifft(ref, engine="hp", **kw), TOL[np.float64])


PSD_CASES = {
    "1d": dict(dim="x"),
    "1d_int_overlap": dict(dim="x", segment_overlap=4),
    "1d_real": dict(dim="x", real_dim="x", segment_overlap=0.5,
                    window="hann", window_correction=True),
    "2d": dict(dim=["y", "x"], window="hann", detrend="linear"),
    "2d_overlap": dict(dim=["y", "x"], segment_overlap=0.5,
                       scaling="spectrum"),
}


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
@pytest.mark.parametrize("case", sorted(PSD_CASES))
def test_power_spectrum_segments_match_reference(case, dtype):
    ref, da = _pair(dtype=dtype, chunks={"x": 8, "y": 12}, seed=len(case))
    kw = dict(PSD_CASES[case], chunks_to_segments=True)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        want = xrft_tpu.power_spectrum(ref, **kw)
        got = xt.power_spectrum(da, **kw)
    assert_same(got, want, TOL[dtype])


@pytest.mark.parametrize("case", sorted(PSD_CASES))
def test_cross_spectrum_segments_match_reference(case):
    r1, d1 = _pair(chunks={"x": 8, "y": 12}, seed=1)
    r2, d2 = _pair(chunks={"x": 8, "y": 12}, seed=2, name="u")
    kw = dict(PSD_CASES[case], chunks_to_segments=True)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        want = xrft_tpu.cross_spectrum(r1, r2, **kw)
        got = xt.cross_spectrum(d1, d2, **kw)
    assert_same(got, want, TOL[np.float64])
