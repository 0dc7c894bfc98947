"""The ported isotropic-spectrum slice against xrft_tpu on the CPU:
``isotropize``, ``isotropic_power_spectrum``, ``isotropic_cross_spectrum``,
``fit_loglog``, and the ``cross_spectrum``/``cross_phase`` under them.

Tolerances, relative to max|value|: 1e-12 for float64, 2e-6 for float32.
Every coordinate is compared exactly: ``freq_r`` must equal the reference's
bit for bit, NaN positions included.  Each isotropic case runs under both
``binned_sum_impl`` values (on the CPU both reach K3's plain version).
"""

import warnings

import numpy as np
import numpy.testing as npt
import pytest

torch = pytest.importorskip("torch")

import xrft_tpu
import xrft_tpu_torch as xt
from xrft_tpu_torch.config import binned_sum_impl
from xrft_tpu_torch.interop import from_reference
from xrft_tpu_torch.spectra import coherence

TOL = {np.float32: 2e-6, np.float64: 1e-12}
IMPLS = ["kernel", "plain"]


def _ref(shape, dtype=np.float64, seed=0, dims=("time", "y", "x"),
         name="eta", decreasing=()):
    rng = np.random.RandomState(seed)
    coords = {}
    for i, (d, n) in enumerate(zip(dims, shape)):
        c = np.arange(n) * (0.5 + 0.25 * i) + 1.0
        coords[d] = c[::-1] if d in decreasing else c
    data = rng.randn(*shape)
    if np.dtype(dtype).kind == "c":
        data = data + 1j * rng.randn(*shape)
    return xrft_tpu.LabeledArray(data.astype(dtype), dims=dims,
                                 coords=coords, name=name)


def _assert_matches(got, ref, tol):
    assert tuple(got.dims) == tuple(ref.dims)
    assert got.name == ref.name
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


ISO_CASES = {
    "2d": (((3, 40, 34), ("time", "y", "x")), ["freq_y", "freq_x"], {}),
    "2d_nfactor2": (((3, 40, 34), ("time", "y", "x")), ["freq_y", "freq_x"],
                    dict(nfactor=2)),
    "2d_reversed_fftdim": (((3, 41, 33), ("time", "y", "x")),
                           ["freq_x", "freq_y"], {}),
    "2d_no_batch": (((48, 48), ("y", "x")), ["freq_y", "freq_x"], {}),
    "3d_shells": (((2, 12, 14, 10), ("b", "z", "y", "x")),
                  ["freq_z", "freq_y", "freq_x"], {}),
    "extra_dims": (((2, 3, 16, 32), ("time", "z", "y", "x")),
                   ["freq_y", "freq_x"], {}),
}


@pytest.mark.parametrize("impl", IMPLS)
@pytest.mark.parametrize("truncate", [True, False])
@pytest.mark.parametrize("dtype", [np.float64, np.float32])
@pytest.mark.parametrize("case", sorted(ISO_CASES))
def test_isotropize_matches_reference(case, dtype, truncate, impl):
    (shape, dims), fftdim, kw = ISO_CASES[case]
    ps_ref = xrft_tpu.power_spectrum(_ref(shape, dtype, dims=dims),
                                     dim=[d[5:] for d in fftdim])
    ps = from_reference(ps_ref, device="cpu")
    ctx = pytest.warns(FutureWarning, match="Nyquist") if not truncate \
        else warnings.catch_warnings()
    with ctx:
        ref = xrft_tpu.isotropize(ps_ref, fftdim, truncate=truncate, **kw)
    ctx = pytest.warns(FutureWarning, match="Nyquist") if not truncate \
        else warnings.catch_warnings()
    with ctx, binned_sum_impl(impl):
        got = xt.isotropize(ps, fftdim, truncate=truncate, **kw)
    assert got.dims[-1] == "freq_r"
    assert np.isnan(got.coords["freq_r"].values).any() == truncate
    _assert_matches(got, ref, TOL[dtype])


def test_isotropize_keeps_extra_coords_and_non_trailing_dims():
    ref_in = xrft_tpu.LabeledArray(
        np.random.RandomState(3).rand(2, 5, 16, 24),
        dims=("time", "z", "y", "x"),
        coords={"time": np.array(["2019-04-18", "2019-04-19"],
                                 dtype="datetime64[ns]"),
                "z": np.arange(5), "y": np.arange(16), "x": np.arange(24)})
    ps_ref = xrft_tpu.power_spectrum(ref_in, dim=["y", "x"])
    # the transform dims interleaved with a batch dim: data are reordered
    ps_ref = ps_ref.transpose("freq_y", "time", "freq_x", "z")
    ref = xrft_tpu.isotropize(ps_ref, ["freq_y", "freq_x"])
    got = xt.isotropize(from_reference(ps_ref, device="cpu"), ["freq_y", "freq_x"])
    assert got.dims == ("time", "z", "freq_r")
    _assert_matches(got, ref, TOL[np.float64])


def test_isotropize_complex_keeps_or_drops_imaginary_part():
    cs_ref = xrft_tpu.cross_spectrum(_ref((2, 24, 20), seed=1),
                                     _ref((2, 24, 20), seed=2),
                                     dim=["y", "x"])
    cs = from_reference(cs_ref, device="cpu")
    for complx in (True, False):
        ref = xrft_tpu.isotropize(cs_ref, ["freq_y", "freq_x"],
                                  complx=complx)
        got = xt.isotropize(cs, ["freq_y", "freq_x"], complx=complx)
        assert got.data.is_complex() == complx
        _assert_matches(got, ref, TOL[np.float64])


def test_radial_plan_is_cached_per_grid():
    from xrft_tpu_torch.isotropic import _radial_plan

    ps = xt.power_spectrum(from_reference(_ref((2, 20, 18), seed=4), device="cpu"),
                           dim=["y", "x"])
    _radial_plan.cache_clear()
    a = xt.isotropize(ps, ["freq_y", "freq_x"])
    b = xt.isotropize(ps * 2.0, ["freq_y", "freq_x"])
    assert _radial_plan.cache_info().hits == 1
    npt.assert_allclose(b.values, 2.0 * a.values, rtol=1e-15)
    xt.isotropize(ps, ["freq_y", "freq_x"], nfactor=2)
    assert _radial_plan.cache_info().misses == 2


MAIN = dict(dim=["y", "x"], window="hann", detrend="linear", truncate=True)


@pytest.mark.parametrize("impl", IMPLS)
@pytest.mark.parametrize("scaling", ["density", "spectrum"])
@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_isotropic_power_spectrum_entry_shape(dtype, scaling, impl):
    """The slice's call at the entry shape (4, 256, 256)."""
    ref_in = _ref((4, 256, 256), dtype)
    ref = xrft_tpu.isotropic_power_spectrum(ref_in, scaling=scaling, **MAIN)
    with binned_sum_impl(impl):
        got = xt.isotropic_power_spectrum(from_reference(ref_in, device="cpu"),
                                          scaling=scaling, **MAIN)
    assert got.dims == ("time", "freq_r") and got.shape == (4, 64)
    assert got.dtype == torch.as_tensor(np.zeros(0, dtype)).dtype
    _assert_matches(got, ref, TOL[dtype])


@pytest.mark.parametrize("kw", [
    dict(dim=["y", "x"]),                              # truncate=False warns
    dict(dim=["y", "x"], density=False),
    dict(dim=["y", "x"], shift=False, detrend="constant"),
    dict(dim=["y", "x"], window="hann", window_correction=True),
    dict(dim=None, window="hann"),
])
def test_isotropic_power_spectrum_options(kw):
    ref_in = _ref((24, 20), dims=("y", "x"), seed=5)
    with pytest.warns(FutureWarning, match="Nyquist"):
        ref = xrft_tpu.isotropic_power_spectrum(ref_in, **kw)
    with pytest.warns(FutureWarning, match="Nyquist"):
        got = xt.isotropic_power_spectrum(from_reference(ref_in, device="cpu"), **kw)
    _assert_matches(got, ref, TOL[np.float64])


def test_isotropic_spectra_require_2d():
    da = xt.LabeledArray(np.random.rand(8), dims=("x",),
                         coords={"x": np.arange(8.0)}, device="cpu")
    with pytest.raises(ValueError, match="two dimensional"):
        xt.isotropic_power_spectrum(da, dim=["x"])
    with pytest.raises(ValueError, match="two dimensional"):
        xt.isotropic_cross_spectrum(da, da, dim=["x"])


@pytest.mark.parametrize("impl", IMPLS)
@pytest.mark.parametrize("dtype", [np.float64, np.float32])
def test_isotropic_cross_spectrum_matches_reference(dtype, impl):
    r1 = _ref((3, 40, 34), dtype, seed=1)
    r2 = _ref((3, 40, 34), dtype, seed=2)
    ref = xrft_tpu.isotropic_cross_spectrum(r1, r2, **MAIN)
    p1, p2 = from_reference(r1, device="cpu"), from_reference(r2, device="cpu")
    with binned_sum_impl(impl):
        got = xt.isotropic_cross_spectrum(p1, p2, **MAIN)
        self_cs = xt.isotropic_cross_spectrum(p1, p1, **MAIN)
        iso_ps = xt.isotropic_power_spectrum(p1, **MAIN)
    assert got.data.is_complex()
    _assert_matches(got, ref, TOL[dtype])
    # the self cross spectrum is the power spectrum after isotropization
    r = iso_ps.values
    assert np.abs(self_cs.values.real - r).max() <= TOL[dtype] * r.max()


def test_isotropic_cross_spectrum_rejects_different_dims():
    da1 = xt.LabeledArray(np.zeros((8, 8)), dims=("y", "x"), device="cpu")
    da3 = xt.LabeledArray(np.zeros((8, 8)), dims=("y", "z"), device="cpu")
    with pytest.raises(ValueError, match="different dimensions"):
        xt.isotropic_cross_spectrum(da1, da3)


def test_fit_loglog_matches_reference():
    x = np.array([1.0, 2.0, 4.0, 8.0, 16.0])
    y = 3.0 * x ** -2.0 * (1 + 0.01 * np.arange(5))
    for a, b in zip(xt.fit_loglog(x, y), xrft_tpu.fit_loglog(x, y)):
        npt.assert_array_equal(a, b)
    _, slope, _ = xt.fit_loglog(x, 3.0 * x ** -2.0)
    npt.assert_allclose(slope, -2.0, atol=1e-12)


CROSS = {
    "main": ((3, 24, 20), dict(dim=["y", "x"], window="hann",
                               detrend="linear")),
    "odd": ((3, 25, 19), dict(dim=["y", "x"])),
    "no_true_phase": ((3, 24, 20), dict(dim=["y", "x"], true_phase=False)),
    "odd_no_true_phase": ((2, 25, 19), dict(dim=["y", "x"],
                                            true_phase=False)),
    "real_dim": ((3, 24, 20), dict(dim=["y", "x"], real_dim="x")),
    "real_dim_odd": ((3, 25, 19), dict(dim=["y", "x"], real_dim="x")),
    "no_shift": ((3, 24, 20), dict(dim=["y", "x"], shift=False)),
    "odd_no_shift": ((3, 25, 19), dict(dim=["y", "x"], shift=False)),
    "three_dims": ((4, 6, 10), dict(dim=None)),
    "non_trailing": ((4, 24, 20), dict(dim=["time", "x"])),
    "one_dim": ((3, 24, 20), dict(dim="x", window="hann")),
    "window_correction": ((3, 24, 20), dict(dim=["y", "x"], window="hann",
                                            window_correction=True)),
    "spectrum_window_correction": (
        (3, 24, 20), dict(dim=["y", "x"], window="hann", scaling="spectrum",
                          window_correction=True)),
    "false_density": ((3, 24, 20), dict(dim=["y", "x"],
                                        scaling="false_density")),
}


@pytest.mark.parametrize("decreasing", [(), ("y",)])
@pytest.mark.parametrize("variant", sorted(CROSS))
def test_cross_spectrum_matches_reference(variant, decreasing):
    shape, kw = CROSS[variant]
    r1 = _ref(shape, seed=len(variant), decreasing=decreasing)
    r2 = _ref(shape, seed=len(variant) + 1, decreasing=decreasing)
    ref = xrft_tpu.cross_spectrum(r1, r2, **kw)
    got = xt.cross_spectrum(from_reference(r1, device="cpu"), from_reference(r2, device="cpu"), **kw)
    assert got.name is None
    _assert_matches(got, ref, TOL[np.float64])


@pytest.mark.parametrize("dtype", [np.float32, np.complex128])
def test_cross_spectrum_float32_and_complex_input(dtype):
    kw = CROSS["main"][1]
    r1, r2 = _ref((3, 24, 20), dtype, seed=1), _ref((3, 24, 20), dtype, seed=2)
    ref = xrft_tpu.cross_spectrum(r1, r2, **kw)
    got = xt.cross_spectrum(from_reference(r1, device="cpu"), from_reference(r2, device="cpu"), **kw)
    _assert_matches(got, ref, TOL[np.float32 if dtype == np.float32
                                  else np.float64])


def test_cross_spectrum_errors_and_flags():
    r1 = _ref((3, 24, 20), seed=1)
    r3 = _ref((3, 24, 20), seed=2, dims=("time", "y", "z"))
    with pytest.raises(ValueError, match="different dimensions"):
        xt.cross_spectrum(from_reference(r1, device="cpu"), from_reference(r3, device="cpu"))
    with pytest.warns(FutureWarning, match="density flag"):
        ref = xrft_tpu.cross_spectrum(r1, r1, dim=["y", "x"], density=False)
    with pytest.warns(FutureWarning, match="density flag"):
        got = xt.cross_spectrum(from_reference(r1, device="cpu"), from_reference(r1, device="cpu"),
                                dim=["y", "x"], density=False)
    _assert_matches(got, ref, TOL[np.float64])
    with pytest.raises(ValueError, match="requires declared chunks"):
        xt.cross_spectrum(from_reference(r1, device="cpu"),
                          from_reference(r1, device="cpu"), dim="x",
                          chunks_to_segments=True)
    # coherence is ported: without segments it is identically 1, with a
    # warning, in both packages
    with pytest.warns(UserWarning, match="identically 1"):
        ref = xrft_tpu.coherence(r1, r1, dim="x")
    with pytest.warns(UserWarning, match="identically 1"):
        got = coherence(from_reference(r1, device="cpu"),
                        from_reference(r1, device="cpu"), dim="x")
    _assert_matches(got, ref, TOL[np.float64])


@pytest.mark.parametrize("kw", [dict(dim=["y", "x"]),
                                dict(dim=["y", "x"], true_phase=False),
                                dict(dim="x", window="hann")])
def test_cross_phase_matches_reference(kw):
    r1, r2 = _ref((3, 24, 20), seed=1), _ref((3, 24, 20), seed=2, name="u")
    ref = xrft_tpu.cross_phase(r1, r2, **kw)
    got = xt.cross_phase(from_reference(r1, device="cpu"), from_reference(r2, device="cpu"), **kw)
    assert got.name == ref.name == "eta_u_phase"
    assert got.dims == tuple(ref.dims)
    # angles compared on the circle: a real value whose imaginary part is
    # +0 in one package and -0 in the other sits at +pi and -pi
    d = np.angle(np.exp(1j * (got.values - np.asarray(ref.values))))
    assert np.abs(d).max() <= 1e-12


def test_conj_and_complex_values_cross_to_numpy():
    z = xt.LabeledArray(np.array([1 + 2j, 3 - 1j]), dims=("x",), name="z", device="cpu")
    npt.assert_array_equal(z.conj().values, np.array([1 - 2j, 3 + 1j]))
    # imag of a lazy conj view is a lazy negative view
    npt.assert_array_equal(xt.LabeledArray(z.conj().data.imag, ("x",)).values,
                           np.array([-2.0, 1.0]))
    assert z.conj().name == "z"
