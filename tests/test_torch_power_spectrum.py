"""The ported main path, xrft_tpu_torch.power_spectrum (and the fft under
it), held against xrft_tpu on the CPU: dims, coordinates with their attrs,
name and values.

Tolerances, relative to max|P|: 1e-12 for float64 input; 2e-6 for float32
input.  The port keeps float32 data in float32 while the reference under x64
promotes it through its float64 window; at the entry shape the two differ by
~1e-7 of max|P| while single small bins differ by up to ~4e-5 relatively, so
float32 is never compared bin by bin.
"""

import numpy as np
import numpy.testing as npt
import pytest

torch = pytest.importorskip("torch")

import xrft_tpu
import xrft_tpu_torch as xt
from xrft_tpu_torch.config import fft_impl, psd_mirror_impl
from xrft_tpu_torch.interop import from_reference

TOL = {np.float32: 2e-6, np.float64: 1e-12}


def _pair(shape, dtype, seed=0, name="eta"):
    """The same seeded field as an xrft_tpu and an xrft_tpu_torch array."""
    rng = np.random.RandomState(seed)
    dims = ("time", "y", "x")
    coords = {"time": np.arange(shape[0], dtype=np.float64),
              "y": np.arange(shape[1]) * 0.5,
              "x": np.arange(shape[2]) * 0.25 + 3.0}
    ref = xrft_tpu.LabeledArray(rng.randn(*shape).astype(dtype), dims=dims,
                                coords=coords, name=name)
    return ref, from_reference(ref, device="cpu")


def _assert_matches(got, ref, tol):
    assert got.dims == ref.dims
    assert got.name == ref.name
    assert set(got.coords) == set(ref.coords)
    for c in ref.coords:
        npt.assert_array_equal(got.coords[c].values, ref.coords[c].values)
        assert got.coords[c].dims == ref.coords[c].dims
        assert got.coords[c].attrs.keys() == ref.coords[c].attrs.keys()
        for k, v in ref.coords[c].attrs.items():
            npt.assert_array_equal(got.coords[c].attrs[k], v)
    r = np.asarray(ref.values)
    g = got.values
    assert g.shape == r.shape
    assert np.abs(g - r).max() <= tol * np.abs(r).max()


MAIN = dict(dim=["y", "x"], window="hann", detrend="linear")


@pytest.mark.parametrize("mirror_impl", ["kernel", "plain"])
@pytest.mark.parametrize("impl", ["torch", "kernel"])
def test_entry_shape_float32(impl, mirror_impl):
    ref_in, da = _pair((4, 256, 256), np.float32)
    ref = xrft_tpu.power_spectrum(ref_in, **MAIN)
    with fft_impl(impl), psd_mirror_impl(mirror_impl):
        got = xt.power_spectrum(da, **MAIN)
    assert got.dtype == torch.float32
    _assert_matches(got, ref, TOL[np.float32])


@pytest.mark.parametrize("mirror_impl", ["kernel", "plain"])
def test_entry_shape_float64(mirror_impl):
    ref_in, da = _pair((4, 256, 256), np.float64)
    ref = xrft_tpu.power_spectrum(ref_in, **MAIN)
    with psd_mirror_impl(mirror_impl):
        got = xt.power_spectrum(da, **MAIN)
    assert got.dtype == torch.float64
    _assert_matches(got, ref, TOL[np.float64])


def test_kernel_fft_rejects_what_it_cannot_run(monkeypatch):
    """fft_impl="kernel" raises for float32 lengths K2 cannot run; it never
    switches to torch.fft quietly.  float64 data take the K4 recursion and
    match xrft_tpu at 1e-12."""
    from xrft_tpu_torch.ops import dft64

    lengths = []
    real_fft_last = dft64.fft_last

    def counting(x, sign=-1):
        lengths.append(x.shape[-1])
        return real_fft_last(x, sign)

    monkeypatch.setattr(dft64, "fft_last", counting)
    ref_in, da64 = _pair((2, 256, 256), np.float64)
    _, da_small = _pair((2, 64, 300), np.float32)
    with fft_impl("kernel"):
        got = xt.power_spectrum(da64, **MAIN)
        with pytest.raises(ValueError, match="factor pair"):
            xt.power_spectrum(da_small, **MAIN)
    assert lengths == [256, 256]
    assert got.dtype == torch.float64
    _assert_matches(got, xrft_tpu.power_spectrum(ref_in, **MAIN),
                    TOL[np.float64])


VARIANTS = {
    "main": ((4, 24, 20), MAIN),
    "no_shift": ((4, 24, 20), dict(MAIN, shift=False)),
    "odd_sizes": ((3, 45, 33), MAIN),
    "odd_no_shift": ((3, 45, 33), dict(MAIN, shift=False)),
    "detrend_none": ((4, 24, 20), dict(MAIN, detrend=None)),
    "detrend_constant": ((4, 24, 20), dict(MAIN, detrend="constant")),
    "no_window": ((4, 24, 20), dict(MAIN, window=None)),
    "spectrum": ((4, 24, 20), dict(MAIN, scaling="spectrum")),
    "false_density": ((4, 24, 20), dict(MAIN, scaling="false_density")),
    "window_correction": ((4, 24, 20), dict(MAIN, window_correction=True)),
    "spectrum_window_correction": (
        (4, 24, 20), dict(MAIN, scaling="spectrum", window_correction=True)),
    "real_dim": ((4, 24, 20), dict(MAIN, real_dim="x")),
    "real_dim_odd": ((3, 45, 33), dict(MAIN, real_dim="x")),
    "one_dim": ((4, 24, 20), dict(MAIN, dim="x")),
    "non_trailing": ((4, 24, 20), dict(MAIN, dim=["time", "x"])),
    "all_dims": ((4, 24, 20), dict(MAIN, dim=None)),
}


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_variants(variant, dtype):
    shape, kw = VARIANTS[variant]
    ref_in, da = _pair(shape, dtype, seed=len(variant))
    ref = xrft_tpu.power_spectrum(ref_in, **kw)
    for mirror_impl in ("kernel", "plain"):
        with psd_mirror_impl(mirror_impl):
            got = xt.power_spectrum(da, **kw)
        _assert_matches(got, ref, TOL[dtype])


@pytest.mark.parametrize("kw", [MAIN, dict(MAIN, dim="x", shift=False)])
def test_complex_input(kw):
    """Complex fields take the two-sided transform, no Hermitian mirror."""
    ref_in, _ = _pair((3, 24, 20), np.float64, seed=11)
    z = ref_in.values + 1j * ref_in.values[:, ::-1, :]
    ref_in = xrft_tpu.LabeledArray(z, dims=ref_in.dims, coords=ref_in.coords,
                                   name=ref_in.name)
    ref = xrft_tpu.power_spectrum(ref_in, **kw)
    got = xt.power_spectrum(from_reference(ref_in, device="cpu"), **kw)
    _assert_matches(got, ref, TOL[np.float64])


def test_density_flag_deprecation():
    ref_in, da = _pair((4, 24, 20), np.float64)
    with pytest.warns(FutureWarning, match="density flag"):
        ref = xrft_tpu.power_spectrum(ref_in, density=False, **MAIN)
    with pytest.warns(FutureWarning, match="density flag"):
        got = xt.power_spectrum(da, density=False, **MAIN)
    _assert_matches(got, ref, TOL[np.float64])


@pytest.mark.parametrize("kw", [
    dict(dim=["y", "x"]),
    dict(dim=["y", "x"], real_dim="x", shift=False),
    dict(dim="x", detrend="linear", window="hann"),
    dict(dim=["time", "x"], true_amplitude=False, prefix="k_"),
])
def test_fft_matches_reference(kw):
    """fft with true_phase (lags, the direct_lag attr), true_amplitude, a
    decreasing coordinate and the non-default prefix, in float64."""
    ref_in, da = _pair((4, 24, 20), np.float64)
    ref_in = ref_in.assign_coords(y=ref_in.coords["y"].values[::-1] - 4.0)
    da = da.assign_coords(y=da.coords["y"].values[::-1] - 4.0)
    ref = xrft_tpu.fft(ref_in, **kw)
    got = xt.fft(da, **kw)
    assert got.dtype == torch.complex128
    _assert_matches(got, ref, TOL[np.float64])


def test_unported_options_raise():
    """Segments refuse an undeclared segment length as xrft_tpu does; the
    engine names, once unported, give xrft_tpu's values."""
    ref_in, da = _pair((4, 24, 20), np.float64)
    for pkg, arr in ((xt, da), (xrft_tpu, ref_in)):
        with pytest.raises(ValueError, match="requires declared chunks"):
            pkg.power_spectrum(arr, dim="x", chunks_to_segments=True)
        with pytest.raises(ValueError, match="requires chunks_to_segments"):
            pkg.power_spectrum(arr, dim="x", segment_overlap=0.5)
    # the engine names run, with xrft_tpu's values; an unknown one raises
    for engine in ("xla", "matmul"):
        want = xrft_tpu.power_spectrum(ref_in, dim=["y", "x"],
                                       engine=engine).values
        got = xt.power_spectrum(da, dim=["y", "x"], engine=engine).values
        assert np.abs(got - want).max() <= 1e-12 * np.abs(want).max()
    with pytest.raises(ValueError, match="Unknown fft engine"):
        xt.power_spectrum(da, dim=["y", "x"], engine="bogus")
    with pytest.raises(ValueError, match="requires declared chunks"):
        xt.ifft(xt.fft(da, dim="x"), dim="freq_x", chunks_to_segments=True)


def test_mirror_route_choice():
    """K1 serves exactly two transform dims that are the array's trailing
    two, in float32/float64; every other geometry takes the plain
    expansion."""
    from xrft_tpu_torch.spectra import _mirror_kernel_applicable as applies

    _, da = _pair((2, 8, 6), np.float64)
    assert applies(da, ["y", "x"], "x")
    assert not applies(da, ["time", "x"], "x")
    assert not applies(da, ["x", "y"], "y")
    assert not applies(da, ["time", "y", "x"], "x")
    assert not applies(da.transpose("time", "x", "y"), ["y", "x"], "x")
    with psd_mirror_impl("plain"):
        assert not applies(da, ["y", "x"], "x")
    with pytest.raises(ValueError, match="psd_mirror_impl"):
        with psd_mirror_impl("pallas"):
            pass
