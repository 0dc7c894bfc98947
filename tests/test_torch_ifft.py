"""The ported inverse transform, xrft_tpu_torch.ifft (with the dft/idft
aliases), held against xrft_tpu.ifft on the CPU: dims, coordinates with
their attrs, name, values and warnings, under both fft_impl values.

Tolerances, relative to max|x|: 1e-12 for complex128 spectra; 2e-6 for
complex64 spectra (float32 sums over a few hundred terms, by XLA on one side
and by torch or K2's plain version on the other).  Every axis has at least
256 points and a factor pair <= 256, so the float32 kernel route (K2) runs
on each; float64 data take the K4 recursion.
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

TOL = {np.complex64: 2e-6, np.complex128: 1e-12}
DX = {"y": 0.5, "x": 0.25}


def _spectrum(shape, cdtype, order="shifted", real_last=False, seed=0,
              lags=(1.25, -3.0)):
    """A random (time, freq_y, freq_x) spectrum on the grid an fft of a
    (time, y, x) field of ``shape`` gives: freq_y fftshifted, in natural
    fftfreq order, or randomly permuted; freq_x the same, or the rfft grid
    when ``real_last``.  Each frequency coordinate has its spacing and
    ``direct_lag`` attrs.  Random complex values put imaginary parts in the
    DC and Nyquist columns of the half spectrum too."""
    rng = np.random.RandomState(seed)
    B, ny, nx = shape
    grids = {"y": np.fft.fftfreq(ny, DX["y"]),
             "x": (np.fft.rfftfreq if real_last else np.fft.fftfreq)(
                 nx, DX["x"])}
    for d in ("y", "x") if not real_last else ("y",):
        if order == "shifted":
            grids[d] = np.fft.fftshift(grids[d])
        elif order == "permuted":
            grids[d] = grids[d][rng.permutation(grids[d].size)]
    sizes = (B, grids["y"].size, grids["x"].size)
    data = (rng.randn(*sizes) + 1j * rng.randn(*sizes)).astype(cdtype)
    coords = {"time": np.arange(B, dtype=np.float64)}
    for (d, g), lag in zip(grids.items(), lags):
        spacing = np.sort(g)[1] - np.sort(g)[0]
        coords["freq_" + d] = (("freq_" + d,), g,
                               {"spacing": spacing, "direct_lag": lag})
    return xrft_tpu.LabeledArray(data, dims=("time", "freq_y", "freq_x"),
                                 coords=coords, name="spec")


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
    assert g.dtype == r.dtype and g.shape == r.shape
    assert np.abs(g - r).max() <= tol * np.abs(r).max()


def _run(fn, *args, **kw):
    """fn's result and the (category, message) of each warning it gave."""
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        out = fn(*args, **kw)
    return out, [(w.category, str(w.message)) for w in caught]


def _compare(ref_in, impl, tol, fn_ref=xrft_tpu.ifft, fn=xt.ifft, **kw):
    ref, ref_warn = _run(fn_ref, ref_in, **kw)
    with fft_impl(impl):
        got, got_warn = _run(fn, from_reference(ref_in, device="cpu"), **kw)
    assert got_warn == ref_warn
    _assert_matches(got, ref, tol)
    return got


BOTH = dict(dim=["freq_y", "freq_x"])
CASES = {
    "lag_none": ((2, 256, 256), "shifted", False, BOTH),
    "lag_explicit": ((2, 256, 256), "shifted", False,
                     dict(BOTH, lag=[0.5, 2.0])),
    "lag_partial": ((2, 256, 256), "shifted", False,
                    dict(BOTH, lag=[None, 2.0])),
    "lag_zero": ((2, 256, 256), "shifted", False, dict(BOTH, lag=[0, 0.0])),
    "lag_scalar_one_dim": ((2, 256, 256), "shifted", False,
                           dict(dim="freq_x", lag=1.5)),
    "natural_order": ((2, 256, 256), "natural", False, BOTH),
    "permuted_order": ((2, 256, 256), "permuted", False, BOTH),
    "odd_sizes": ((2, 275, 275), "shifted", False, BOTH),
    "odd_natural": ((2, 275, 275), "natural", False, BOTH),
    "odd_permuted": ((2, 275, 275), "permuted", False, BOTH),
    "real_dim": ((2, 256, 256), "shifted", True,
                 dict(BOTH, real_dim="freq_x")),
    "real_dim_natural": ((2, 256, 256), "natural", True,
                         dict(BOTH, real_dim="freq_x")),
    "real_dim_permuted": ((2, 256, 256), "permuted", True,
                          dict(BOTH, real_dim="freq_x")),
    "real_dim_odd_y": ((2, 275, 275), "shifted", True,
                       dict(BOTH, real_dim="freq_x", lag=[1.0, 0.0])),
    "real_dim_one_dim": ((2, 256, 256), "shifted", True,
                         dict(dim="freq_x", real_dim="freq_x")),
    "no_amplitude": ((2, 256, 256), "shifted", False,
                     dict(BOTH, true_amplitude=False)),
    "all_dims_prefix": ((1, 256, 256), "shifted", False,
                        dict(dim=["freq_y", "freq_x"], prefix="freq_")),
    "real_flag": ((2, 256, 256), "shifted", True, dict(BOTH, real="freq_x")),
}


@pytest.mark.parametrize("impl", ["torch", "kernel"])
@pytest.mark.parametrize("cdtype", [np.complex128, np.complex64])
@pytest.mark.parametrize("case", sorted(CASES))
def test_ifft_matches_reference(case, cdtype, impl):
    shape, order, real_last, kw = CASES[case]
    ref_in = _spectrum(shape, cdtype, order, real_last, seed=len(case))
    _compare(ref_in, impl, TOL[cdtype], **kw)


@pytest.mark.parametrize("real_last", [False, True])
@pytest.mark.parametrize("true_phase,shift", [(False, False), (True, False),
                                              (False, True), (True, True)])
@pytest.mark.parametrize("n", [256, 275])
def test_phase_and_shift_cases(n, true_phase, shift, real_last):
    """The four true_phase x shift cases (three output shifts), with and
    without real_dim, at even and odd sizes, in both precisions, under both
    fft_impl values."""
    kw = dict(BOTH, true_phase=true_phase, shift=shift)
    if real_last:
        kw["real_dim"] = "freq_x"
    for cdtype in (np.complex128, np.complex64):
        ref_in = _spectrum((2, n, n), cdtype, "shifted", real_last, seed=n)
        for impl in ("torch", "kernel"):
            _compare(ref_in, impl, TOL[cdtype], **kw)
            _compare(ref_in, impl, TOL[cdtype], **dict(kw, lag=[0.5, 0.0]))


@pytest.mark.parametrize("impl", ["torch", "kernel"])
def test_irfft_drops_imaginary_dc_and_nyquist(impl):
    """A half spectrum whose DC and Nyquist columns are complex inverts as
    numpy's irfft does: their imaginary parts drop."""
    ref_in = _spectrum((2, 256, 256), np.complex128, "natural", True,
                       lags=(0.0, 0.0))
    F = ref_in.values
    assert np.abs(F[..., 0].imag).min() > 0 and \
        np.abs(F[..., -1].imag).min() > 0
    got = _compare(ref_in, impl, 1e-12, real_dim="freq_x", shift=False,
                   true_amplitude=False, **BOTH)
    ref = np.fft.irfftn(F, axes=(1, 2))   # natural order: no roll at all
    npt.assert_allclose(got.values, ref, rtol=0,
                        atol=1e-12 * np.abs(ref).max())


@pytest.mark.parametrize("impl", ["torch", "kernel"])
def test_centering_error(impl):
    ref_in = _spectrum((1, 256, 256), np.complex128)
    c = ref_in.coords["freq_y"]
    off = ref_in.assign_coords(freq_y=(c.dims, c.values + 0.37 * (
        c.values[1] - c.values[0]), c.attrs))
    for fn, arr in ((xrft_tpu.ifft, off), (xt.ifft, from_reference(off, device="cpu"))):
        with fft_impl(impl), warnings.catch_warnings():
            warnings.simplefilter("ignore")
            with pytest.raises(ValueError, match="not centered on zero "
                                                 "frequency"):
                fn(arr, **BOTH)


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
@pytest.mark.parametrize("impl", ["torch", "kernel"])
@pytest.mark.parametrize("real_dim", [None, "x"])
def test_fft_ifft_roundtrip(real_dim, impl, dtype):
    """fft then ifft (lag=None, read from direct_lag) gives the field back
    on its own coordinates, decreasing y included, and agrees with
    xrft_tpu."""
    rng = np.random.RandomState(3)
    coords = {"time": np.arange(2.0), "y": 7.0 - np.arange(256) * 0.5,
              "x": np.arange(256) * 0.25 + 3.0}
    ref_da = xrft_tpu.LabeledArray(rng.randn(2, 256, 256).astype(dtype),
                                   dims=("time", "y", "x"), coords=coords,
                                   name="eta")
    with fft_impl(impl):
        F = xt.fft(from_reference(ref_da, device="cpu"), dim=["y", "x"], real_dim=real_dim)
    ref_F = xrft_tpu.fft(ref_da, dim=["y", "x"], real_dim=real_dim)
    kw = dict(dim=["freq_y", "freq_x"],
              real_dim=None if real_dim is None else "freq_x")
    ref, ref_warn = _run(xrft_tpu.ifft, ref_F, **kw)
    with fft_impl(impl):
        got, got_warn = _run(xt.ifft, F, **kw)
    assert got_warn == ref_warn and len(got_warn) == 1
    tol = 1e-12 if dtype == np.float64 else 2e-6
    _assert_matches(got, ref, tol)
    back = got.values.real
    # y was decreasing: the roundtrip returns it ascending
    npt.assert_allclose(got.coords["y"].values, coords["y"][::-1],
                        rtol=0, atol=1e-12)
    npt.assert_allclose(got.coords["x"].values, coords["x"], rtol=0,
                        atol=1e-12)
    src = ref_da.values[:, ::-1, :]
    npt.assert_allclose(back, src, rtol=0, atol=10 * tol * np.abs(src).max())


@pytest.mark.parametrize("impl", ["torch", "kernel"])
def test_dft_idft_aliases(impl):
    rng = np.random.RandomState(4)
    ref_da = xrft_tpu.LabeledArray(
        rng.randn(2, 256, 256), dims=("time", "y", "x"),
        coords={"y": np.arange(256) * 0.5, "x": np.arange(256) * 0.25})
    F = _compare(ref_da, impl, 1e-12, fn_ref=xrft_tpu.dft, fn=xt.dft,
                 dim=["y", "x"], shift=False)
    back, warn = _run(xt.idft, F, dim=["freq_y", "freq_x"])
    assert [c for c, _ in warn] == [FutureWarning, FutureWarning]
    assert "renamed" in warn[0][1] and "lag=None" in warn[1][1]
    npt.assert_allclose(back.values.real, ref_da.values, rtol=0, atol=1e-12)


def test_lag_length_and_true_phase_warnings():
    ref_in = _spectrum((1, 256, 256), np.complex128)
    for fn, arr in ((xrft_tpu.ifft, ref_in), (xt.ifft, from_reference(ref_in, device="cpu"))):
        with pytest.raises(ValueError, match="same length"):
            fn(arr, lag=[1.0], **BOTH)
        with pytest.raises(ValueError, match="real IFT"):
            fn(arr, real_dim="nope", **BOTH)
        with pytest.warns(Warning, match="does not guarantee"):
            fn(arr, lag=[0.0, 0.0], true_phase=False, **BOTH)


def test_unported_options_raise():
    da = from_reference(_spectrum((1, 256, 256), np.complex128), device="cpu")
    # segments are ported: without declared chunks both packages refuse
    with pytest.raises(ValueError, match="requires declared chunks"):
        xt.ifft(da, chunks_to_segments=True, **BOTH)
    with pytest.raises(ValueError, match="requires declared chunks"):
        xrft_tpu.ifft(_spectrum((1, 256, 256), np.complex128),
                      chunks_to_segments=True, **BOTH)
    # the engine names run, with xrft_tpu's values; an unknown one raises
    ref = _spectrum((1, 256, 256), np.complex128)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", FutureWarning)
        for engine in ("xla", "matmul"):
            want = xrft_tpu.ifft(ref, engine=engine, **BOTH).values
            got = xt.ifft(da, engine=engine, **BOTH).values
            assert np.abs(got - want).max() <= 1e-12 * np.abs(want).max()
    with pytest.raises(ValueError, match="Unknown fft engine"):
        xt.ifft(da, engine="bogus", **BOTH)


def test_sortby_matches_reference():
    rng = np.random.RandomState(8)
    ref = xrft_tpu.LabeledArray(
        rng.randn(3, 7), dims=("a", "b"),
        coords={"a": np.array([2.0, -1.0, 0.5]),
                "b": rng.permutation(7).astype(float)})
    got = from_reference(ref, device="cpu").sortby(["a", "b"])
    want = ref.sortby(["a", "b"])
    npt.assert_array_equal(got.values, want.values)
    for c in ("a", "b"):
        npt.assert_array_equal(got.coords[c].values, want.coords[c].values)
    with pytest.raises(KeyError):
        from_reference(ref, device="cpu").sortby("c")
