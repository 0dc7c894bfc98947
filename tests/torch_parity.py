"""Shared checks of the scipy-namesake tests (``test_torch_{analytic,trig,
convolve,filter,czt,fht,resample,lombscargle}.py``): the same seeded numpy
inputs go through an ``xrft_tpu`` function on the CPU (x64, as
``conftest.py`` sets it up) and its ``xrft_tpu_torch`` counterpart on
``device="cpu"``, and the two results must agree in dims, name, attrs and
coordinates, and in values to 1e-12 (float64) or 2e-6 (float32) of the
largest |value|.

On the CPU, ``fft_impl="kernel"`` runs the plain versions of K2 (float32,
lengths n >= 256 with a factor pair <= 256) and of the K4 recursion
(float64, prime factors <= 256); ``"matmul"`` runs the stacked matmul engine
where it can plan the request and the pair engine otherwise (any length;
K2's plain version on its unshifted float32 levels).
"""

import numpy as np
import numpy.testing as npt

import xrft_tpu
import xrft_tpu_torch as xt
from xrft_tpu_torch.config import fft_impl
from xrft_tpu_torch.interop import from_reference

TOL = {np.dtype(np.float32): 2e-6, np.dtype(np.complex64): 2e-6,
       np.dtype(np.float64): 1e-12, np.dtype(np.complex128): 1e-12}
IMPLS = ("torch", "kernel", "matmul")


def pair(x, dims, coords=None, name=None, attrs=None):
    """The same labeled data for both packages: (xrft_tpu, xrft_tpu_torch
    on the CPU)."""
    ref = xrft_tpu.LabeledArray(np.asarray(x), dims=dims,
                                coords=coords or {}, name=name, attrs=attrs)
    return ref, from_reference(ref, device="cpu")


def tol_of(x) -> float:
    """1e-12 for float64/complex128 (and integer) input, 2e-6 for
    float32/complex64."""
    return TOL.get(np.asarray(x).dtype, 1e-12)


def assert_same(got, ref, tol):
    """dims, name, attrs, coordinates (values and attr keys) equal; values
    within ``tol`` of the largest |reference value| (NaNs where the
    reference has them)."""
    assert tuple(got.dims) == tuple(ref.dims)
    assert got.name == ref.name
    assert got.attrs.keys() == ref.attrs.keys()
    for k, v in ref.attrs.items():
        assert np.all(got.attrs[k] == v), k
    assert set(got.coords) == set(ref.coords)
    for c in ref.coords:
        npt.assert_allclose(got.coords[c].values, ref.coords[c].values,
                            rtol=1e-14, atol=0)
        assert dict(got.coords[c].attrs).keys() == \
            dict(ref.coords[c].attrs).keys()
        for k, v in ref.coords[c].attrs.items():
            npt.assert_allclose(got.coords[c].attrs[k], v, rtol=1e-14)
    r = np.asarray(ref.values)
    g = got.values
    assert g.shape == r.shape
    assert (g.dtype.kind == "c") == (r.dtype.kind == "c")
    nan = np.isnan(r)
    npt.assert_array_equal(np.isnan(g), nan)
    r, g = r[~nan], g[~nan]
    if r.size:
        assert np.abs(g - r).max() <= tol * np.abs(r).max(), \
            (np.abs(g - r).max(), np.abs(r).max())


def check(name, refs, ports, impl, tol, **kw):
    """``xrft_tpu.<name>(*refs, **kw)`` against
    ``xrft_tpu_torch.<name>(*ports, **kw)`` run under ``fft_impl(impl)``;
    returns both results."""
    want = getattr(xrft_tpu, name)(*refs, **kw)
    with fft_impl(impl):
        got = getattr(xt, name)(*ports, **kw)
    assert_same(got, want, tol)
    return got, want
