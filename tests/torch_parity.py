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

import re
import warnings

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
        want = np.asarray(ref.coords[c].values)
        if want.dtype.kind in "fciu":
            npt.assert_allclose(got.coords[c].values, want, rtol=1e-14,
                                atol=0)
        else:
            npt.assert_array_equal(got.coords[c].values, want)
        assert dict(got.coords[c].attrs).keys() == \
            dict(ref.coords[c].attrs).keys()
        for k, v in ref.coords[c].attrs.items():
            if isinstance(v, str):
                assert got.coords[c].attrs[k] == v, k
            else:
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



def assert_nearer_float64(got, want, truth, tol):
    """The check of a port result that rounds less than ``xrft_tpu`` does
    (a float32 detrend of data far from zero mean): ``got`` agrees with
    ``truth``, the reference on the same values in float64, as
    :func:`assert_same` at ``tol``; and it is no farther from ``want``, the
    reference on the float32 values, than ``want`` is from ``truth``, plus
    ``tol`` of max |truth|."""
    assert_same(got, truth, tol)
    g, w, t = got.values, np.asarray(want.values), np.asarray(truth.values)
    keep = ~np.isnan(t)
    scale = np.abs(t[keep]).max()
    assert np.abs(g - w)[keep].max() <= \
        np.abs(w - t)[keep].max() + tol * scale, \
        (np.abs(g - w)[keep].max() / scale, np.abs(w - t)[keep].max() / scale)

def check(name, refs, ports, impl, tol, **kw):
    """``xrft_tpu.<name>(*refs, **kw)`` against
    ``xrft_tpu_torch.<name>(*ports, **kw)`` run under ``fft_impl(impl)``;
    returns both results."""
    want = getattr(xrft_tpu, name)(*refs, **kw)
    with fft_impl(impl):
        got = getattr(xt, name)(*ports, **kw)
    assert_same(got, want, tol)
    return got, want


def port_arg(a):
    """An argument for the port: an xrft_tpu LabeledArray as the same array
    on the CPU, a list or tuple item by item, anything else as it is."""
    if isinstance(a, xrft_tpu.LabeledArray):
        return from_reference(a, device="cpu")
    if isinstance(a, (list, tuple)):
        return type(a)(port_arg(v) for v in a)
    return a


def _own(record):
    """The warnings a package raised itself: (category, message)."""
    return [(w.category, str(w.message)) for w in record
            if "site-packages" not in w.filename]


def result_tol(got) -> float:
    """2e-6 for a single-precision result, 1e-12 otherwise."""
    return TOL.get(got.values.dtype, 1e-12)


def both(fn, *args, impl="torch", tol=None, warns=None, **kw):
    """``fn`` (a public name, or a callable of the package module) on
    ``args`` through xrft_tpu and, on the same data, through the port under
    ``fft_impl(impl)``: the same warnings (among them one of category and
    message pattern ``warns``, where that is given), and results that agree
    (:func:`assert_same`, at ``tol`` or the port result's dtype's).
    Returns (port result, reference result)."""
    ref_fn = getattr(xrft_tpu, fn) if isinstance(fn, str) else fn(xrft_tpu)
    port_fn = getattr(xt, fn) if isinstance(fn, str) else fn(xt)
    with warnings.catch_warnings(record=True) as w_ref:
        warnings.simplefilter("always")
        want = ref_fn(*args, **kw)
    with warnings.catch_warnings(record=True) as w_got, fft_impl(impl):
        warnings.simplefilter("always")
        got = port_fn(*port_arg(args), **{k: port_arg(v)
                                          for k, v in kw.items()})
    assert _own(w_got) == _own(w_ref), (_own(w_got), _own(w_ref))
    if warns is not None:
        assert any(issubclass(c, warns[0]) and re.search(warns[1], m)
                   for c, m in _own(w_got)), (warns, _own(w_got))
    assert_same(got, want, result_tol(got) if tol is None else tol)
    return got, want


def raises_same(fn, *args, impl="torch", **kw):
    """``fn`` raises in both packages: the same type and message.  Returns
    the port's exception."""
    ref_fn = getattr(xrft_tpu, fn) if isinstance(fn, str) else fn(xrft_tpu)
    port_fn = getattr(xt, fn) if isinstance(fn, str) else fn(xt)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        try:
            ref_fn(*args, **kw)
        except Exception as e:          # noqa: BLE001 -- compared below
            want = e
        else:
            raise AssertionError("xrft_tpu did not raise")
        try:
            with fft_impl(impl):
                port_fn(*port_arg(args), **{k: port_arg(v)
                                            for k, v in kw.items()})
        except Exception as e:          # noqa: BLE001 -- compared below
            got = e
        else:
            raise AssertionError(f"the port did not raise {want!r}")
    assert type(got) is type(want) and str(got) == str(want), (got, want)
    return got


def phase_same(fn, *args, impl="torch", **kw):
    """:func:`both` for ``cross_phase``: labels as :func:`assert_same`;
    values on the circle (a bin whose cross spectrum is real, DC and
    Nyquist of real data, may read +pi in one package and -pi in the
    other), each bin to the tolerance of its cross spectrum's value
    (rounding of size e moves the angle of z by up to e / |z|).  Returns
    (port result, reference result)."""
    zero = lambda m: lambda *a, **k: (lambda r: r.copy(data=r.data * 0))(
        getattr(m, fn)(*a, **k))
    both(zero, *args, impl=impl, **kw)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        want = getattr(xrft_tpu, fn)(*args, **kw)
        mag = np.abs(np.asarray(xrft_tpu.cross_spectrum(*args, **kw).values))
        with fft_impl(impl):
            got = getattr(xt, fn)(*port_arg(args),
                                  **{k: port_arg(v) for k, v in kw.items()})
    d = np.angle(np.exp(1j * (got.values - np.asarray(want.values))))
    assert (np.abs(d) * mag).max() <= result_tol(got) * mag.max(), \
        (np.abs(d) * mag).max() / mag.max()
    return got, want


def assert_circle(got, want, atol):
    """Angles equal modulo 2 pi, to ``atol``."""
    d = np.angle(np.exp(1j * (np.asarray(got) - np.asarray(want))))
    assert np.abs(d).max() <= atol, np.abs(d).max()
