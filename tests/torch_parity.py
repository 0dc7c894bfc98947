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
import pytest
import torch

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


# ---------------------------------------------------------------------------
# the dtype sweep of the scipy namesakes (test_torch_namesake_parity_*.py)
# ---------------------------------------------------------------------------

SWEEP_DTYPES = ("float32", "float64", "complex64", "complex128", "int16",
                "int32", "int64", "uint8", "bool", "float16")
# the port's single-precision counterpart of a reference result's dtype
# (float16 data compute in float32, whatever dtype xrft_tpu returns)
SINGLE_OF = {np.dtype(np.float64): np.dtype(np.float32),
             np.dtype(np.complex128): np.dtype(np.complex64),
             np.dtype(np.float16): np.dtype(np.float32)}
_SINGLE_INPUTS = ("float32", "float16", "complex64")
_SWEEP_Y, _SWEEP_X = np.arange(256) * 2.0, np.arange(256) * 0.5
_SWEEP_KINDS = {
    # kind: (shape, dims, coords)
    "row": ((4, 256), ("y", "x"), {"y": _SWEEP_Y[:4], "x": _SWEEP_X}),
    # DST-I transforms 2N+2 points: 255 samples reach K2 and K4 as 512
    "row255": ((4, 255), ("y", "x"), {"y": _SWEEP_Y[:4],
                                      "x": _SWEEP_X[:255]}),
    "grid": ((256, 256), ("y", "x"), {"y": _SWEEP_Y, "x": _SWEEP_X}),
    "long": ((4, 512), ("y", "x"), {"y": _SWEEP_Y[:4],
                                    "x": np.arange(512) * 0.5}),
}


def _outcome(fn):
    """(result, None) or (None, exception) of fn(), warnings silenced."""
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        try:
            return fn(), None
        except Exception as e:       # noqa: BLE001 -- compared, not hidden
            return None, e


def _assert_same_error(got_err, want_err):
    assert got_err is not None, f"the port returned where {want_err!r}"
    assert type(got_err) is type(want_err) and \
        str(got_err) == str(want_err), (got_err, want_err)


def _assert_bits(got, want):
    """Two port results with the same dtype and the same bits."""
    assert got.data.dtype == want.data.dtype, (got.data.dtype,
                                               want.data.dtype)
    assert torch.equal(got.data, want.data)


def _assert_same_outcome(got, want):
    """Two port outcomes: the same error, or the same bits."""
    (got, got_err), (want, want_err) = got, want
    if want_err is not None:
        _assert_same_error(got_err, want_err)
    else:
        assert got_err is None, got_err
        _assert_bits(got, want)


class NamesakeSweep:
    """Every namesake of ``entries`` (name: (input kind, call, oracle)) on
    the ten dtypes of :data:`SWEEP_DTYPES` under each route, through
    ``xrft_tpu`` and through the port, with seeded values from
    ``make(dtype, shape, seed)``.  ``call(m, a, b)`` runs the namesake of
    the module ``m`` on two inputs; ``oracle(x, y)`` computes it with scipy
    or numpy on their float64 (complex128) values, or is None.  The
    reference's outcome is computed once per (entry, dtype) and shared by
    the routes.  The entries of ``double`` compute in double precision
    whatever the data (the hp transforms)."""

    def __init__(self, entries, make, double=()):
        self.entries, self.make, self.double = entries, make, double
        self._ref = {}

    def inputs(self, dtype, kind):
        """((reference a, b), (port a, b)) of ``kind``."""
        shape, dims, coords = _SWEEP_KINDS[kind]
        a = pair(self.make(dtype, shape, 1), dims, coords=coords, name="a",
                 attrs={"units": "K"})
        b = pair(self.make(dtype, shape, 2), dims, coords=coords, name="b")
        return (a[0], b[0]), (a[1], b[1])

    def reference(self, entry, dtype):
        key = entry, dtype
        if key not in self._ref:
            kind, call, _ = self.entries[entry]
            (ra, rb), _ = self.inputs(dtype, kind)
            self._ref[key] = _outcome(lambda: call(xrft_tpu, ra, rb))
        return self._ref[key]

    def port(self, entry, dtype, impl, cast=None):
        """The port's outcome on the data of ``dtype``, cast to the dtype
        ``cast`` (or as they are)."""
        kind, call, _ = self.entries[entry]
        _, (pa, pb) = self.inputs(dtype, kind)
        if cast is not None:
            pa, pb = (p.copy(data=p.data.to(cast)) for p in (pa, pb))
        with fft_impl(impl):
            return _outcome(lambda: call(xt, pa, pb))

    def _assert_float16_bits(self, entry, dtype, impl, outcome):
        """A float16 call's ``outcome`` is the float32 call's on the same
        values, bit for bit (or the same error): the promotion is its first
        operation."""
        if dtype == "float16":
            _assert_same_outcome(outcome, self.port(entry, dtype, impl,
                                                    torch.float32))

    def assert_parity(self, entry, dtype, impl):
        """Both packages return and agree (:func:`assert_same`; the port's
        dtype is the reference's, or its single-precision counterpart for
        float32, float16 and complex64 data), or both raise the same
        exception type and message."""
        want, want_err = self.reference(entry, dtype)
        outcome = got, got_err = self.port(entry, dtype, impl)
        if want_err is not None:
            _assert_same_error(got_err, want_err)
        else:
            if got_err is not None:
                raise got_err
            rd = np.asarray(want.values).dtype
            expect = SINGLE_OF.get(rd, rd) if dtype in _SINGLE_INPUTS \
                and entry not in self.double else rd
            assert got.values.dtype == expect, (got.values.dtype, expect)
            if rd.kind in "iub":       # an exact result: equal, and labels
                npt.assert_array_equal(got.values, np.asarray(want.values))
                got, want = got.copy(data=torch.zeros(got.shape)), \
                    want.copy(data=np.zeros(want.shape))
            assert_same(got, want, TOL.get(expect, 0.0))
        self._assert_float16_bits(entry, dtype, impl, outcome)

    def assert_oracle(self, entry, dtype, impl):
        """The port against scipy or numpy on the float64 values (1e-12 of
        max for a double-precision result, 2e-6 for a single one), in
        float64/complex128 for integer, bool and double data (and the
        entries of ``double``) and float32/complex64 otherwise; labels as
        the reference's where it returns."""
        kind, _, oracle = self.entries[entry]
        (ra, rb), _ = self.inputs(dtype, kind)
        x, y = (np.asarray(r.values) for r in (ra, rb))
        x, y = (v.astype(np.complex128 if v.dtype.kind == "c"
                         else np.float64) for v in (x, y))
        truth = np.asarray(oracle(x, y))
        outcome = got, got_err = self.port(entry, dtype, impl)
        if got_err is not None:
            raise got_err
        double = dtype in ("float64", "complex128") or \
            np.dtype(dtype).kind in "iub" or entry in self.double
        expect = np.dtype(truth.dtype if double
                          else SINGLE_OF.get(truth.dtype, truth.dtype))
        assert got.values.dtype == expect, (got.values.dtype, expect)
        want, want_err = self.reference(entry, dtype)
        if want_err is None:
            assert_same(got, want.copy(data=truth), TOL[expect])
        else:
            g = got.values
            assert g.shape == truth.shape
            assert np.abs(g - truth).max() <= \
                TOL[expect] * np.abs(truth).max()
        self._assert_float16_bits(entry, dtype, impl, outcome)

    def assert_complex32(self, entry, impl):
        """complex32 data (the complex64 values rounded to half precision)
        are the same values in complex64 in the port: the same result bit
        for bit, or the same error."""
        kind, call, _ = self.entries[entry]
        _, (pa, pb) = self.inputs("complex64", kind)
        with warnings.catch_warnings():     # "ComplexHalf ... experimental"
            warnings.simplefilter("ignore")
            half = [p.copy(data=p.data.to(torch.complex32))
                    for p in (pa, pb)]
        wide = [p.copy(data=p.data.to(torch.complex64)) for p in half]
        with fft_impl(impl):
            _assert_same_outcome(_outcome(lambda: call(xt, *half)),
                                 _outcome(lambda: call(xt, *wide)))


def namesake_cases(entries, defects):
    """(entry, dtype) parameters over :data:`SWEEP_DTYPES`; a case of
    ``defects`` (a list of (xfail mark, {entry: dtypes})) carries its strict
    xfail mark.  Returns (every case, the defect cases)."""
    marks = {}
    for mark, where in defects:
        for entry, dtypes in where.items():
            for d in dtypes:
                marks[entry, d] = mark
    cases = [pytest.param(e, d, marks=marks[e, d]) if (e, d) in marks
             else (e, d) for e in entries for d in SWEEP_DTYPES]
    return cases, sorted(marks)


def reference_defect(where: str, what: str):
    """The strict xfail of a parity case in which ``xrft_tpu`` itself is
    wrong (at ``where``) and the port is held to scipy or numpy instead."""
    return pytest.mark.xfail(strict=True, reason=(
        f"a defect of the reference ({where}): {what}; the port is held "
        "to scipy/numpy on the float64 values by test_defect_held_to_oracle"))
