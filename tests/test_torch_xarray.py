"""xarray at xrft_tpu_torch's API boundary, on the CPU.

Neither machine that runs these tests has xarray, so they use the stub
module of ``tests/test_xarray_boundary.py`` (the DataArray surface the
converters read, and ``register_dataarray_accessor``), put in
``sys.modules`` for the test.  DataArray arguments go to ``device="cpu"``
here; the values are held against xrft_tpu's through the same stub.
"""

import sys
import warnings

import numpy as np
import numpy.testing as npt
import pytest

import xrft_tpu
import xrft_tpu_torch as xt
from xrft_tpu_torch.xarray_compat import (XrftAccessor, from_xarray,
                                          is_dataarray, register_accessor,
                                          to_xarray, xr_boundary)
from test_xarray_boundary import _make_stub_xarray

N = 32


@pytest.fixture
def stub_xr(monkeypatch):
    mod = _make_stub_xarray()
    monkeypatch.setitem(sys.modules, "xarray", mod)
    assert register_accessor(mod)
    return mod


def _field(xr, seed=0, shape=(N, N), dtype=np.float64, name="field"):
    return xr.DataArray(
        np.random.RandomState(seed).randn(*shape).astype(dtype),
        dims=("y", "x"),
        coords={"y": np.arange(shape[0]) * 0.5,
                "x": np.arange(shape[1]) * 0.5},
        attrs={"units": "m"}, name=name)


def _same(got, want, tol=1e-12):
    assert type(got) is type(want)
    assert tuple(got.dims) == tuple(want.dims)
    assert got.name == want.name
    assert set(got.coords) == set(want.coords)
    for c in want.coords:
        npt.assert_allclose(got.coords[c].values, want.coords[c].values)
    g, w = np.asarray(got.values), np.asarray(want.values)
    assert np.abs(g - w).max() <= tol * np.abs(w).max()


def test_roundtrip_keeps_everything(stub_xr):
    da = _field(stub_xr)
    la = from_xarray(da, device="cpu")
    assert isinstance(la, xt.LabeledArray)
    assert la.device.type == "cpu"
    assert la.dims == ("y", "x") and la.name == "field"
    assert la.attrs == {"units": "m"}
    back = to_xarray(la)
    assert is_dataarray(back)
    npt.assert_array_equal(back.values, da.values)
    assert back.attrs == da.attrs and back.name == da.name
    for c in da.coords:
        npt.assert_array_equal(back.coords[c].values, da.coords[c].values)


def test_from_xarray_default_device_is_the_card(stub_xr, monkeypatch):
    """Without device=, the data go to the CUDA device, which raises on a
    machine without one (resolve_device)."""
    import torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        from_xarray(_field(stub_xr))


def test_converters_need_xarray(monkeypatch):
    monkeypatch.setitem(sys.modules, "xarray", None)
    with pytest.raises(ImportError, match="xarray is required"):
        to_xarray(xt.LabeledArray(np.zeros(3), dims="x", device="cpu"))


@pytest.mark.parametrize("name,kw", [
    ("fft", dict(dim=["x"])),
    ("power_spectrum", dict(dim=["y", "x"], window="hann")),
    ("isotropic_power_spectrum", dict(dim=["y", "x"], truncate=True)),
    ("spectrogram", dict(dim="x", seglen=N // 2)),
    ("detrend", dict(dim=["y", "x"], detrend_type="linear")),
    ("pad", dict(pad_width={"x": 2}, mode="constant")),
    ("hilbert", dict(dim="x")),
])
def test_one_input_functions(stub_xr, name, kw):
    """DataArray in, DataArray out, equal to xrft_tpu through the stub."""
    da = _field(stub_xr)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        want = getattr(xrft_tpu, name)(da, **kw)
        got = getattr(xt, name)(da, device="cpu", **kw)
    _same(got, want)


def test_two_input_functions(stub_xr):
    """Two DataArrays, or a DataArray and a LabeledArray."""
    da1, da2 = _field(stub_xr, 0), _field(stub_xr, 1, name="other")
    la2 = from_xarray(da2, device="cpu")
    want = xrft_tpu.cross_spectrum(da1, da2, dim=["x"])
    _same(xt.cross_spectrum(da1, da2, dim=["x"], device="cpu"), want)
    _same(xt.cross_spectrum(da1, la2, dim=["x"], device="cpu"), want)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")  # unsegmented coherence
        _same(xt.coherence(da1, da2, dim=["x"], device="cpu"),
              xrft_tpu.coherence(da1, da2, dim=["x"]))


def test_tuple_results_convert_each_element(stub_xr):
    def fn(la):
        return la, la * 2.0, "tag"

    da = _field(stub_xr)
    out = xr_boundary(fn)(da, device="cpu")
    assert isinstance(out, tuple) and len(out) == 3
    assert is_dataarray(out[0]) and is_dataarray(out[1]) and out[2] == "tag"
    npt.assert_array_equal(out[1].values, 2.0 * da.values)


def test_labeledarray_passthrough(stub_xr):
    """A LabeledArray first argument keeps LabeledArray results, and a
    device= keyword is the function's own."""
    la = xt.LabeledArray(np.random.randn(16), dims=("x",),
                         coords={"x": np.arange(16.0)}, device="cpu")
    assert isinstance(xt.fft(la, dim="x"), xt.LabeledArray)
    with pytest.raises(TypeError):
        xt.fft(la, dim="x", device="cpu")


def test_wrapped_names_match_reference():
    """The same public functions are wrapped in both packages."""
    wrapped = {n for n in dir(xrft_tpu)
               if hasattr(getattr(xrft_tpu, n), "__wrapped_la__")}
    mine = {n for n in dir(xt) if hasattr(getattr(xt, n), "__wrapped_la__")}
    assert mine == wrapped and len(mine) == 48


def test_accessor_methods_match_reference():
    from xrft_tpu.xarray_compat import XrftAccessor as RefAccessor

    assert XrftAccessor._METHODS == RefAccessor._METHODS
    for name in XrftAccessor._METHODS:
        assert callable(getattr(xt, name))


def test_accessor_values(stub_xr):
    """``da.xrft.<method>`` runs xrft_tpu_torch's function."""
    da = _field(stub_xr)
    assert isinstance(da.xrft, XrftAccessor)
    got = da.xrft.power_spectrum(dim=["y", "x"], device="cpu")
    _same(got, xrft_tpu.power_spectrum(da, dim=["y", "x"]))
    with pytest.raises(AttributeError):
        da.xrft.not_a_method
