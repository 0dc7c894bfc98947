"""cftime coordinates in xrft_tpu_torch against xrft_tpu, following
``tests/test_coords_cftime.py``: the same stub ``cftime`` module (cftime is
optional and absent here), the same decoded spacing, lag and validity in
both packages, and an fft over a cftime coordinate."""

import sys
import types

import numpy as np
import numpy.testing as npt
import pytest

torch = pytest.importorskip("torch")

import xrft_tpu
from xrft_tpu import coords as ref_coords
from xrft_tpu.labeled import Coord as RefCoord
from xrft_tpu_torch import coords
from xrft_tpu_torch.labeled import Coord

from torch_parity import both


class _FakeCFDate:
    """Minimal cftime-datetime stand-in: has .calendar, orders by _days."""

    def __init__(self, days, calendar="noleap"):
        self._days = days
        self.calendar = calendar

    def __lt__(self, o):
        return self._days < o._days

    def __gt__(self, o):
        return self._days > o._days

    def __eq__(self, o):
        return self._days == o._days

    def __hash__(self):
        return hash(self._days)


@pytest.fixture
def stub_cftime(monkeypatch):
    mod = types.ModuleType("cftime")

    def date2num(dates, units, calendar):
        assert units.startswith("seconds since 1800-01-01")
        arr = np.asarray(dates, dtype=object)
        if arr.ndim == 0:
            return arr.item()._days * 86400.0
        return np.array([d._days * 86400.0 for d in arr.ravel()]).reshape(
            arr.shape)

    mod.date2num = date2num
    monkeypatch.setitem(sys.modules, "cftime", mod)
    return mod


def dates(n):
    return np.array([_FakeCFDate(i) for i in range(n)], dtype=object)


def test_diff_coord_cftime(stub_cftime):
    d = coords.diff_coord(Coord(("time",), dates(10), name="time"))
    want = ref_coords.diff_coord(RefCoord(("time",), dates(10), name="time"))
    npt.assert_array_equal(d, want)
    npt.assert_allclose(d, 86400.0)


def test_lag_coord_cftime(stub_cftime):
    got = coords.lag_coord(Coord(("time",), dates(11), name="time"))
    want = ref_coords.lag_coord(RefCoord(("time",), dates(11), name="time"))
    assert got == want == 5 * 86400.0


def test_cftime_coord_is_valid(stub_cftime):
    assert coords.is_valid_fft_coord(Coord(("t",), dates(4), name="t"))
    assert ref_coords.is_valid_fft_coord(RefCoord(("t",), dates(4),
                                                  name="t"))


def test_fft_over_a_cftime_coordinate(stub_cftime):
    """The decoded daily spacing gives the frequency grid in 1/seconds,
    and the true-phase lag in seconds, in both packages."""
    x = np.random.RandomState(0).randn(3, 16)
    da = xrft_tpu.LabeledArray(x, dims=("z", "time"),
                               coords={"time": dates(16)})
    got, _ = both("fft", da, dim="time")
    npt.assert_allclose(got["freq_time"].values,
                        np.fft.fftshift(np.fft.fftfreq(16, 86400.0)))
    assert got["freq_time"].attrs["direct_lag"] == 8 * 86400.0
