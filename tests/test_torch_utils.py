"""get_spacing of xrft_tpu_torch against xrft_tpu, following
``tests/test_utils.py``: the same coordinates through both, the same
spacing, and the same error."""

import numpy as np
import numpy.testing as npt
import pytest

pytest.importorskip("torch")

from xrft_tpu.labeled import Coord as RefCoord
from xrft_tpu.utils import get_spacing as ref_spacing
from xrft_tpu_torch.labeled import Coord
from xrft_tpu_torch.utils import get_spacing


def spacing_both(dims, values, name):
    got = get_spacing(Coord(dims, values, name=name))
    want = ref_spacing(RefCoord(dims, values, name=name))
    assert got == want and type(got) is type(want)
    return got


def test_get_spacing_numeric():
    npt.assert_allclose(spacing_both(("x",), np.linspace(0, 9, 10), "x"),
                        1.0)
    npt.assert_allclose(spacing_both(("x",), np.arange(5) * 0.25 + 3, "x"),
                        0.25)


def test_get_spacing_datetime():
    t = np.arange("2000-01-01", "2000-01-11",
                  dtype="datetime64[D]").astype("datetime64[ns]")
    npt.assert_allclose(spacing_both(("time",), t, "time"), 86400.0)


def test_get_spacing_uneven_raises():
    values = np.array([0.0, 1.0, 2.5])
    with pytest.raises(ValueError, match="evenly spaced") as want:
        ref_spacing(RefCoord(("x",), values, name="x"))
    with pytest.raises(ValueError, match="evenly spaced") as got:
        get_spacing(Coord(("x",), values, name="x"))
    assert str(got.value) == str(want.value)
