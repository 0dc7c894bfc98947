"""A tier-1 dtype sweep of the filter namesakes against xrft_tpu.

``upfirdn`` (21 taps, up 3, down 2), ``resample_poly(3, 2)``,
``decimate(4)`` and ``savgol_filter(11, 3)`` along x of (4, 256) rows, on
the ten dtypes of ``test_torch_fuzz_parity.py`` (its seeded values) under
each ``fft_impl``.  Each case is parity with the reference or the same error
(``torch_parity.NamesakeSweep``); a float16 call is also the float32 call on
the same values, bit for bit.  Where the reference is wrong its parity case
is a strict xfail, and the port is held to ``scipy.signal`` on the float64
values instead.  A complex32 tensor, given to the port alone, is the
complex64 data.
"""

import numpy as np
import pytest
import scipy.signal as sps

torch = pytest.importorskip("torch")

from test_torch_fuzz_parity import values
from torch_parity import (IMPLS, NamesakeSweep, namesake_cases,
                          reference_defect)

TAPS = np.random.default_rng(5).standard_normal(21)
ENTRIES = {
    "upfirdn": ("row", lambda m, a, b: m.upfirdn(TAPS, a, up=3, down=2,
                                                 dim="x"),
                lambda x, y: sps.upfirdn(TAPS, x, 3, 2, axis=-1)),
    "resample_poly": ("row", lambda m, a, b: m.resample_poly(a, 3, 2,
                                                             dim="x"),
                      lambda x, y: sps.resample_poly(x, 3, 2, axis=-1)),
    "decimate": ("row", lambda m, a, b: m.decimate(a, 4, dim="x"),
                 lambda x, y: sps.decimate(x, 4, ftype="fir", axis=-1)),
    "savgol_filter": ("row", lambda m, a, b: m.savgol_filter(a, 11, 3,
                                                             dim="x"),
                      lambda x, y: sps.savgol_filter(x, 11, 3, axis=-1)),
}

NARROW = ("int16", "int32", "uint8", "bool")
DEFECTS = [
    (reference_defect(
        "xrft_tpu/filter.py:205-210",
        "upfirdn hands integer and bool data to JAX's float32 transform "
        "and filters them with float64 taps: 4.3e-8 to 9.9e-8 of max from "
        "scipy in upfirdn, resample_poly and decimate"),
     {"upfirdn": NARROW, "resample_poly": NARROW, "decimate": NARROW}),
    (reference_defect(
        "xrft_tpu/filter.py:505-510",
        "savgol_filter casts its edge-fit matrices to the data's dtype: "
        "integer and bool data read 0.81 to 0.95 of max from scipy, float16 "
        "data 2.1e-4"),
     {"savgol_filter": NARROW + ("int64", "float16")}),
]
CASES, DEFECT_CASES = namesake_cases(ENTRIES, DEFECTS)
SWEEP = NamesakeSweep(ENTRIES, values)


@pytest.mark.parametrize("impl", IMPLS)
@pytest.mark.parametrize("entry,dtype", CASES)
def test_parity(entry, dtype, impl):
    SWEEP.assert_parity(entry, dtype, impl)


@pytest.mark.parametrize("impl", IMPLS)
@pytest.mark.parametrize("entry,dtype", DEFECT_CASES)
def test_defect_held_to_oracle(entry, dtype, impl):
    SWEEP.assert_oracle(entry, dtype, impl)


@pytest.mark.parametrize("impl", IMPLS)
@pytest.mark.parametrize("entry", sorted(ENTRIES))
def test_complex32(entry, impl):
    SWEEP.assert_complex32(entry, impl)
