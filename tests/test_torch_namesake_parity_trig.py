"""A tier-1 dtype sweep of the trigonometric namesakes against xrft_tpu.

``dct``, ``idct``, ``dst`` and ``idst`` of types 1-4 (norm None) and of type
2 under "ortho" and "forward", and ``dctn``, ``idctn``, ``dstn`` and
``idstn`` over a 256 x 256 grid, on the ten dtypes of
``test_torch_fuzz_parity.py`` (its seeded values) under each ``fft_impl``,
with 256 points along each transformed dim (255 for DST-I, whose 2N+2 = 512
points K2 and K4 take), so "kernel" runs.  Each case is parity with the
reference or the same error (``torch_parity.NamesakeSweep``); a float16 call
is also the float32 call on the same values, bit for bit.  Where the
reference is wrong its parity case is a strict xfail, and the port is held
to ``scipy.fft`` on the float64 values instead.  A complex32 tensor, given
to the port alone, raises as complex64 data do.
"""

import pytest
import scipy.fft as sf

torch = pytest.importorskip("torch")

from test_torch_fuzz_parity import values
from torch_parity import (IMPLS, NamesakeSweep, namesake_cases,
                          reference_defect)


def _one(name, type, norm=None):
    return lambda m, a, b: getattr(m, name)(a, dim="x", type=type,
                                            norm=norm)


def _oracle(name, type, norm=None):
    return lambda x, y: getattr(sf, name)(x, type=type, norm=norm, axis=-1)


ENTRIES = {}
for _name in ("dct", "idct", "dst", "idst"):
    for _type in (1, 2, 3, 4):
        ENTRIES[f"{_name}{_type}"] = (
            "row255" if _name.endswith("dst") and _type == 1 else "row",
            _one(_name, _type), _oracle(_name, _type))
    for _norm in ("ortho", "forward"):
        ENTRIES[f"{_name}2_{_norm}"] = ("row", _one(_name, 2, _norm),
                                        _oracle(_name, 2, _norm))
for _name in ("dctn", "idctn", "dstn", "idstn"):
    ENTRIES[_name] = (
        "grid", (lambda n: lambda m, a, b: getattr(m, n)(a, dim=["y", "x"]))(
            _name),
        (lambda n: lambda x, y: getattr(sf, n)(x, axes=(0, 1)))(_name))

NARROW = ("int16", "int32", "uint8", "bool")
DEFECTS = [
    (reference_defect(
        "xrft_tpu/trig.py:130-137",
        "DCT-I of integer and bool data takes JAX's float32 transform and "
        "returns float32 at 1.5e-8 to 1.1e-7 of max, where scipy and the "
        "port return float64"),
     {"dct1": NARROW, "idct1": NARROW}),
    (reference_defect(
        "xrft_tpu/trig.py:76-83",
        "the DCT-II of integer and bool data takes JAX's float32 transform "
        "and multiplies float64 twiddles: 4.8e-10 to 1.7e-8 of max from "
        "scipy"),
     {"dct2": NARROW, "dct2_ortho": NARROW, "dct2_forward": NARROW,
      "idct3": NARROW, "dctn": NARROW}),
    (reference_defect(
        "xrft_tpu/trig.py:52-58",
        "_fdtype keeps float16, so the DCT-III, DST-III and type-IV paths "
        "of float16 data round their twiddles, norm factors and matrices to "
        "float16: 6.1e-5 to 2.9e-4 of max from scipy"),
     {"dct3": ("float16",), "dct4": ("float16",), "idct2": ("float16",),
      "idct2_ortho": ("float16",), "idct2_forward": ("float16",),
      "idct4": ("float16",), "dst3": ("float16",), "dst4": ("float16",),
      "idst2": ("float16",), "idst2_ortho": ("float16",),
      "idst2_forward": ("float16",), "idst4": ("float16",),
      "idctn": ("float16",), "idstn": ("float16",)}),
    (reference_defect(
        "xrft_tpu/trig.py:159",
        "DST-I negates the raw data: uint8 wraps around (2.0 of max from "
        "scipy) and bool raises"),
     {"dst1": ("uint8", "bool"), "idst1": ("uint8", "bool")}),
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
