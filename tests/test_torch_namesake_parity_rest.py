"""A tier-1 dtype sweep of the other namesakes against xrft_tpu.

``hilbert``, ``hilbert2``, ``envelope``, ``czt``, ``zoom_fft``,
``resample``, ``fftconvolve``, ``oaconvolve`` (also in blocks, with 9 taps),
``convolve`` and ``correlate`` (each also on the direct route, with 9 taps),
``fht``, ``ifht``, ``stft``, ``istft``, ``lombscargle``, ``fft64`` and
``ifft64`` on the ten dtypes of ``test_torch_fuzz_parity.py`` (its seeded
values) under each ``fft_impl``, with 256 points along each transformed dim
(a 256 x 256 grid for ``hilbert2``), so "kernel" runs.  Each case is parity
with the reference or the same error (``torch_parity.NamesakeSweep``); a
float16 call is also the float32 call on the same values, bit for bit.
Where the reference is wrong its parity case is a strict xfail, and the
port is held to scipy or numpy on the float64 values instead.  A complex32
tensor, given to the port alone, is the complex64 data; no complex32 tensor
reaches a transform's route.
"""

import warnings

import numpy as np
import pytest
import scipy.fft as sf
import scipy.signal as sps

torch = pytest.importorskip("torch")

import xrft_tpu_torch as xt
from test_torch_fuzz_parity import values
from torch_parity import (IMPLS, NamesakeSweep, namesake_cases,
                          reference_defect)
from xrft_tpu_torch.config import fft_impl
from xrft_tpu_torch.labeled import LabeledArray
from xrft_tpu_torch.ops import fft_core

X = np.arange(256) * 0.5
FREQS = np.linspace(0.1, 2.0, 64)
FHT = dict(dln=0.05, mu=0.5)


def _taps(b):
    """A 9-point kernel along x: the first 9 samples of b's first row."""
    return b.isel(y=0, x=slice(0, 9))


def _rows(fn):
    """``fn`` of each pair of rows, stacked."""
    return lambda x, y: np.stack([fn(u, v) for u, v in zip(x, y)])


ENTRIES = {
    "hilbert": ("row", lambda m, a, b: m.hilbert(a, dim="x"),
                lambda x, y: sps.hilbert(x, axis=-1)),
    "hilbert2": ("grid", lambda m, a, b: m.hilbert2(a, dim=["y", "x"]),
                 lambda x, y: sps.hilbert2(x)),
    "envelope": ("row", lambda m, a, b: m.envelope(a, dim="x"),
                 lambda x, y: np.abs(sps.hilbert(x, axis=-1))),
    "czt": ("row", lambda m, a, b: m.czt(a, dim="x", m=100),
            lambda x, y: sps.czt(x, m=100, axis=-1)),
    "zoom_fft": ("row", lambda m, a, b: m.zoom_fft(a, [0.1, 0.6], m=100,
                                                   dim="x"),
                 lambda x, y: sps.zoom_fft(x, [0.1, 0.6], m=100, fs=2.0,
                                           axis=-1)),
    "resample": ("row", lambda m, a, b: m.resample(a, 384, dim="x"),
                 lambda x, y: sps.resample(x, 384, axis=-1)),
    "fftconvolve": ("row", lambda m, a, b: m.fftconvolve(a, b, dims="x"),
                    lambda x, y: sps.fftconvolve(x, y, axes=-1)),
    "oaconvolve": ("row", lambda m, a, b: m.oaconvolve(a, b, dims="x"),
                   lambda x, y: sps.oaconvolve(x, y, axes=-1)),
    "convolve": ("row", lambda m, a, b: m.convolve(a, b, dims="x"),
                 lambda x, y: sps.convolve(x, y)),
    "correlate": ("row", lambda m, a, b: m.correlate(a, b, dims="x"),
                  _rows(sps.correlate)),
    # overlap-add in blocks of 256 (a 9-tap kernel) and the direct route
    # (one cuDNN convolution on the card)
    "oaconvolve_blocks": ("row", lambda m, a, b: m.oaconvolve(
        a, _taps(b), dims="x"),
        lambda x, y: np.stack([sps.oaconvolve(u, y[0, :9]) for u in x])),
    "convolve_direct": ("row", lambda m, a, b: m.convolve(
        a, _taps(b), dims="x", method="direct"),
        lambda x, y: np.stack([sps.convolve(u, y[0, :9]) for u in x])),
    "correlate_direct": ("row", lambda m, a, b: m.correlate(
        a, _taps(b), dims="x", method="direct"),
        lambda x, y: np.stack([sps.correlate(u, y[0, :9]) for u in x])),
    "fht": ("row", lambda m, a, b: m.fht(a, dim="x", **FHT),
            lambda x, y: sf.fht(x, **FHT)),
    "ifht": ("row", lambda m, a, b: m.ifht(a, dim="x", **FHT),
             lambda x, y: sf.ifht(x, **FHT)),
    "stft": ("long", lambda m, a, b: m.stft(a, dim="x", seglen=256), None),
    "istft": ("long", lambda m, a, b: m.istft(m.stft(a, dim="x",
                                                     seglen=256)), None),
    "lombscargle": ("row", lambda m, a, b: m.lombscargle(a, FREQS, dim="x"),
                    _rows(lambda u, v: sps.lombscargle(X, u, FREQS))),
    # xrft's fft: fftshifted, times the spacing; x starts at 0, so no phase
    "fft64": ("row", lambda m, a, b: m.fft64(a, dim="x"),
              lambda x, y: np.fft.fftshift(np.fft.fft(x, axis=-1),
                                           axes=-1) * 0.5),
    "ifft64": ("row", lambda m, a, b: m.ifft64(a, dim="x"), None),
}

NARROW = ("int16", "int32", "uint8", "bool")
DEFECTS = [
    (reference_defect(
        "xrft_tpu/fht.py:151",
        "fht and ifht hand integer and bool data to JAX's float32 rfft and "
        "multiply the float64 kernel: 5.8e-8 to 7.2e-8 of max from scipy"),
     {"fht": NARROW, "ifht": NARROW}),
    (reference_defect(
        "xrft_tpu/fht.py:151",
        "fht and ifht of float16 data of even length raise in JAX's rfft "
        "(\"RFFT input must be float32 or float64\"), where scipy and the "
        "port compute them in float32"),
     {"fht": ("float16",), "ifht": ("float16",)}),
    (reference_defect(
        "xrft_tpu/convolve.py:252,266",
        "oaconvolve of float16 data in blocks raises in JAX's rfft (\"RFFT "
        "input must be float32 or float64\"), where fftconvolve, scipy and "
        "the port compute it in float32"),
     {"oaconvolve_blocks": ("float16",)}),
    (reference_defect(
        "xrft_tpu/convolve.py:397-399",
        "the direct route convolves float16 data in float16: 4.5e-4 of max "
        "from scipy"),
     {"convolve_direct": ("float16",), "correlate_direct": ("float16",)}),
    (reference_defect(
        "xrft_tpu/lombscargle.py:158-160",
        "lombscargle computes float16 data in float16, its moments and "
        "basis rounded to float16: 4.6e-4 of max from scipy"),
     {"lombscargle": ("float16",)}),
    (reference_defect(
        "xrft_tpu/ops/df64_fft.py:62-69",
        "a JAX float64 array is not an np.ndarray, so fft64 rounds real "
        "float64 data to float32: 9.4e-9 of max from numpy"),
     {"fft64": ("float64",)}),
]
CASES, DEFECT_CASES = namesake_cases(ENTRIES, DEFECTS)
SWEEP = NamesakeSweep(ENTRIES, values, double=("fft64", "ifft64"))


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


def _half_pair():
    """complex64 values rounded to complex32: (complex32, complex64)."""
    x = torch.as_tensor(values("complex64", (4, 256), 1))
    with warnings.catch_warnings():     # "ComplexHalf ... experimental"
        warnings.simplefilter("ignore")
        x32 = x.to(torch.complex32)
    return x32, x32.to(torch.complex64)


@pytest.mark.parametrize("impl", IMPLS)
def test_complex32_reaches_no_route(impl, monkeypatch):
    """A complex32 tensor given to fft_core's transforms and to fft (with
    and without a detrend and a window) is transformed as complex64, bit for
    bit, and never reaches torch.fft, K2, the K4 recursion or the matmul
    engines in complex32; a real transform of it raises as one of
    complex64 data does."""
    seen = []

    def spy(name, fn):
        def route(x, *args, **kwargs):
            seen.append((name, x.dtype))
            return fn(x, *args, **kwargs)
        return route

    monkeypatch.setattr(torch.fft, "fftn", spy("torch", torch.fft.fftn))
    for name in ("fft_last", "fftn64", "matmul_fft_nd"):
        monkeypatch.setattr(fft_core, name, spy(name,
                                                getattr(fft_core, name)))
    x32, x64 = _half_pair()

    def labeled(x):
        return LabeledArray(x, dims=("y", "x"),
                            coords={"y": np.arange(4) * 2.0, "x": X})

    with fft_impl(impl):
        for fn in (fft_core.fftn, fft_core.ifftn):
            got, want = fn(x32, [1]), fn(x64, [1])
            assert got.dtype == torch.complex64 and torch.equal(got, want)
        for kw in ({}, dict(detrend="linear", window="hann")):
            got, want = (xt.fft(labeled(x), dim="x", **kw) for x in (x32,
                                                                     x64))
            assert got.data.dtype == torch.complex64
            assert torch.equal(got.data, want.data)
        for x in (x32, x64):
            with pytest.raises(ValueError, match="only real valued inputs"):
                fft_core.rfftn(x, [1])
    assert seen and all(d != torch.complex32 for _, d in seen), seen


def test_from_reference_carries_float16():
    """interop.from_reference carries float16 numpy data as a float16
    tensor (the sweep's float16 cases start from it), values unchanged."""
    (ra, _), (pa, _) = SWEEP.inputs("float16", "row")
    assert pa.data.dtype == torch.float16
    np.testing.assert_array_equal(pa.values, np.asarray(ra.values))
