"""lombscargle of xrft_tpu_torch against xrft_tpu on the CPU, case for case
as ``tests/test_lombscargle.py``: every normalize mode with and without a
floating mean, weights, batch dims, a transform dim that is not last, peak
and amplitude recovery, datetime coordinates, float32, the error contracts
and the attrs.  The moments run in float64 on the data's device; the one
product at full float32 grade.  No FFT, so fft_impl does not apply.
Tolerances: 1e-12 (float64) and 2e-6 (float32) of the largest |value|."""

import sys

import numpy as np
import pytest
import scipy.signal as sps

torch = pytest.importorskip("torch")

import xrft_tpu_torch as xt
from torch_parity import check, pair

# the module (the package's attribute of that name is the function)
ls_module = sys.modules["xrft_tpu_torch.lombscargle"]


def _uneven(n, rng, span=30.0):
    t = np.sort(rng.uniform(0.0, span, n))
    t[0] = 0.0
    return t


@pytest.mark.parametrize("normalize", [False, True, "power", "normalize",
                                       "amplitude"])
@pytest.mark.parametrize("floating_mean", [False, True])
def test_parity_modes(normalize, floating_mean):
    rng = np.random.RandomState(0)
    t = _uneven(111, rng)
    y = 2.0 * np.cos(1.3 * t + 0.4) + 0.7 + 0.3 * rng.randn(111)
    freqs = np.linspace(0.2, 6.0, 257)
    ref, da = pair(y, ["t"], {"t": t})
    got, _ = check("lombscargle", [ref, freqs], [da, freqs], "torch", 1e-12,
                   dim="t", normalize=normalize, floating_mean=floating_mean)
    want = sps.lombscargle(t, y, freqs, normalize=normalize,
                           floating_mean=floating_mean)
    np.testing.assert_allclose(got.values, want, rtol=1e-9, atol=1e-12)
    assert got.dims == ("freq_t",)


@pytest.mark.parametrize("normalize", [False, True, "amplitude"])
@pytest.mark.parametrize("floating_mean", [False, True])
def test_parity_weighted(floating_mean, normalize):
    rng = np.random.RandomState(1)
    t = _uneven(90, rng)
    y = np.sin(2.1 * t) + 0.2 * rng.randn(90)
    wts = rng.uniform(0.1, 2.0, 90)
    wts[5] = 0.0
    freqs = np.linspace(0.3, 5.0, 128)
    ref, da = pair(y, ["t"], {"t": t})
    check("lombscargle", [ref, freqs], [da, freqs], "torch", 1e-12,
          normalize=normalize, weights=wts, floating_mean=floating_mean)


def test_batched_matches_per_row():
    rng = np.random.RandomState(2)
    t = _uneven(64, rng)
    freqs = np.linspace(0.5, 4.0, 97)
    ref, da = pair(rng.randn(5, 64), ["batch", "t"],
                   {"t": t, "batch": np.arange(5)})
    check("lombscargle", [ref, freqs], [da, freqs], "torch", 1e-12, dim="t",
          floating_mean=True)


@pytest.mark.parametrize("normalize", [False, True, "amplitude"])
def test_transform_dim_not_last(normalize):
    rng = np.random.RandomState(3)
    t = _uneven(48, rng)
    freqs = np.linspace(0.5, 4.0, 33)
    ref, da = pair(rng.randn(48, 3), ["t", "z"], {"t": t})
    got, _ = check("lombscargle", [ref, freqs], [da, freqs], "torch", 1e-12,
                   dim="t", normalize=normalize)
    assert got.dims == ("freq_t", "z")


def test_frequency_blocks(monkeypatch):
    """The float64 moments are built frequency block by frequency block;
    blocks of a few frequencies give the one-block values."""
    rng = np.random.RandomState(10)
    t = _uneven(64, rng)
    freqs = np.linspace(0.5, 4.0, 50)
    ref, da = pair(rng.randn(2, 64), ["z", "t"], {"t": t})
    monkeypatch.setattr(ls_module, "_BLOCK_ELEMENTS", 64 * 7)
    for normalize in (False, "amplitude"):
        check("lombscargle", [ref, freqs], [da, freqs], "torch", 1e-12,
              normalize=normalize, floating_mean=True)


def test_peak_and_amplitude_recovery():
    rng = np.random.RandomState(4)
    t = _uneven(400, rng, span=60.0)
    A, w0, phi, c = 1.7, 2.4, 0.6, 3.0
    ref, da = pair(A * np.cos(w0 * t + phi) + c, ["t"], {"t": t})
    freqs = np.linspace(0.5, 5.0, 2048)
    p, _ = check("lombscargle", [ref, freqs], [da, freqs], "torch", 1e-12,
                 floating_mean=True)
    assert abs(freqs[np.argmax(p.values)] - w0) < 0.01
    amp, _ = check("lombscargle", [ref, np.array([w0])],
                   [da, np.array([w0])], "torch", 1e-12,
                   normalize="amplitude", floating_mean=True)
    amp = amp.values[0]
    assert abs(abs(amp) - A) < 1e-3
    assert abs(amp.real - A * np.cos(phi)) < 1e-3
    assert abs(amp.imag + A * np.sin(phi)) < 1e-3


def test_even_grid_matches_periodogram_shape():
    n = 256
    t = np.arange(n) / 16.0
    ref, da = pair(np.cos(2 * np.pi * 1.5 * t), ["t"], {"t": t})
    w = np.array([2 * np.pi * 1.5])
    got, _ = check("lombscargle", [ref, w], [da, w], "torch", 1e-12)
    assert abs(got.values[0] - n / 4.0) / (n / 4.0) < 1e-6


def test_datetime_coordinate():
    rng = np.random.RandomState(5)
    tsec = np.sort(rng.uniform(0, 3600.0, 80))
    tsec[0] = 0.0
    tns = np.datetime64("2001-01-01") + (tsec * 1e9).astype("timedelta64[ns]")
    y = np.sin(0.01 * tsec) + 0.1 * rng.randn(80)
    freqs = np.linspace(0.002, 0.05, 64)
    ref_dt, da_dt = pair(y, ["t"], {"t": tns})
    got, _ = check("lombscargle", [ref_dt, freqs], [da_dt, freqs], "torch",
                   1e-12)
    _, da_num = pair(y, ["t"], {"t": tsec})
    np.testing.assert_allclose(got.values,
                               xt.lombscargle(da_num, freqs).values,
                               rtol=1e-7)


@pytest.mark.parametrize("normalize", [False, True, "amplitude"])
def test_float32_input_stays_float32(normalize):
    rng = np.random.RandomState(7)
    t = _uneven(640, rng)
    freqs = np.linspace(0.5, 3.0, 160)
    ref, da = pair(rng.randn(3, 640).astype(np.float32), ["z", "t"],
                   {"t": t})
    got, _ = check("lombscargle", [ref, freqs], [da, freqs], "torch", 2e-6,
                   normalize=normalize, floating_mean=True)
    assert got.data.dtype == (torch.complex64 if normalize == "amplitude"
                              else torch.float32)


def test_error_contracts():
    rng = np.random.RandomState(8)
    t = _uneven(32, rng)
    _, da = pair(rng.randn(32), ["t"], {"t": t})
    freqs = np.linspace(0.5, 3.0, 8)
    with pytest.raises(ValueError, match="no coordinate"):
        xt.lombscargle(pair(rng.randn(32), ["t"])[1], freqs)
    with pytest.raises(ValueError, match="must be real"):
        xt.lombscargle(pair(rng.randn(32) + 1j * rng.randn(32), ["t"],
                            {"t": t})[1], freqs)
    with pytest.raises(ValueError, match="freqs must be a 1-D"):
        xt.lombscargle(da, np.zeros((2, 2)))
    with pytest.raises(ValueError, match="non-negative entries"):
        xt.lombscargle(da, freqs, weights=-np.ones(32))
    with pytest.raises(ValueError, match="equal non-zero length"):
        xt.lombscargle(da, freqs, weights=np.ones(5))
    with pytest.raises(ValueError, match="Normalize must be"):
        xt.lombscargle(da, freqs, normalize="bogus")
    with pytest.raises(ValueError, match="must be numeric or datetime"):
        xt.lombscargle(pair(rng.randn(3), ["t"],
                            {"t": np.array(["a", "b", "c"])})[1], freqs)


def test_attrs_and_other_coords_pass_through():
    rng = np.random.RandomState(9)
    t = _uneven(40, rng)
    ref, da = pair(rng.randn(2, 40), ["z", "t"],
                   {"t": t, "z": np.array([1.5, 2.5])}, name="temp",
                   attrs={"units": "K"})
    out, _ = check("lombscargle", [ref, np.linspace(0.5, 2.0, 8)],
                   [da, np.linspace(0.5, 2.0, 8)], "torch", 1e-12, dim="t")
    assert out.attrs == {"units": "K"} and out.name == "temp"
