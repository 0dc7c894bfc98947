"""Configurations 1, 2 and 4 of ``tests/test_baseline_configs.py``
(``:19``, ``:41``, ``:77``) on xrft_tpu_torch at the same test scale: each
call runs the same seeded input through both packages on the CPU
(``torch_parity.both``) under every ``fft_impl``, and the original's numpy
oracle holds the port's result.  (Configuration 3 is in
``test_torch_isotropic.py``, configuration 5 in ``test_torch_parallel.py``.)
"""

import numpy as np
import numpy.testing as npt
import pytest
import scipy.signal as sps

torch = pytest.importorskip("torch")

import xrft_tpu_torch as xt
from xrft_tpu import LabeledArray
from xrft_tpu_torch.config import fft_impl

from torch_parity import IMPLS, assert_circle, both, phase_same, port_arg


@pytest.mark.parametrize("impl", IMPLS)
def test_config1_1d_roundtrip_and_ps(impl):
    """1-D fft/ifft round trip and power_spectrum of a 1024-point signal
    (detrend='constant')."""
    N = 1024
    t = np.arange(N) * 1e-3
    sig = np.random.RandomState(0).randn(N)
    da = LabeledArray(sig, dims=["t"], coords={"t": t})

    F, F_ref = both("fft", da, detrend="constant", true_phase=True,
                    true_amplitude=True, impl=impl)
    back, _ = both("ifft", F_ref, true_phase=True, true_amplitude=True,
                   lag=t[N // 2], impl=impl)
    npt.assert_allclose(back.values.real, sig - sig.mean(), atol=1e-10)
    with fft_impl(impl):
        own = xt.ifft(F, true_phase=True, true_amplitude=True,
                      lag=t[N // 2])
    npt.assert_allclose(own.values.real, sig - sig.mean(), atol=1e-10)

    ps, _ = both("power_spectrum", da, dim="t", detrend="constant",
                 impl=impl)
    prime = sig - sig.mean()
    ref = np.abs(np.fft.fftshift(np.fft.fft(prime)) * 1e-3) ** 2 / (N * 1e-3)
    npt.assert_allclose(ps.values, ref, rtol=1e-9, atol=1e-12)


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
@pytest.mark.parametrize("impl", IMPLS)
def test_config2_2d_ps_linear_detrend_hann(impl, dtype):
    """2-D power_spectrum with linear detrend and Hann window (an SSH
    field at 256^2), in float64 and, as the flagship runs, float32 (held
    to 2e-6 of max)."""
    N = 256
    rng = np.random.RandomState(1)
    ssh = (rng.randn(N, N) + 0.01 * np.arange(N)[:, None]
           + 0.02 * np.arange(N)[None, :]).astype(dtype)
    dx = 20e3
    da = LabeledArray(ssh, dims=["YC", "XC"],
                      coords={"YC": np.arange(N) * dx,
                              "XC": np.arange(N) * dx})
    ps, _ = both("power_spectrum", da, dim=["YC", "XC"], detrend="linear",
                 window="hann", impl=impl)
    vp = xt.detrend(port_arg(da), ["YC", "XC"], "linear").values
    w = sps.windows.hann(N, sym=False)
    F = np.fft.fftshift(np.fft.fftn(vp.astype(np.float64)
                                    * (w * w[:, None]))) * dx * dx
    ref = np.abs(F) ** 2 * (1.0 / (N * dx)) ** 2
    if dtype == np.float64:
        npt.assert_allclose(ps.values, ref, rtol=1e-7,
                            atol=ref.max() * 1e-12)
    else:
        npt.assert_allclose(ps.values, ref, rtol=0, atol=ref.max() * 2e-6)


@pytest.mark.parametrize("impl", IMPLS)
def test_config4_cross_spectrum_rfft_time(impl):
    """cross_spectrum and cross_phase of paired (time, y, x) fields with
    an rfft over time (64 x 64 x 64)."""
    T, N = 64, 64
    rng = np.random.RandomState(3)
    u = rng.randn(T, N, N)
    v = np.roll(u, 3, axis=0) + 0.1 * rng.randn(T, N, N)
    dt = 3600.0
    coords = {"time": np.arange(T) * dt, "y": np.arange(N) * 1.0,
              "x": np.arange(N) * 1.0}
    da1 = LabeledArray(u, dims=["time", "y", "x"], coords=coords, name="u")
    da2 = LabeledArray(v, dims=["time", "y", "x"], coords=coords, name="v")
    kw = dict(dim=["time"], real_dim="time", true_phase=False, impl=impl)
    cs, _ = both("cross_spectrum", da1, da2, **kw)
    cp, _ = phase_same("cross_phase", da1, da2, **kw)
    assert cs.dims == ("freq_time", "y", "x")
    assert cp.name == "u_v_phase"
    npt.assert_allclose(cs.coords["freq_time"].values,
                        np.fft.rfftfreq(T, dt))
    F1 = np.fft.rfft(u, axis=0) * dt
    F2 = np.fft.rfft(v, axis=0) * dt
    cs_ref = F1 * np.conj(F2)
    dbl = np.full(T // 2 + 1, 2.0)
    dbl[0] = dbl[-1] = 1.0
    cs_ref *= dbl[:, None, None] / (T * dt)
    npt.assert_allclose(cs.values, cs_ref, rtol=1e-8,
                        atol=np.abs(cs_ref).max() * 1e-10)
    assert_circle(cp.values, np.angle(cs_ref), 1e-7)
