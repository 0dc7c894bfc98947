"""The doc-notebook acceptance cases of ``tests/test_doc_examples.py`` on
xrft_tpu_torch: the truncated-cosine sinc pair, true phase on an
uncentered odd grid, Parseval, the chunk (Welch segment) example and the
MITgcm-style batched analysis.  Each step runs the same seeded input
through both packages on the CPU (``torch_parity.both``) and keeps the
original's analytic or numpy oracle on the port's result.  The original's
native/split representations become the port's ``fft_impl`` routes.
"""

import numpy as np
import numpy.testing as npt
import pytest

torch = pytest.importorskip("torch")

import xrft_tpu
import xrft_tpu_torch as xt
from xrft_tpu import LabeledArray
from xrft_tpu_torch.config import fft_impl

from torch_parity import IMPLS, assert_same, both, port_arg


@pytest.mark.parametrize("impl", IMPLS)
def test_theoretical_sinc_matching(impl):
    f0, T, dx = 2.0, 4.0, 1e-4
    x = np.arange(-6 * T, 5 * T, dx)
    y = np.cos(2.0 * np.pi * f0 * x)
    y[np.abs(x) >= (T / 2.0)] = 0.0
    da = LabeledArray(y, dims=("x",), coords={"x": x})
    S, _ = both("fft", da, dim="x", true_phase=True, true_amplitude=True,
                impl=impl)
    k = S["freq_x"].values
    TF_s = T / 2 * (np.sinc(T * (k - f0)) + np.sinc(T * (k + f0)))
    npt.assert_allclose(S.values, TF_s.astype(complex), rtol=1e-8,
                        atol=1e-3)


@pytest.mark.parametrize("impl", IMPLS)
def test_true_phase_uncentered_odd(impl):
    f0, T, dx = 2.0, 4.0, 0.02
    x = np.arange(-8 * T, 5 * T + dx, dx)
    y = np.cos(2 * np.pi * f0 * x)
    y[np.abs(x) >= (T / 2.0)] = 0.0
    lag = x[len(x) // 2]
    f = np.fft.fftfreq(len(x), dx)
    expected = np.fft.fft(np.fft.ifftshift(y)) * np.exp(
        -1j * 2.0 * np.pi * f * lag)
    da = LabeledArray(y, dims=("x",), coords={"x": x})
    out, out_ref = both("fft", da, dim="x", true_phase=True,
                        true_amplitude=False, shift=False, impl=impl)
    npt.assert_allclose(out.values, expected, atol=1e-10)
    npt.assert_allclose(out["freq_x"].values, f)
    ida, _ = both("ifft", out_ref, true_phase=True, true_amplitude=False,
                  lag=lag, shift=True, impl=impl)
    npt.assert_allclose(ida.values.real, y, atol=1e-10)
    npt.assert_allclose(ida["x"].values, x, atol=1e-9)
    # the port's own inverse of its own transform
    with fft_impl(impl):
        own = xt.ifft(out, true_phase=True, true_amplitude=False, lag=lag,
                      shift=True)
    npt.assert_allclose(own.values.real, y, atol=1e-10)


@pytest.mark.parametrize("impl", IMPLS)
def test_parseval_example(impl):
    rng = np.random.RandomState(42)
    Nx, Ny = 40, 60
    dx, dy = rng.rand(), rng.rand()
    xc = dx * (np.arange(-Nx // 2, -Nx // 2 + Nx)
               + rng.randint(-Nx // 2, Nx // 2))
    yc = dy * (np.arange(-Ny // 2, -Ny // 2 + Ny)
               + rng.randint(-Ny // 2, Ny // 2))
    sig = rng.rand(Nx, Ny) + 1j * rng.rand(Nx, Ny)
    da2 = LabeledArray(sig, dims=["x", "y"], coords={"x": xc, "y": yc})
    FT2, _ = both("fft", da2, dim=["x", "y"], true_phase=True,
                  true_amplitude=True, impl=impl)
    npt.assert_allclose(
        (np.abs(FT2.values) ** 2).sum()
        * FT2["freq_x"].attrs["spacing"] * FT2["freq_y"].attrs["spacing"],
        (np.abs(sig) ** 2).sum() * dx * dy, rtol=1e-10)


def test_chunk_example_segments():
    n = 2 ** 8
    vals = np.random.RandomState(0).rand(n, n // 2, n // 2)
    da = LabeledArray(vals, dims=["time", "y", "x"])
    daft, _ = both("fft", da.chunk({"time": n // 4}), dim=["time"],
                   shift=False, chunks_to_segments=True, true_phase=False,
                   true_amplitude=False)
    assert daft.dims == ("time_segment", "freq_time", "y", "x")
    npt.assert_allclose(daft.values,
                        np.fft.fftn(vals.reshape(4, n // 4, n // 2, n // 2),
                                    axes=[1]), atol=1e-8)
    ps, ps_ref = both("power_spectrum", da.chunk({"time": n // 4}),
                      dim=["time"], chunks_to_segments=True)
    ps_m, _ = both(lambda m: lambda d: d.mean(["time_segment", "y", "x"]),
                   ps_ref)
    assert ps_m.dims == ("freq_time",)
    assert ps_m.sizes["freq_time"] == n // 4
    npt.assert_allclose(ps.mean(["time_segment", "y", "x"]).values,
                        ps_m.values, rtol=1e-12)


@pytest.mark.parametrize("impl", IMPLS)
def test_mitgcm_style_batched_analysis(impl):
    T, Z, N = 3, 2, 64
    rng = np.random.RandomState(7)
    w = rng.randn(T, Z, N, N)
    b = rng.randn(T, Z, N, N)
    coords = {"YC": np.arange(N) * 20e3, "XC": np.arange(N) * 20e3}
    wa = LabeledArray(w, dims=["time", "Zl", "YC", "XC"], coords=coords)
    ba = LabeledArray(b, dims=["time", "Zl", "YC", "XC"], coords=coords)
    kw = dict(dim=["XC", "YC"], detrend="linear", window="hann", impl=impl)

    what, _ = both("fft", wa, true_phase=False, true_amplitude=False, **kw)
    ps, _ = both("power_spectrum", wa, **kw)
    cs, _ = both("cross_spectrum", wa, ba, true_phase=False, **kw)
    iso, _ = both("isotropic_power_spectrum", wa.isel(time=0, Zl=0),
                  dim=["YC", "XC"], detrend="linear", window="hann",
                  impl=impl)
    assert what.dims == ("time", "Zl", "freq_YC", "freq_XC")
    assert iso.dims == ("freq_r",)

    sub = LabeledArray(w[1, 1], dims=["YC", "XC"], coords=coords)
    ps_sub, _ = both("power_spectrum", sub, **kw)
    npt.assert_allclose(ps.isel(time=1, Zl=1).values, ps_sub.values,
                        rtol=1e-8, atol=1e-12)
    cs_sub, _ = both(
        "cross_spectrum",
        LabeledArray(w[0, 0], dims=["YC", "XC"], coords=coords),
        LabeledArray(b[0, 0], dims=["YC", "XC"], coords=coords),
        true_phase=False, **kw)
    npt.assert_allclose(cs.isel(time=0, Zl=0).values, cs_sub.values,
                        rtol=1e-8, atol=1e-12)


def test_window_true_legacy():
    """window=True maps to 'hann' with the same FutureWarning."""
    da = LabeledArray(np.random.RandomState(3).rand(16), dims=["x"],
                      coords={"x": np.arange(16.0)})
    kw = dict(true_phase=False, true_amplitude=False)
    with pytest.warns(FutureWarning, match="boolean") as w_ref:
        want = xrft_tpu.fft(da, window=True, **kw)
    with pytest.warns(FutureWarning, match="boolean") as w_got:
        a = xt.fft(port_arg(da), window=True, **kw)
    assert [str(w.message) for w in w_got] == \
        [str(w.message) for w in w_ref]
    assert_same(a, want, 1e-12)
    b = xt.fft(port_arg(da), window="hann", **kw)
    npt.assert_allclose(a.values, b.values, rtol=1e-12)
