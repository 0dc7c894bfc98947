"""The spectral estimators of xrft_tpu_torch against xrft_tpu, following
``tests/test_spectra.py`` test for test.

Each test runs the same seeded numpy input through both packages on the CPU
(``torch_parity.both``: dims, name, attrs, coordinates, values to 1e-12 of
max in double precision and 2e-6 in single, and the same warnings; phases
through ``torch_parity.phase_same``) and keeps the original's scipy or
numpy oracle on the port's result.  The original's native/split
representations become the port's ``fft_impl`` routes.  Where the original
tests a piece of xrft_tpu that the port leaves out on purpose (the df64 hp
representation, ``hp_impl``; ROADMAP.md Queue 3), the test holds the port
to that divergence: its hp results are float64 and match float64 scipy.
"""

import numpy as np
import numpy.testing as npt
import pytest
import scipy.signal as sps

torch = pytest.importorskip("torch")

import xrft_tpu
import xrft_tpu_torch as xt
from xrft_tpu import LabeledArray

from torch_parity import (IMPLS, assert_circle, assert_same, both,
                          phase_same, port_arg, raises_same)


def then(name, method, *margs):
    """A callable of a package module: ``name(...)`` followed by
    ``.method(*margs)`` on its result."""
    return lambda m: lambda *a, **k: getattr(getattr(m, name)(*a, **k),
                                             method)(*margs)


def make_2d(N=16, seed=0):
    rng = np.random.RandomState(seed)
    return LabeledArray(rng.rand(N, N), dims=["x", "y"],
                        coords={"x": range(N), "y": range(N)})


def series(n=1200, fs=400.0, seed=7, f=30, trend=0.0):
    rng = np.random.RandomState(seed)
    tt = np.arange(n) / fs
    return tt, np.sin(2 * np.pi * f * tt) + 0.3 * rng.randn(n) + trend * tt


@pytest.mark.parametrize("impl", IMPLS)
def test_power_spectrum_periodogram_parity(impl):
    N = 16
    da = LabeledArray(np.random.RandomState(0).rand(N), dims=["x"],
                      coords={"x": range(N)})
    _, p_scipy = sps.periodogram(da.values, window="rectangular",
                                 return_onesided=True)
    ps, _ = both("power_spectrum", da, dim="x", real_dim="x",
                 detrend="constant", impl=impl)
    npt.assert_allclose(ps.values, p_scipy, atol=1e-11)


@pytest.mark.parametrize("detrend", [False, "constant", "linear"])
@pytest.mark.parametrize("noverlap", [0, 50])
def test_welch_detrend_scipy_parity(noverlap, detrend):
    fs, L = 400.0, 100
    tt, x = series(trend=0.005)
    da = LabeledArray(x, dims=["t"], coords={"t": tt}).chunk({"t": L})
    ps, _ = both(then("power_spectrum", "mean", "t_segment"), da, dim="t",
                 real_dim="t", window="hann", chunks_to_segments=True,
                 segment_overlap=noverlap or None, window_correction=True,
                 detrend=detrend or None)
    f_ref, p_ref = sps.welch(x, fs=fs, window="hann", nperseg=L,
                             noverlap=noverlap, detrend=detrend)
    npt.assert_allclose(ps["freq_t"].values, f_ref)
    npt.assert_allclose(ps.values, p_ref, rtol=1e-5,
                        atol=1e-8 * p_ref.max())


def test_median_welch_scipy_parity():
    fs, L = 400.0, 100
    tt, x = series()
    da = LabeledArray(x, dims=["t"], coords={"t": tt}).chunk({"t": L})
    kw = dict(dim="t", real_dim="t", window="hann", chunks_to_segments=True,
              window_correction=True)
    ps, _ = both("power_spectrum", da, **kw)
    med, _ = both(then("power_spectrum", "median", "t_segment"), da, **kw)
    nseg = ps.sizes["t_segment"]
    ii2 = 2 * np.arange(1.0, (nseg - 1) // 2 + 1)
    bias = 1 + np.sum(1.0 / (ii2 + 1) - 1.0 / ii2)
    _, p_ref = sps.welch(x, fs=fs, window="hann", nperseg=L, noverlap=0,
                         detrend=False, average="median")
    npt.assert_allclose(med.values / bias, p_ref, rtol=1e-5,
                        atol=1e-8 * p_ref.max())


@pytest.mark.parametrize("noverlap", [0, 50, 30])
@pytest.mark.parametrize("window_type", ["hann", "boxcar"])
def test_one_sided_welch_scipy_parity(window_type, noverlap):
    fs, nperseg = 400.0, 100
    tt, x = series()
    x_da = LabeledArray(x, dims=["t"], coords={"t": tt}).chunk(
        {"t": nperseg})
    ps, _ = both(then("power_spectrum", "mean", "t_segment"), x_da,
                 dim="t", real_dim="t", window=window_type,
                 chunks_to_segments=True, window_correction=True,
                 segment_overlap=noverlap or None)
    f_ref, p_ref = sps.welch(x, fs=fs, window=window_type, nperseg=nperseg,
                             noverlap=noverlap, detrend=False)
    npt.assert_allclose(ps["freq_t"].values, f_ref)
    npt.assert_allclose(ps.values, p_ref, rtol=1e-5,
                        atol=1e-8 * p_ref.max())


@pytest.mark.parametrize("noverlap", [0, 50])
def test_cross_spectrum_csd_scipy_parity(noverlap):
    fs, nperseg = 400.0, 100
    rng = np.random.RandomState(7)
    tt = np.arange(1200) / fs
    x = np.sin(2 * np.pi * 30 * tt) + 0.3 * rng.randn(tt.size)
    y = np.cos(2 * np.pi * 30 * tt) + 0.3 * rng.randn(tt.size)
    xa = LabeledArray(x, dims=["t"], coords={"t": tt}).chunk({"t": nperseg})
    ya = LabeledArray(y, dims=["t"], coords={"t": tt}).chunk({"t": nperseg})
    cs, _ = both(then("cross_spectrum", "mean", "t_segment"), xa, ya,
                 dim="t", real_dim="t", window="hann",
                 chunks_to_segments=True, window_correction=True,
                 segment_overlap=noverlap or None)
    f_ref, p_ref = sps.csd(x, y, fs=fs, window="hann", nperseg=nperseg,
                           noverlap=noverlap, detrend=False)
    npt.assert_allclose(cs["freq_t"].values, f_ref)
    npt.assert_allclose(cs.values, p_ref.conj(), rtol=1e-5,
                        atol=1e-7 * np.abs(p_ref).max())


@pytest.mark.parametrize("noverlap", [0, 50])
def test_coherence_scipy_parity(noverlap):
    fs, nperseg = 400.0, 100
    rng = np.random.RandomState(9)
    tt = np.arange(2000) / fs
    s = np.sin(2 * np.pi * 30 * tt)
    x = s + 0.5 * rng.randn(tt.size)
    y = 0.7 * s + 0.5 * rng.randn(tt.size)
    xa = LabeledArray(x, dims=["t"], coords={"t": tt},
                      name="x").chunk({"t": nperseg})
    ya = LabeledArray(y, dims=["t"], coords={"t": tt},
                      name="y").chunk({"t": nperseg})
    coh, _ = both("coherence", xa, ya, dim="t", real_dim="t", window="hann",
                  chunks_to_segments=True, segment_overlap=noverlap or None)
    f_ref, c_ref = sps.coherence(x, y, fs=fs, window="hann",
                                 nperseg=nperseg, noverlap=noverlap,
                                 detrend=False)
    assert coh.name == "x_y_coherence"
    npt.assert_allclose(coh["freq_t"].values, f_ref)
    npt.assert_allclose(coh.values, c_ref, rtol=1e-4, atol=1e-6)
    v = coh.values
    assert v.min() >= 0.0 and v.max() <= 1.0 + 1e-9
    assert v[np.argmin(np.abs(f_ref - 30.0))] > 0.9


def test_coherence_hp_engine():
    """The port's hp coherence stays float64 (ROADMAP.md Queue 3; xrft_tpu
    degrades its df64 estimates to float32 for the ratio): it equals the
    float64 coherence of both packages at 1e-12, and the hp reference at
    float32's grade."""
    rng = np.random.RandomState(3)
    tt = np.arange(128) * 0.5
    xa = LabeledArray(np.sin(tt) + 0.3 * rng.randn(128), dims=["t"],
                      coords={"t": tt}).chunk({"t": 32})
    ya = LabeledArray(0.5 * np.sin(tt) + 0.3 * rng.randn(128), dims=["t"],
                      coords={"t": tt}).chunk({"t": 32})
    coh64, want64 = both("coherence", xa, ya, dim="t",
                         chunks_to_segments=True)
    coh_hp = xt.coherence(port_arg(xa), port_arg(ya), dim="t",
                          chunks_to_segments=True, engine="hp")
    assert coh_hp.values.dtype == np.float64
    assert_same(coh_hp, want64, 1e-12)
    ref_hp = xrft_tpu.coherence(xa, ya, dim="t", chunks_to_segments=True,
                                engine="hp")
    npt.assert_allclose(coh_hp.values, np.asarray(ref_hp.values), rtol=1e-4,
                        atol=1e-6)


def test_segment_overlap_chunklen_exceeds_axis_raises():
    da = LabeledArray(np.random.RandomState(1).rand(128), dims=["t"],
                      coords={"t": np.arange(128.0)}).chunk({"t": 200})
    e = raises_same("power_spectrum", da, dim="t", chunks_to_segments=True,
                    segment_overlap=50)
    assert "exceeds dim" in str(e)


def test_coherence_unsegmented_warns_identically_one():
    rng = np.random.RandomState(2)
    tt = np.arange(64.0)
    xa = LabeledArray(rng.randn(64), dims=["t"], coords={"t": tt})
    ya = LabeledArray(rng.randn(64), dims=["t"], coords={"t": tt})
    coh, _ = both("coherence", xa, ya, dim="t",
                  warns=(UserWarning, "identically 1"))
    npt.assert_allclose(coh.values, 1.0, rtol=1e-5)


def test_segment_overlap_fraction_and_errors():
    rng = np.random.RandomState(3)
    x = rng.randn(128)
    da = LabeledArray(x, dims=["t"], coords={"t": np.arange(128.0)})
    dac = da.chunk({"t": 32})
    ps_frac, _ = both("power_spectrum", dac, dim="t",
                      chunks_to_segments=True, segment_overlap=0.5)
    ps_samp, _ = both("power_spectrum", dac, dim="t",
                      chunks_to_segments=True, segment_overlap=16)
    assert ps_frac.sizes["t_segment"] == (128 - 32) // 16 + 1 == 7
    npt.assert_allclose(ps_frac.values, ps_samp.values)

    for fn, arr, kw, match in (
            ("power_spectrum", da, dict(segment_overlap=16),
             "requires chunks_to_segments"),
            ("fft", dac, dict(segment_overlap=16),
             "requires chunks_to_segments"),
            ("power_spectrum", dac, dict(chunks_to_segments=True,
                                         segment_overlap=32), "must be in"),
            ("power_spectrum", dac, dict(chunks_to_segments=True,
                                         segment_overlap=1.0), "must be in"),
            ("power_spectrum", dac, dict(chunks_to_segments=True,
                                         segment_overlap={"z": 4}),
             "non-transform dims")):
        assert match in str(raises_same(fn, arr, dim="t", **kw))

    da33 = da.chunk({"t": 33})
    ft, _ = both("fft", da33, dim="t", chunks_to_segments=True,
                 segment_overlap=10, true_phase=False, true_amplitude=False,
                 shift=False, warns=(UserWarning, "drops the last"))
    nseg = (128 - 33) // 23 + 1
    assert ft.sizes["t_segment"] == nseg
    manual = np.stack([np.fft.fft(x[i * 23:i * 23 + 33])
                       for i in range(nseg)])
    npt.assert_allclose(ft.values, manual, atol=1e-4)


def test_segment_overlap_2d_and_hp():
    rng = np.random.RandomState(5)
    da = LabeledArray(rng.randn(4, 64), dims=["y", "t"],
                      coords={"y": np.arange(4.0), "t": np.arange(64.0)})
    ps, _ = both("power_spectrum", da.chunk({"y": 2, "t": 16}),
                 dim=["y", "t"], chunks_to_segments=True,
                 segment_overlap={"t": 8})
    assert ps.sizes["y_segment"] == 2 and ps.sizes["t_segment"] == 7
    da1 = da.chunk({"t": 16})
    kw = dict(dim="t", chunks_to_segments=True, segment_overlap=8,
              detrend="constant", window="hann")
    ps32, _ = both("power_spectrum", da1, **kw)
    ps_hp, _ = both("power_spectrum", da1, engine="hp", tol=1e-10, **kw)
    npt.assert_allclose(ps_hp.values, ps32.values, rtol=2e-5, atol=1e-7)


@pytest.mark.parametrize("window_type",
                         ["hann", "bartlett", "tukey", "flattop"])
def test_window_correction_energy_and_amplitude(window_type):
    A, fs, fsig = 20, 1e4, 300
    n_segments = int(fs // 10)
    tt = np.arange(fs) / fs
    x_da = LabeledArray(A * np.sin(2 * np.pi * fsig * tt), dims=["t"],
                        coords={"t": tt}).chunk({"t": n_segments})
    kw = dict(dim="t", window=window_type, chunks_to_segments=True,
              window_correction=True)
    ps, _ = both(then("power_spectrum", "mean", "t_segment"), x_da, **kw)
    npt.assert_allclose(np.sqrt(np.trapezoid(ps.values,
                                             ps["freq_t"].values)),
                        A * np.sqrt(2) / 2, rtol=1e-3)
    ps, _ = both(then("power_spectrum", "mean", "t_segment"), x_da,
                 scaling="spectrum", **kw)
    i = int(np.argmin(np.abs(ps["freq_t"].values - fsig)))
    npt.assert_allclose(ps.values[i], 0.5 * A ** 2 / 2.0)


@pytest.mark.parametrize("scaling", ["density", "spectrum"])
@pytest.mark.parametrize("shape", [(12, 20), (6, 10, 14)])
def test_window_correction_without_an_nd_window(monkeypatch, shape,
                                                scaling):
    """The window correction of a 2-D and a 3-D spectrum is the N-D
    window's mean square (density) or squared mean (spectrum), to 1e-14
    of it, taken from the 1-D factors: no N-D window is built."""
    from xrft_tpu_torch import spectra
    from xrft_tpu_torch.ops import window

    def refuse(*a, **k):
        raise AssertionError("build_window called")

    monkeypatch.setattr(window, "build_window", refuse)
    dims = ["z", "y", "x"][-len(shape):]
    da = xt.LabeledArray(torch.zeros(shape, dtype=torch.float64), dims=dims)
    w = np.ones(())
    for n in shape:
        w = np.multiply.outer(w, sps.windows.tukey(n, sym=False))
    want = np.mean(w ** 2) if scaling == "density" else np.mean(w) ** 2
    got = spectra._window_correction_factor(da, dims, scaling, "tukey")
    assert abs(got - want) <= 1e-14 * want


def test_window_correction_requires_window():
    e = raises_same("power_spectrum", make_2d(), window=None,
                    window_correction=True)
    assert "window_correction" in str(e)


@pytest.mark.parametrize("chunks_to_segments", [False, True])
@pytest.mark.parametrize("impl", IMPLS)
def test_parseval(impl, chunks_to_segments):
    N = 16
    rng = np.random.RandomState(1)
    da = LabeledArray(rng.rand(N, N), dims=["x", "y"],
                      coords={"x": range(N), "y": range(N)})
    da2 = LabeledArray(rng.rand(N, N), dims=["x", "y"],
                       coords={"x": range(N), "y": range(N)})
    n_segments = 2 if chunks_to_segments else 1
    if chunks_to_segments:
        da = da.chunk({"x": N // 2, "y": N // 2})
        da2 = da2.chunk({"x": N // 2, "y": N // 2})
    fftdim = ["freq_x", "freq_y"]
    kw = dict(chunks_to_segments=chunks_to_segments, impl=impl)

    ps, _ = both(then("power_spectrum", "mean", fftdim), da, **kw)
    seg = N // n_segments
    vals = da.values.reshape(n_segments, seg, n_segments, seg) \
        if chunks_to_segments else da.values
    npt.assert_allclose(ps.values, (vals ** 2).mean(axis=(-3, -1))
                        if chunks_to_segments else (vals ** 2).mean(),
                        atol=1e-10)

    ps, _ = both(then("power_spectrum", "mean", fftdim), da, window="hann",
                 detrend="constant", **kw)
    w1 = sps.windows.hann(seg, sym=False)
    window = w1 * w1[:, np.newaxis]
    if chunks_to_segments:
        vprime = vals - vals.mean(axis=(-3, -1), keepdims=True)
        wv = vprime * window[None, :, None, :]
        expected = (wv ** 2).mean(axis=(-3, -1))
    else:
        vprime = vals - vals.mean()
        expected = ((vprime * window) ** 2).mean()
    npt.assert_allclose(ps.values, expected, atol=1e-10)

    cs, _ = both(then("cross_spectrum", "mean", fftdim), da, da2,
                 window="hann", detrend="constant", **kw)
    vals2 = da2.values.reshape(n_segments, seg, n_segments, seg) \
        if chunks_to_segments else da2.values
    if chunks_to_segments:
        v2prime = vals2 - vals2.mean(axis=(-3, -1), keepdims=True)
        w4 = window[None, :, None, :]
        expected = ((vprime * w4) * (v2prime * w4)).mean(axis=(-3, -1))
    else:
        v2prime = vals2 - vals2.mean()
        expected = ((vprime * window) * (v2prime * window)).mean()
    npt.assert_allclose(cs.values.real, expected, atol=1e-10)


@pytest.mark.parametrize("impl", IMPLS)
def test_parseval_dft_1d_2d(impl):
    rng = np.random.RandomState(2)
    Nx = 40
    dx = rng.rand()
    xcoord = dx * (np.arange(-Nx // 2, -Nx // 2 + Nx)
                   + rng.randint(-Nx // 2, Nx // 2))
    sig = rng.rand(Nx) + 1j * rng.rand(Nx)
    s = LabeledArray(sig, dims=["x"], coords={"x": xcoord})
    FTs, _ = both("fft", s, dim="x", true_phase=True, true_amplitude=True,
                  impl=impl)
    npt.assert_allclose((np.abs(sig) ** 2).sum() * dx,
                        (np.abs(FTs.values) ** 2).sum()
                        * FTs["freq_x"].attrs["spacing"], rtol=1e-10)
    Ny, dy = 60, rng.rand()
    ycoord = dy * (np.arange(-Ny // 2, -Ny // 2 + Ny)
                   + rng.randint(-Ny // 2, Ny // 2))
    sig2 = rng.rand(Nx, Ny) + 1j * rng.rand(Nx, Ny)
    s2 = LabeledArray(sig2, dims=("x", "y"),
                      coords={"x": xcoord, "y": ycoord})
    FTs2, _ = both("fft", s2, dim=("x", "y"), true_phase=True,
                   true_amplitude=True, impl=impl)
    npt.assert_allclose(
        (np.abs(sig2) ** 2).sum() * dx * dy,
        (np.abs(FTs2.values) ** 2).sum()
        * FTs2["freq_x"].attrs["spacing"] * FTs2["freq_y"].attrs["spacing"],
        rtol=1e-10)


@pytest.mark.parametrize("impl", IMPLS)
def test_cross_spectrum_conj_product(impl):
    N = 16
    da1, da2 = make_2d(N, 3), make_2d(N, 4)
    cs, _ = both("cross_spectrum", da1, da2, scaling="false_density",
                 true_phase=True, impl=impl)
    f1, _ = both("fft", da1, true_phase=True, true_amplitude=True,
                 impl=impl)
    f2, _ = both("fft", da2, true_phase=True, true_amplitude=True,
                 impl=impl)
    npt.assert_allclose(cs.values, f1.values * np.conj(f2.values),
                        atol=1e-12)


def test_cross_spectrum_dim_mismatch_raises():
    N = 8
    rng = np.random.RandomState(5)
    da1 = LabeledArray(rng.rand(N, N), dims=["x", "y"],
                       coords={"x": range(N), "y": range(N)})
    da2 = LabeledArray(rng.rand(N, N), dims=["x", "z"],
                       coords={"x": range(N), "z": range(N)})
    e = raises_same("cross_spectrum", da1, da2, dim=["x"])
    assert "different dimensions" in str(e)


@pytest.mark.parametrize("impl", IMPLS)
def test_cross_phase(impl):
    N = 64
    x = np.linspace(0, 8 * np.pi, N, endpoint=False)
    phase_shift = np.pi / 3
    da1 = LabeledArray(np.cos(x), dims=["x"], coords={"x": x}, name="a")
    da2 = LabeledArray(np.cos(x - phase_shift), dims=["x"], coords={"x": x},
                       name="b")
    cp, _ = phase_same("cross_phase", da1, da2, dim="x", impl=impl)
    assert cp.name == "a_b_phase"
    k = cp["freq_x"].values
    i = int(np.argmin(np.abs(k - 1.0 / (2 * np.pi))))
    assert_circle(cp.values[i], phase_shift, 1e-10)
    assert (np.abs(cp.values) <= np.pi + 1e-12).all()


@pytest.mark.parametrize("impl", IMPLS)
def test_real_dim_power_doubling(impl):
    for N in (16, 17):
        da = LabeledArray(np.random.RandomState(N).rand(N), dims=["x"],
                          coords={"x": range(N)})
        ps1, _ = both("power_spectrum", da, dim="x", real_dim="x",
                      impl=impl)
        ps2, _ = both("power_spectrum", da, dim="x", impl=impl)
        npt.assert_allclose(ps1.values.sum(), ps2.values.sum(), rtol=1e-10)


def test_segment_spectra_match_per_segment_loop():
    N, seg = 32, 16
    vals = np.random.RandomState(11).rand(N)
    da = LabeledArray(vals, dims=["t"], coords={"t": np.arange(N) * 0.5})
    ps_seg, _ = both("power_spectrum", da.chunk({"t": seg}), dim="t",
                     chunks_to_segments=True)
    assert ps_seg.dims == ("t_segment", "freq_t")
    for i in range(N // seg):
        sub = LabeledArray(vals[i * seg:(i + 1) * seg], dims=["t"],
                           coords={"t": np.arange(seg) * 0.5})
        ps_i, _ = both("power_spectrum", sub, dim="t")
        npt.assert_allclose(ps_seg.values[i], ps_i.values, atol=1e-12)


@pytest.mark.parametrize("func", ["power_spectrum", "cross_spectrum"])
def test_keep_multidim_coords(func):
    T, Y, X = 3, 8, 10
    lon = np.linspace(0, 1, Y * X).reshape(Y, X)
    da = LabeledArray(
        np.random.RandomState(0).rand(T, Y, X), dims=["time", "y", "x"],
        coords={"time": np.arange(T), "y": np.arange(Y), "x": np.arange(X),
                "lon": (("y", "x"), lon)})
    if func == "power_spectrum":
        ps, _ = both(func, da, dim="time")
    else:
        ps, _ = both(func, da, da, dim="time", true_phase=False)
    assert "lon" in ps.coords
    npt.assert_array_equal(ps.coords["lon"].values, lon)
    assert "y" in ps.coords and "x" in ps.coords


@pytest.mark.parametrize("impl", IMPLS)
def test_cross_spectrum_one_sided_fast_path_parity(impl):
    rng = np.random.RandomState(31)
    N = 24
    x = np.arange(N) * 0.5 + 3.0
    mk = lambda v, y=x: LabeledArray(v, dims=["y", "x"],
                                     coords={"y": y, "x": x})
    for kw in (dict(), dict(window="hann", scaling="spectrum"),
               dict(window="hann", window_correction=True),
               dict(detrend="linear"), dict(true_phase=False, shift=False),
               dict(scaling="false_density")):
        v1, v2 = rng.randn(N, N), rng.randn(N, N)
        fast, _ = both("cross_spectrum", mk(v1), mk(v2), dim=["y", "x"],
                       impl=impl, **kw)
        slow, _ = both("cross_spectrum", mk(v1.astype(np.complex128)),
                       mk(v2.astype(np.complex128)), dim=["y", "x"],
                       impl=impl, **kw)
        npt.assert_allclose(fast.values, slow.values,
                            atol=1e-11 * np.abs(slow.values).max())
        npt.assert_allclose(fast.coords["freq_x"].values,
                            slow.coords["freq_x"].values)
    v1, v2 = rng.randn(N, N), rng.randn(N, N)
    y = x[::-1].copy()
    fast, _ = both("cross_spectrum", mk(v1, y), mk(v2, y), dim=["y", "x"],
                   impl=impl)
    slow, _ = both("cross_spectrum", mk(v1.astype(np.complex128), y),
                   mk(v2.astype(np.complex128), y), dim=["y", "x"],
                   impl=impl)
    npt.assert_allclose(fast.values, slow.values,
                        atol=1e-11 * np.abs(slow.values).max())


def test_segmented_real_dim_nyquist_parity():
    N, seg = 6, 3
    x = np.random.RandomState(5).randn(N)
    da = LabeledArray(x, dims=["t"], coords={"t": np.arange(N) * 1.0}
                      ).chunk({"t": seg})
    kw = dict(dim=["t"], real_dim="t", chunks_to_segments=True,
              scaling="false_density")
    ps, _ = both("power_spectrum", da, **kw)
    F = np.fft.rfft(x.reshape(2, seg), axis=-1)
    ref = np.abs(F) ** 2
    ref[:, 1:] *= 2.0
    npt.assert_allclose(ps.values, ref, rtol=1e-6)
    ps_hp, _ = both("power_spectrum", da, engine="hp", tol=1e-10, **kw)
    npt.assert_allclose(ps_hp.values, ref, rtol=1e-10)


@pytest.mark.parametrize("impl", IMPLS)
def test_segmented_psd_fused_engine_parity(impl):
    """chunks_to_segments under each route, interleaved *_segment dims and
    cross spectra included, held to xrft_tpu's xla engine."""
    rng = np.random.RandomState(6)
    N = 32

    def field():
        return LabeledArray(rng.rand(N, N), dims=["x", "y"],
                            coords={"x": range(N), "y": range(N)}
                            ).chunk({"x": N // 2, "y": N // 2})

    da, db = field(), field()
    got, _ = both("power_spectrum", da, window="hann", detrend="linear",
                  chunks_to_segments=True, impl=impl)
    both("cross_spectrum", da, db, chunks_to_segments=True, impl=impl)
    assert got.dims == ("x_segment", "freq_x", "y_segment", "freq_y")


@pytest.mark.parametrize("detrend", [False, "constant"])
@pytest.mark.parametrize("noverlap", [0, 50])
def test_spectrogram_scipy_parity(noverlap, detrend):
    fs, nperseg = 400.0, 100
    tt, x = series(seed=11)
    da = LabeledArray(x, dims=["t"], coords={"t": tt}, name="u")
    sg, _ = both("spectrogram", da, dim="t", seglen=nperseg,
                 segment_overlap=noverlap or 0, window="hann",
                 detrend=detrend or None)
    f_ref, t_ref, s_ref = sps.spectrogram(
        x, fs=fs, window="hann", nperseg=nperseg, noverlap=noverlap,
        detrend=detrend, scaling="density", mode="psd")
    assert sg.name == "u_spectrogram"
    assert sg.dims == ("t_segment", "freq_t")
    npt.assert_allclose(sg["freq_t"].values, f_ref)
    npt.assert_allclose(sg["t_segment"].values, t_ref)
    npt.assert_allclose(sg.values.T, s_ref, rtol=1e-5,
                        atol=1e-8 * s_ref.max())


def test_spectrogram_fractional_overlap_and_chunked_input():
    fs, nperseg, t0 = 256.0, 64, 5.0
    tt = t0 + np.arange(640) / fs
    x = np.random.RandomState(3).randn(tt.size)
    da = LabeledArray(x, dims=["t"], coords={"t": tt}).chunk({"t": nperseg})
    sg, _ = both("spectrogram", da, dim="t", segment_overlap=0.5,
                 window="hann", detrend="constant")
    f_ref, t_ref, s_ref = sps.spectrogram(
        x, fs=fs, window="hann", nperseg=nperseg, noverlap=nperseg // 2,
        detrend="constant", scaling="density", mode="psd")
    npt.assert_allclose(sg["freq_t"].values, f_ref)
    npt.assert_allclose(sg["t_segment"].values, t0 + t_ref)
    npt.assert_allclose(sg.values.T, s_ref, rtol=1e-5,
                        atol=1e-8 * s_ref.max())
    npt.assert_allclose(sg.coords["t_segment"].attrs["spacing"],
                        (nperseg // 2) / fs)


def test_spectrogram_two_sided_complex_input():
    fs, nperseg = 128.0, 32
    rng = np.random.RandomState(5)
    tt = np.arange(320) / fs
    x = rng.randn(tt.size) + 1j * rng.randn(tt.size)
    da = LabeledArray(x, dims=["t"], coords={"t": tt})
    sg, _ = both("spectrogram", da, dim="t", seglen=nperseg, window="hann",
                 detrend=None, shift=False, segment_overlap=0)
    f_ref, t_ref, s_ref = sps.spectrogram(
        x, fs=fs, window="hann", nperseg=nperseg, noverlap=0, detrend=False,
        return_onesided=False, scaling="density", mode="psd")
    assert sg.dims == ("t_segment", "freq_t")
    npt.assert_allclose(sg["freq_t"].values, f_ref)
    npt.assert_allclose(sg["t_segment"].values, t_ref)
    npt.assert_allclose(sg.values.T, s_ref, rtol=1e-5,
                        atol=1e-8 * s_ref.max())


def test_spectrogram_error_contracts():
    rng = np.random.RandomState(4)
    da = LabeledArray(rng.rand(64), dims=["t"],
                      coords={"t": np.arange(64.0)})
    assert "segment length" in str(raises_same("spectrogram", da, dim="t"))
    da2 = LabeledArray(rng.rand(8, 8), dims=["x", "y"],
                       coords={"x": range(8), "y": range(8)})
    assert "1-D sliding-segment" in str(raises_same(
        "spectrogram", da2, dim=["x", "y"], seglen=4))
    assert "[0, 1)" in str(raises_same("spectrogram", da, dim="t", seglen=16,
                                       segment_overlap=1.0))


def test_spectrogram_default_overlap_is_scipy_default():
    fs, nperseg = 300.0, 80
    tt = np.arange(960) / fs
    x = np.random.RandomState(21).randn(tt.size)
    da = LabeledArray(x, dims=["t"], coords={"t": tt}, name="u")
    sg, _ = both("spectrogram", da, dim="t", seglen=nperseg, window="hann",
                 detrend="constant")
    _, t_ref, s_ref = sps.spectrogram(x, fs=fs, window="hann",
                                      nperseg=nperseg, detrend="constant",
                                      scaling="density", mode="psd")
    npt.assert_allclose(sg["t_segment"].values, t_ref)
    npt.assert_allclose(sg.values.T, s_ref, rtol=1e-5,
                        atol=1e-8 * s_ref.max())


def test_spectrogram_tail_drop_zero_overlap():
    fs, nperseg = 128.0, 32
    tt = np.arange(330) / fs
    x = np.random.RandomState(7).randn(tt.size)
    da = LabeledArray(x, dims=["t"], coords={"t": tt}, name="u")
    sg, _ = both("spectrogram", da, dim="t", seglen=nperseg,
                 segment_overlap=0, window="hann", detrend="constant",
                 warns=(UserWarning, "drops the last 10 samples"))
    _, t_ref, s_ref = sps.spectrogram(x, fs=fs, window="hann",
                                      nperseg=nperseg, noverlap=0,
                                      detrend="constant", scaling="density",
                                      mode="psd")
    assert sg.sizes["t_segment"] == len(t_ref) == 10
    npt.assert_allclose(sg["t_segment"].values, t_ref)
    npt.assert_allclose(sg.values.T, s_ref, rtol=1e-5,
                        atol=1e-8 * s_ref.max())


def test_spectrogram_decreasing_coordinate_centers():
    nperseg = 32
    tt = np.arange(127.0, -1.0, -1.0)
    x = np.random.RandomState(9).randn(tt.size)
    da = LabeledArray(x, dims=["t"], coords={"t": tt}, name="u")
    sg, _ = both("spectrogram", da, dim="t", seglen=nperseg,
                 segment_overlap=0, window="hann", detrend="constant")
    centers = sg["t_segment"].values
    npt.assert_allclose(centers, [111.0, 79.0, 47.0, 15.0])
    assert centers.min() >= tt.min() and centers.max() <= tt.max()
    npt.assert_allclose(sg.coords["t_segment"].attrs["spacing"],
                        -float(nperseg))
    _, _, s_ref = sps.spectrogram(x, fs=1.0, window="hann", nperseg=nperseg,
                                  noverlap=0, detrend="constant",
                                  scaling="density", mode="psd")
    npt.assert_allclose(sg.values.T, s_ref, rtol=1e-5,
                        atol=1e-8 * s_ref.max())


def test_spectrogram_integer_input_is_one_sided():
    """int32 input is real (one-sided) and, in both packages, computed in
    JAX's float for a constant detrend: float32 in the port, whose values
    hold to xrft_tpu's at 2e-6."""
    nperseg = 16
    x = np.random.RandomState(17).randint(-50, 50, size=160).astype(np.int32)
    da = LabeledArray(x, dims=["t"], coords={"t": np.arange(160.0)},
                      name="u")
    sg, _ = both("spectrogram", da, dim="t", seglen=nperseg,
                 segment_overlap=0, window="hann", detrend="constant")
    assert sg.sizes["freq_t"] == nperseg // 2 + 1
    assert sg.values.dtype == np.float32
    _, _, s_ref = sps.spectrogram(
        x.astype(np.float64), fs=1.0, window="hann", nperseg=nperseg,
        noverlap=0, detrend="constant", scaling="density", mode="psd")
    npt.assert_allclose(sg.values.T, s_ref, rtol=1e-5,
                        atol=1e-8 * s_ref.max())


@pytest.mark.parametrize("noverlap_kw", [None, 0, 0.25])
def test_welch_scipy_parity(noverlap_kw):
    fs, nperseg, n = 500.0, 128, 1300
    rng = np.random.RandomState(31)
    tt = np.arange(n) / fs
    x = np.sin(2 * np.pi * 60 * tt) + 0.4 * rng.randn(n)
    da = LabeledArray(x.astype(np.float32), dims=["t"], coords={"t": tt},
                      name="u")
    nov = {None: nperseg // 2, 0: 0, 0.25: nperseg // 4}[noverlap_kw]
    kw = {} if noverlap_kw is None else {"segment_overlap": noverlap_kw}
    got, _ = both("welch", da, dim="t", seglen=nperseg, **kw)
    f_ref, p_ref = sps.welch(x, fs=fs, window="hann", nperseg=nperseg,
                             noverlap=nov, detrend="constant",
                             scaling="density")
    assert got.name == "u_welch"
    assert got.dims == ("freq_t",)
    npt.assert_allclose(got["freq_t"].values, f_ref)
    npt.assert_allclose(got.values, p_ref, rtol=1e-5,
                        atol=1e-8 * p_ref.max())


def test_welch_hp_engine_compensated_mean():
    """The port's hp Welch is float64 throughout (no df64 planes,
    ROADMAP.md Queue 3): within 1e-10 of float64 scipy and of xrft_tpu's
    hp Welch."""
    fs, nperseg = 100.0, 32
    n = 8 * nperseg
    x = np.random.RandomState(33).randn(n).astype(np.float32)
    da = LabeledArray(x, dims=["t"], coords={"t": np.arange(n) / fs},
                      name="u")
    got, _ = both("welch", da, dim="t", seglen=nperseg, segment_overlap=0,
                  engine="hp", tol=1e-10)
    assert got.values.dtype == np.float64
    _, p_ref = sps.welch(x.astype(np.float64), fs=fs, window="hann",
                         nperseg=nperseg, noverlap=0, detrend="constant",
                         scaling="density")
    assert np.abs(got.values - p_ref).max() / p_ref.max() < 1e-10


def test_welch_complex_two_sided_and_batch():
    fs, nperseg = 64.0, 16
    rng = np.random.RandomState(35)
    x = rng.randn(3, 160) + 1j * rng.randn(3, 160)
    da = LabeledArray(x, dims=["z", "t"],
                      coords={"z": range(3), "t": np.arange(160) / fs})
    got, _ = both("welch", da, dim="t", seglen=nperseg, shift=False)
    f_ref, p_ref = sps.welch(x, fs=fs, window="hann", nperseg=nperseg,
                             noverlap=nperseg // 2, detrend="constant",
                             scaling="density", return_onesided=False)
    assert got.dims == ("z", "freq_t")
    npt.assert_allclose(got["freq_t"].values, f_ref)
    npt.assert_allclose(got.values, p_ref, rtol=1e-5,
                        atol=1e-8 * np.abs(p_ref).max())


def test_csd_scipy_parity():
    fs, nperseg, n = 250.0, 64, 640
    rng = np.random.RandomState(37)
    tt = np.arange(n) / fs
    x = np.sin(2 * np.pi * 40 * tt) + 0.3 * rng.randn(n)
    y = np.sin(2 * np.pi * 40 * tt + np.pi / 4) + 0.3 * rng.randn(n)
    da1 = LabeledArray(x.astype(np.float32), dims=["t"], coords={"t": tt},
                       name="u")
    da2 = LabeledArray(y.astype(np.float32), dims=["t"], coords={"t": tt},
                       name="v")
    got, _ = both("csd", da1, da2, dim="t", seglen=nperseg)
    f_ref, p_ref = sps.csd(x, y, fs=fs, window="hann", nperseg=nperseg,
                           noverlap=nperseg // 2, detrend="constant",
                           scaling="density")
    assert got.name == "u_v_csd"
    npt.assert_allclose(got["freq_t"].values, f_ref)
    npt.assert_allclose(got.values, p_ref, rtol=1e-4,
                        atol=1e-7 * np.abs(p_ref).max())
    auto, _ = both("csd", da1, da1, dim="t", seglen=nperseg)
    w, _ = both("welch", da1, dim="t", seglen=nperseg)
    npt.assert_allclose(auto.values.real, w.values, rtol=1e-5)
    assert np.abs(auto.values.imag).max() < 1e-8


def test_spectrogram_datetime64_centers():
    n, seg = 128, 32
    t0 = np.datetime64("2020-01-01T00:00:00", "ns")
    tt = t0 + (np.arange(n) * 1_000_000_000).astype("timedelta64[ns]")
    da = LabeledArray(np.random.RandomState(41).randn(n).astype(np.float32),
                      dims=["t"], coords={"t": tt}, name="u")
    sg, _ = both("spectrogram", da, dim="t", seglen=seg, segment_overlap=0)
    centers = sg["t_segment"].values
    assert np.issubdtype(centers.dtype, np.datetime64)
    want = t0 + (((np.arange(4) * seg + seg / 2) * 1e9)
                 .astype("timedelta64[ns]"))
    npt.assert_array_equal(centers, want)


def test_stft_seglen_clamps_like_scipy():
    n = 100
    x = np.random.RandomState(43).randn(n)
    da = LabeledArray(x.astype(np.float32), dims=["t"],
                      coords={"t": np.arange(float(n))}, name="u")
    got, _ = both("welch", da, dim="t", seglen=256,
                  warns=(UserWarning, "greater than input length"))
    f_ref, p_ref = sps.welch(x, fs=1.0, window="hann", nperseg=256,
                             detrend="constant")
    npt.assert_allclose(got["freq_t"].values, f_ref)
    npt.assert_allclose(got.values, p_ref, rtol=1e-5,
                        atol=1e-8 * p_ref.max())


def test_csd_zero_pads_shorter_input():
    fs, nperseg = 128.0, 64
    rng = np.random.RandomState(47)
    x, y = rng.randn(512), rng.randn(320)
    da1 = LabeledArray(x.astype(np.float32), dims=["t"],
                       coords={"t": np.arange(512) / fs}, name="u")
    da2 = LabeledArray(y.astype(np.float32), dims=["t"],
                       coords={"t": np.arange(320) / fs}, name="v")
    got, _ = both("csd", da1, da2, dim="t", seglen=nperseg)
    f_ref, p_ref = sps.csd(x, y, fs=fs, window="hann", nperseg=nperseg,
                           noverlap=nperseg // 2, detrend="constant")
    npt.assert_allclose(got["freq_t"].values, f_ref)
    npt.assert_allclose(got.values, p_ref, rtol=1e-4,
                        atol=1e-7 * np.abs(p_ref).max())
    got2, _ = both("csd", da2, da1, dim="t", seglen=nperseg)
    _, p2 = sps.csd(y, x, fs=fs, window="hann", nperseg=nperseg,
                    noverlap=nperseg // 2, detrend="constant")
    npt.assert_allclose(got2.values, p2, rtol=1e-4,
                        atol=1e-7 * np.abs(p2).max())


def test_hp_impl_native_guard():
    """xrft_tpu's ``hp_impl`` chooses between its native and df64 hp paths
    and guards the native one on x64; the port has only the native path
    (ROADMAP.md Queue 3), so it has no such knob, and its hp results are
    float64 for float32 input."""
    from xrft_tpu_torch.config import config

    assert not hasattr(config, "hp_impl")
    da = LabeledArray(np.random.RandomState(1).randn(32).astype(np.float32),
                      dims=["t"], coords={"t": np.arange(32.0)})
    got, _ = both("fft", da, engine="hp", tol=1e-12)
    assert got.values.dtype == np.complex128


def test_csd_dim_mismatch_error():
    rng = np.random.RandomState(6)
    da1 = LabeledArray(rng.rand(32), dims=["t"],
                       coords={"t": np.arange(32.0)})
    da2 = LabeledArray(rng.rand(32), dims=["s"],
                       coords={"s": np.arange(32.0)})
    e = raises_same("csd", da1, da2, dim="t", seglen=8)
    assert "same dimensions" in str(e)


def test_spectrogram_batch_dim_and_welch_consistency():
    fs, nperseg = 200.0, 50
    tt = np.arange(500) / fs
    x = np.random.RandomState(13).randn(3, tt.size)
    da = LabeledArray(x, dims=["z", "t"], coords={"z": range(3), "t": tt})
    sg, _ = both("spectrogram", da, dim="t", seglen=nperseg, window="hann",
                 segment_overlap=0)
    assert sg.dims == ("z", "t_segment", "freq_t")
    welch, _ = both(then("power_spectrum", "mean", "t_segment"),
                    da.chunk({"t": nperseg}), dim="t", real_dim="t",
                    window="hann", chunks_to_segments=True,
                    window_correction=True, detrend="constant")
    npt.assert_allclose(sg.mean("t_segment").values, welch.values,
                        rtol=1e-6)


def test_periodogram_scipy_parity_default():
    fs, n = 320.0, 256
    tt = np.arange(n) / fs
    x = np.sin(2 * np.pi * 50 * tt) + 0.3 * np.random.RandomState(41).randn(n)
    da = LabeledArray(x, dims=["t"], coords={"t": tt}, name="u")
    got, _ = both("periodogram", da)
    f_ref, p_ref = sps.periodogram(x, fs=fs)
    assert got.name == "u_periodogram"
    assert got.dims == ("freq_t",)
    npt.assert_allclose(got["freq_t"].values, f_ref)
    npt.assert_allclose(got.values, p_ref, rtol=1e-9,
                        atol=1e-12 * p_ref.max())


@pytest.mark.parametrize("scaling", ["density", "spectrum"])
def test_periodogram_window_and_scaling(scaling):
    fs, n = 100.0, 200
    x = np.random.RandomState(43).randn(n)
    da = LabeledArray(x, dims=["t"], coords={"t": np.arange(n) / fs})
    got, _ = both("periodogram", da, window="hann", scaling=scaling)
    f_ref, p_ref = sps.periodogram(x, fs=fs, window="hann", scaling=scaling)
    npt.assert_allclose(got["freq_t"].values, f_ref)
    npt.assert_allclose(got.values, p_ref, rtol=1e-9,
                        atol=1e-12 * p_ref.max())


def test_periodogram_detrend_false_and_linear():
    fs, n = 64.0, 128
    x = np.random.RandomState(47).randn(n) + 0.05 * np.arange(n)
    da = LabeledArray(x, dims=["t"], coords={"t": np.arange(n) / fs})
    for detrend in (False, "linear"):
        got, _ = both("periodogram", da, detrend=detrend)
        _, p_ref = sps.periodogram(x, fs=fs, detrend=detrend)
        npt.assert_allclose(got.values, p_ref, rtol=1e-9,
                            atol=1e-12 * p_ref.max())


def test_periodogram_complex_two_sided_and_integer_one_sided():
    fs, n = 32.0, 64
    rng = np.random.RandomState(53)
    z = rng.randn(n) + 1j * rng.randn(n)
    da = LabeledArray(z, dims=["t"], coords={"t": np.arange(n) / fs})
    got, _ = both("periodogram", da, shift=False)
    f_ref, p_ref = sps.periodogram(z, fs=fs, return_onesided=False)
    npt.assert_allclose(got["freq_t"].values, f_ref)
    npt.assert_allclose(got.values, p_ref, rtol=1e-9,
                        atol=1e-12 * p_ref.max())
    di = LabeledArray((10 * rng.randn(n)).astype(np.int32), dims=["t"],
                      coords={"t": np.arange(n) / fs})
    one_sided, _ = both("periodogram", di)
    assert one_sided.sizes["freq_t"] == n // 2 + 1


def test_periodogram_batch_dim_rides_along():
    fs, n = 50.0, 40
    x = np.random.RandomState(59).randn(3, n)
    da = LabeledArray(x, dims=["z", "t"],
                      coords={"z": range(3), "t": np.arange(n) / fs})
    got, _ = both("periodogram", da, dim="t")
    assert got.dims == ("z", "freq_t")
    _, p_ref = sps.periodogram(x, fs=fs, axis=-1)
    npt.assert_allclose(got.values, p_ref, rtol=1e-9,
                        atol=1e-12 * p_ref.max())
