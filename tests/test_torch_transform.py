"""fft and ifft of xrft_tpu_torch against xrft_tpu, following
``tests/test_transform.py`` test for test.

Each test runs the same seeded numpy input through both packages on the CPU
(``torch_parity.both``: dims, name, attrs, coordinates, values to 1e-12 of
max in float64, and the same warnings) and keeps the original's numpy or
scipy oracle on the port's result.  Where the original runs xrft_tpu's two
complex representations (native and split), these run the port's three
``fft_impl`` routes instead: the port has no split representation
(``complex_mode("split")`` raises, ROADMAP.md Queue 3).  The original's
jaxpr-structure test becomes a check that the natural-order inverse equals
the pre-sorted one on every route.
"""

import warnings

import numpy as np
import numpy.testing as npt
import pytest
import scipy.signal as sps

torch = pytest.importorskip("torch")

import xrft_tpu
import xrft_tpu_torch as xt
from xrft_tpu import LabeledArray
from xrft_tpu_torch.config import fft_impl

from torch_parity import IMPLS, both, port_arg, raises_same


def make_1d(Nx=16, Lx=1.0, coords=True, seed=0):
    x = np.linspace(0, Lx, Nx)
    rng = np.random.RandomState(seed)
    c = {"x": x} if coords else None
    return LabeledArray(rng.rand(Nx), dims=["x"], coords=c)


@pytest.mark.parametrize("impl", IMPLS)
@pytest.mark.parametrize("coords", [True, False])
def test_fft_1d(impl, coords):
    da = make_1d(coords=coords)
    Nx = da.sizes["x"]
    dx = float(da["x"][1] - da["x"][0]) if coords else 1
    kw = dict(true_phase=False, true_amplitude=False, impl=impl)
    ft, _ = both("fft", da, detrend="constant", **kw)
    assert ft.dims == ("freq_x",)
    freq_expected = np.fft.fftshift(np.fft.fftfreq(Nx, dx))
    npt.assert_allclose(ft["freq_x"].values, freq_expected)
    assert ft["freq_x"].spacing == freq_expected[1] - freq_expected[0]
    data = da.values - da.values.mean()
    npt.assert_allclose(np.fft.fftshift(np.fft.fft(data)), ft.values,
                        atol=1e-12)
    ft, _ = both("fft", da, **kw)
    npt.assert_allclose(np.fft.fftshift(np.fft.fft(da.values)), ft.values,
                        rtol=1e-12)
    ft, _ = both("fft", da, detrend="linear", **kw)
    npt.assert_allclose(np.fft.fftshift(np.fft.fft(sps.detrend(da.values))),
                        ft.values, atol=1e-12)


def test_fft_1d_uneven_raises():
    da = make_1d()
    bad_x = da["x"].values.copy()
    bad_x[-1] *= 2
    da = LabeledArray(da.values, dims=["x"], coords={"x": bad_x})
    assert "evenly" in str(raises_same("fft", da))


def test_fft_zero_spacing_raises():
    da = LabeledArray(np.random.RandomState(1).rand(8), dims=["x"],
                      coords={"x": np.zeros(8)})
    assert "zero" in str(raises_same("fft", da))


def test_fft_1d_time():
    time = np.arange("2000-01-01", "2000-02-01",
                     dtype="datetime64[D]").astype("datetime64[ns]")
    Nt = len(time)
    da = LabeledArray(np.random.RandomState(2).rand(Nt), dims=["time"],
                      coords={"time": time})
    ft, _ = both("fft", da, shift=False, true_phase=False,
                 true_amplitude=False)
    npt.assert_allclose(ft["freq_time"].values,
                        np.fft.fftfreq(Nt, 24 * 3600.0))


@pytest.mark.parametrize("impl", IMPLS)
def test_fft_2d(impl):
    N = 16
    rng = np.random.RandomState(1)
    da = LabeledArray(rng.rand(N, N), dims=["x", "y"],
                      coords={"x": range(N), "y": range(N)})
    kw = dict(shift=False, true_phase=False, true_amplitude=False,
              impl=impl)
    ft, _ = both("fft", da, **kw)
    npt.assert_allclose(ft.values, np.fft.fftn(da.values), rtol=1e-10)
    ft, _ = both("fft", da, window="hann", detrend="constant", **kw)
    window = sps.windows.hann(N, sym=False) \
        * sps.windows.hann(N, sym=False)[:, np.newaxis]
    npt.assert_allclose(
        ft.values, np.fft.fftn((da.values - da.values.mean()) * window),
        atol=1e-11)


def test_fft_2d_decreasing_coords_ps_nonneg():
    N = 16
    da = LabeledArray(np.random.RandomState(3).rand(N, N), dims=["x", "y"],
                      coords={"x": np.arange(N, 0, -1),
                              "y": np.arange(N, 0, -1)})
    ps, _ = both("power_spectrum", da, shift=False, density=True)
    assert (ps.values >= 0.0).all()


def test_dim_str_vs_list():
    N = 16
    da = LabeledArray(np.random.RandomState(4).rand(N, N), dims=["x", "y"],
                      coords={"x": range(N), "y": range(N)})
    kw = dict(shift=False, true_phase=False, true_amplitude=False)
    a, _ = both("fft", da, dim="y", **kw)
    b, _ = both("fft", da, dim=["y"], **kw)
    npt.assert_array_equal(a.values, b.values)
    assert both("fft", da, dim="y")[0].dims == ("x", "freq_y")


def test_fft_3d_partial_dims():
    N = 8
    da = LabeledArray(np.random.RandomState(5).rand(N, N, N),
                      dims=["time", "x", "y"],
                      coords={"time": range(N), "x": range(N),
                              "y": range(N)})
    kw = dict(shift=False, true_phase=False, true_amplitude=False)
    daft, _ = both("fft", da, dim=["x", "y"], **kw)
    npt.assert_allclose(daft.values, np.fft.fftn(da.values, axes=[1, 2]),
                        rtol=1e-10)
    daft, _ = both("fft", da, dim=["time"], detrend="linear", **kw)
    npt.assert_allclose(daft.values,
                        np.fft.fftn(sps.detrend(da.values, axis=0),
                                    axes=[0]), atol=1e-11)


@pytest.mark.parametrize("impl", IMPLS)
@pytest.mark.parametrize("coords", [True, False])
def test_fft_real_1d(impl, coords):
    da = make_1d(coords=coords)
    Nx = da.sizes["x"]
    dx = float(da["x"][1] - da["x"][0]) if coords else 1
    ft, _ = both("fft", da, real_dim="x", detrend="constant",
                 true_phase=False, true_amplitude=False, impl=impl)
    assert ft.dims == ("freq_x",)
    npt.assert_allclose(ft["freq_x"].values, np.fft.rfftfreq(Nx, dx))
    npt.assert_allclose(np.fft.rfft(da.values - da.values.mean()),
                        ft.values, atol=1e-12)
    raises_same("fft", da, real_dim="y", detrend="constant")


@pytest.mark.parametrize("impl", IMPLS)
def test_fft_real_2d(impl):
    Nx, Ny = 16, 32
    rng = np.random.RandomState(3)
    da = LabeledArray(rng.rand(Nx, Ny), dims=["x", "y"],
                      coords={"x": range(Nx), "y": range(Ny)})
    kw = dict(true_phase=False, true_amplitude=False, impl=impl)
    daft, _ = both("fft", da, real_dim="x", **kw)
    npt.assert_allclose(daft.values,
                        np.fft.rfftn(da.values.transpose()).transpose(),
                        rtol=1e-10, atol=1e-11)
    other, _ = both("fft", da, dim=["y"], real_dim="x", **kw)
    npt.assert_allclose(daft.values, other.values, rtol=1e-12)
    npt.assert_allclose(daft.coords["freq_x"].values,
                        np.fft.rfftfreq(Nx, 1.0))
    npt.assert_allclose(daft.coords["freq_y"].values,
                        np.fft.fftfreq(Ny, 1.0))


def test_fft_nocoords_and_single_dim_window():
    rng = np.random.RandomState(6)
    data = LabeledArray(rng.random_sample([20, 30, 40]),
                        dims=["time", "lat", "lon"])
    both("fft", data, dim=["time"])
    both("power_spectrum", data, dim=["time"])
    data2 = LabeledArray(
        rng.random_sample([20, 30, 40]), dims=["time", "lat", "lon"],
        coords={"time": range(20), "lat": range(30), "lon": range(40)})
    both("power_spectrum", data2, dim=["time"], window="hann")


def test_fft_bad_nondim_coord_raises():
    N = 8
    da = LabeledArray(
        np.random.RandomState(7).rand(N, N), dims=["x", "y"],
        coords={"x": range(N), "y": range(N),
                "x2": (("x",), np.arange(N) * 2.0)})
    assert "drop" in str(raises_same("fft", da, dim=["x"]))
    both("fft", da, dim=["y"])


def test_fft_non_numeric_coord_raises():
    da = LabeledArray(np.random.RandomState(8).rand(4), dims=["x"],
                      coords={"x": np.array(["a", "b", "c", "d"])})
    assert "numerical or datetime" in str(raises_same("fft", da))


@pytest.mark.parametrize("impl", IMPLS)
def test_true_phase_translation_invariance(impl):
    N = 32
    x0 = np.arange(N) - N // 2
    sig = np.exp(-(x0 ** 2) / 16.0)
    da1 = LabeledArray(sig, dims=["x"], coords={"x": x0 * 0.5})
    da2 = LabeledArray(sig, dims=["x"], coords={"x": x0 * 0.5 + 3.0})
    f1, _ = both("fft", da1, true_phase=True, true_amplitude=True,
                 impl=impl)
    f2, _ = both("fft", da2, true_phase=True, true_amplitude=True,
                 impl=impl)
    npt.assert_allclose(np.abs(f1.values), np.abs(f2.values), atol=1e-12)
    k = f1["freq_x"].values
    npt.assert_allclose(f2.values, f1.values * np.exp(-2j * np.pi * k * 3.0),
                        atol=1e-12)


@pytest.mark.parametrize("impl", IMPLS)
def test_true_phase_analytic_gaussian(impl):
    N, dx = 64, 0.25
    x = (np.arange(N) - N // 2) * dx
    da = LabeledArray(np.exp(-np.pi * x ** 2), dims=["x"], coords={"x": x})
    F, _ = both("fft", da, true_phase=True, true_amplitude=True, impl=impl)
    k = F["freq_x"].values
    npt.assert_allclose(F.values, np.exp(-np.pi * k ** 2), atol=1e-5)


@pytest.mark.parametrize("impl", IMPLS)
def test_reversed_coordinates(impl):
    N = 16
    x = np.arange(N) * 0.5
    sig = np.random.RandomState(5).randn(N)
    da_up = LabeledArray(sig, dims=["x"], coords={"x": x})
    da_dn = LabeledArray(sig[::-1].copy(), dims=["x"],
                         coords={"x": x[::-1].copy()})
    f_up, _ = both("fft", da_up, true_phase=True, true_amplitude=True,
                   impl=impl)
    f_dn, _ = both("fft", da_dn, true_phase=True, true_amplitude=True,
                   impl=impl)
    npt.assert_allclose(f_up.values, f_dn.values, atol=1e-12)


@pytest.mark.parametrize("impl", IMPLS)
@pytest.mark.parametrize("shift", [True, False])
def test_ifft_fft_roundtrip(impl, shift):
    N = 40
    x = (np.arange(N) - 11) * 0.3
    sig = np.random.RandomState(6).randn(N)
    da = LabeledArray(sig, dims=["x"], coords={"x": x})
    F, F_ref = both("fft", da, true_phase=True, true_amplitude=True,
                    shift=shift, impl=impl)
    lag = F["freq_x"].attrs["direct_lag"]
    back, _ = both("ifft", F_ref, true_phase=True, true_amplitude=True,
                   lag=lag, impl=impl)
    npt.assert_allclose(back.values.real, sig, atol=1e-11)
    npt.assert_allclose(back["x"].values, x, atol=1e-11)
    # the port's own chain
    with fft_impl(impl):
        own = xt.ifft(F, true_phase=True, true_amplitude=True, lag=lag)
    npt.assert_allclose(own.values.real, sig, atol=1e-11)


@pytest.mark.parametrize("impl", IMPLS)
def test_idft_dft_roundtrip_manual_lag(impl):
    N = 24
    x = np.arange(N) * 0.25 + 4.0
    rng = np.random.RandomState(7)
    sig = rng.randn(N) + 1j * rng.randn(N)
    da = LabeledArray(sig, dims=["x"], coords={"x": x})
    _, F_ref = both("fft", da, true_phase=True, true_amplitude=True,
                    impl=impl)
    back, _ = both("ifft", F_ref, true_phase=True, true_amplitude=True,
                   lag=x[N // 2], impl=impl)
    npt.assert_allclose(back.values, sig, atol=1e-11)
    npt.assert_allclose(back["x"].values, x, atol=1e-11)


def test_ifft_noncentered_raises():
    N = 16
    F = LabeledArray(np.random.RandomState(9).rand(N) + 0j,
                     dims=["freq_x"],
                     coords={"freq_x": np.fft.fftfreq(N, 0.1) + 1.0})
    assert "centered" in str(raises_same("ifft", F, true_phase=True, lag=0))


@pytest.mark.parametrize("impl", IMPLS)
def test_ifft_real_dim(impl):
    N = 32
    x = np.arange(N) * 0.5
    sig = np.random.RandomState(8).randn(N)
    da = LabeledArray(sig, dims=["x"], coords={"x": x})
    _, F_ref = both("fft", da, real_dim="x", true_phase=True,
                    true_amplitude=True, impl=impl)
    back, _ = both("ifft", F_ref, real_dim="freq_x", true_phase=True,
                   true_amplitude=True, lag=x[N // 2], impl=impl)
    npt.assert_allclose(back.values, sig, atol=1e-11)


def test_matmul_engine_full_pipeline():
    """The matmul route through the public API equals the torch route, and
    both equal xrft_tpu's engines."""
    N = 48
    da = LabeledArray(np.random.RandomState(9).randn(N), dims=["x"],
                      coords={"x": np.arange(N) * 0.1})
    kw = dict(detrend="linear", window="hann")
    a, _ = both("fft", da, impl="torch", **kw)
    b, _ = both("fft", da, impl="matmul", **kw)
    npt.assert_allclose(a.values, b.values, atol=1e-11)
    b2, _ = both("fft", da, engine="matmul", **kw)
    npt.assert_allclose(a.values, b2.values, atol=1e-11)


def test_lag_list_with_none():
    N = 16
    x = np.arange(N) * 0.5 + 2.0
    y = np.arange(N) * 0.25 + 1.0
    sig = np.random.RandomState(10).randn(N, N)
    da = LabeledArray(sig, dims=["x", "y"], coords={"x": x, "y": y})
    _, F_ref = both("fft", da, true_phase=True, true_amplitude=True)
    back, _ = both("ifft", F_ref, true_phase=True, true_amplitude=True,
                   lag=[x[N // 2], None])
    npt.assert_allclose(back.values.real, sig, atol=1e-10)
    assert "same length" in str(raises_same("ifft", F_ref, lag=[1.0]))


@pytest.mark.parametrize("impl", IMPLS)
def test_real_dft_is_half_of_full(impl):
    Nx = 40
    rng = np.random.RandomState(12)
    dx = rng.rand()
    xc = dx * (np.arange(-Nx // 2, -Nx // 2 + Nx)
               + rng.randint(-Nx // 2, Nx // 2))
    s = LabeledArray(rng.rand(Nx), dims=["x"], coords={"x": xc})
    s1, _ = both("fft", s, dim="x", true_phase=True, shift=True,
                 true_amplitude=False, impl=impl)
    s2, _ = both("fft", s, real_dim="x", true_phase=True, shift=True,
                 true_amplitude=False, impl=impl)
    half = np.conj(s1.values[: s1.sizes["freq_x"] // 2 + 1])[::-1]
    npt.assert_allclose(half, s2.values, atol=1e-11)


def test_spacing_tol():
    Nx = 16
    x = np.linspace(0, 1.0, Nx)
    x[-1] += 0.001
    da = LabeledArray(np.random.RandomState(13).rand(Nx), dims=["x"],
                      coords={"x": x})
    both("fft", da, spacing_tol=1e-1)
    raises_same("fft", da, spacing_tol=1e-4)


def test_constant_freq_coordinates_raise():
    N = 20
    rng = np.random.RandomState(14)
    s = LabeledArray(rng.rand(N) + 1j * rng.rand(N), dims="freq_x",
                     coords={"freq_x": np.zeros(N)})
    raises_same("fft", s, true_phase=False, true_amplitude=False)
    raises_same("ifft", s, true_phase=False, true_amplitude=False, lag=0)


@pytest.mark.parametrize("impl", IMPLS)
def test_true_phase_preservation_padding(impl):
    rng = np.random.RandomState(21)
    x = np.arange(-15, 15)
    y = rng.rand(len(x))
    N1, N2, N3 = 9, 14, 5
    N4 = N1 + N2 - N3

    def padded(NL, NR):
        left = np.arange(-NL, 0) + x.min()
        right = np.arange(1, NR + 1) + x.max()
        return LabeledArray(
            np.concatenate([np.zeros(NL), y, np.zeros(NR)]), dims=("x",),
            coords={"x": np.concatenate([left, x, right])})

    S1, _ = both("fft", padded(N1, N2), dim="x", true_phase=True,
                 true_amplitude=False, impl=impl)
    S2, _ = both("fft", padded(N3, N4), dim="x", true_phase=True,
                 true_amplitude=False, impl=impl)
    npt.assert_allclose(S1["freq_x"].values, S2["freq_x"].values)
    npt.assert_allclose(S1.values, S2.values, atol=1e-11)


def test_ifft_chunks_to_segments():
    N, seg = 32, 16
    rng = np.random.RandomState(31)
    spec = rng.randn(N) + 1j * rng.randn(N)
    f16 = np.fft.fftshift(np.fft.fftfreq(seg, 0.5))
    daft = LabeledArray(spec, dims=["freq_t"],
                        coords={"freq_t": np.tile(f16, 2)}
                        ).chunk({"freq_t": seg})
    kw = dict(dim=["freq_t"], chunks_to_segments=True, true_amplitude=False,
              shift=False)
    out, _ = both("ifft", daft, true_phase=True, lag=[0.0], **kw)
    assert out.dims == ("freq_t_segment", "t")
    ref = np.fft.ifft(np.fft.ifftshift(spec.reshape(2, seg), axes=-1),
                      axis=-1)
    npt.assert_allclose(out.values, ref, atol=1e-11)
    out2, _ = both("ifft", daft, true_phase=False, **kw)
    npt.assert_allclose(out2.values, np.fft.ifftshift(ref, axes=-1),
                        atol=1e-11)
    out3, _ = both("ifft", daft, true_phase=True, lag=[3.0], **kw)
    pre = spec * np.exp(2j * np.pi * np.tile(f16, 2) * 3.0)
    ref3 = np.fft.ifft(np.fft.ifftshift(pre.reshape(2, seg), axes=-1),
                       axis=-1)
    npt.assert_allclose(out3.values, ref3, atol=1e-11)


def test_fft_segments_unchunked_dim_is_one_segment():
    rng = np.random.RandomState(7)
    da = LabeledArray(rng.randn(8, 12), dims=["x", "y"],
                      coords={"x": np.arange(8.0), "y": np.arange(12.0)}
                      ).chunk({"x": 4})
    out, _ = both("fft", da, dim=["x", "y"], chunks_to_segments=True,
                  shift=False, true_phase=False, true_amplitude=False)
    assert out.dims == ("x_segment", "freq_x", "y_segment", "freq_y")
    ref = np.fft.fftn(da.values.reshape(2, 4, 1, 12), axes=(1, 3))
    npt.assert_allclose(out.values, ref, atol=1e-11)
    da2 = LabeledArray(rng.randn(8), dims=["x"],
                       coords={"x": np.arange(8.0)})
    assert "chunk" in str(raises_same("fft", da2, dim=["x"],
                                      chunks_to_segments=True))


def test_pad_stat_kwargs():
    da = LabeledArray(np.array([1.0, 5.0, 2.0, 8.0]), dims=["x"],
                      coords={"x": np.arange(4.0)})
    p, _ = both("pad", da, {"x": 2}, mode="maximum", stat_length=2)
    npt.assert_array_equal(p.values, np.pad(da.values, 2, mode="maximum",
                                            stat_length=2))
    p, _ = both("pad", da, {"x": 1}, mode="linear_ramp", end_values=7.0)
    npt.assert_array_equal(p.values, np.pad(da.values, 1,
                                            mode="linear_ramp",
                                            end_values=7.0))
    p, _ = both("pad", da, {"x": 2}, mode="reflect", reflect_type="odd")
    npt.assert_array_equal(p.values, np.pad(da.values, 2, mode="reflect",
                                            reflect_type="odd"))


@pytest.mark.parametrize("shape", [(15, 16), (16, 18), (12, 20), (9, 14)])
@pytest.mark.parametrize("true_phase", [True, False])
@pytest.mark.parametrize("shift", [True, False])
def test_irfft_shift_absorption_parity(shape, true_phase, shift):
    """irfft under "matmul" (shifts absorbed into the engines' weights, the
    packed half-length inverse) equals the torch route, both held to
    xrft_tpu's."""
    NY, NX = shape
    x = np.random.RandomState(1).randn(3, NY, NX)
    da = LabeledArray(x, dims=("t", "y", "x"),
                      coords={"y": np.arange(NY) * 0.5,
                              "x": np.arange(NX) * 0.25})
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        ft = xrft_tpu.fft(da, dim=["y", "x"], real_dim="x",
                          true_phase=true_phase, shift=shift)
    kw = dict(dim=["freq_y", "freq_x"], real_dim="freq_x",
              true_phase=true_phase, shift=shift,
              lag=[float(np.arange(NY)[NY // 2] * 0.5), 0.0])
    got, _ = both("ifft", ft, impl="matmul", **kw)
    ref, _ = both("ifft", ft, impl="torch", **kw)
    npt.assert_allclose(got.values, ref.values, atol=1e-10)


@pytest.mark.parametrize("shape", [(16, 8), (15, 9), (16, 9), (12, 10)])
def test_ifft_natural_order_roundtrip(shape):
    N, M = shape
    rng = np.random.RandomState(3)
    x = rng.randn(N, M) + 1j * rng.randn(N, M)
    da = LabeledArray(x, dims=("y", "x"),
                      coords={"y": np.arange(N) * 0.5,
                              "x": np.arange(M) * 0.25})
    lag = [float(np.arange(N)[N // 2] * 0.5),
           float(np.arange(M)[M // 2] * 0.25)]
    for impl in ("torch", "matmul"):
        _, nat = both("fft", da, dim=["y", "x"], shift=False, impl=impl)
        back, _ = both("ifft", nat, dim=["freq_y", "freq_x"], lag=lag,
                       impl=impl)
        npt.assert_allclose(back.values, x, atol=1e-11)
        npt.assert_allclose(back["y"].values, da["y"].values, atol=1e-12)


@pytest.mark.parametrize("impl", IMPLS)
def test_ifft_natural_order_equals_presorted(impl):
    """The natural-order (unshifted fftfreq) inverse composes its sort roll
    with the input ifftshift: it equals the inverse of the same spectrum
    sorted first, for ifft2 and irfft2 (to 1e-12 of max: the matmul
    engines absorb the two inputs' shifts into different weights), and
    both equal xrft_tpu's."""
    N, M = 64, 32
    rng = np.random.RandomState(0)
    full = rng.randn(N, M) + 1j * rng.randn(N, M)
    half = rng.randn(N, M // 2 + 1) + 1j * rng.randn(N, M // 2 + 1)
    fy, fx = np.fft.fftfreq(N, 0.5), np.fft.fftfreq(M, 0.25)

    def inv(data, cy, cx, **kw):
        da = LabeledArray(data, dims=("freq_y", "freq_x"),
                          coords={"freq_y": cy, "freq_x": cx})
        got, _ = both("ifft", da, dim=["freq_y", "freq_x"], lag=[0.0, 0.0],
                      impl=impl, **kw)
        return got

    nat = inv(full, fy, fx)
    srt = inv(np.fft.fftshift(full), np.fft.fftshift(fy),
              np.fft.fftshift(fx))
    npt.assert_allclose(nat.values, srt.values, rtol=0,
                        atol=1e-12 * np.abs(srt.values).max())
    rx = np.fft.rfftfreq(M, 0.25)
    natr = inv(half, fy, rx, real_dim="freq_x")
    srtr = inv(np.fft.fftshift(half, axes=0), np.fft.fftshift(fy), rx,
               real_dim="freq_x")
    npt.assert_allclose(natr.values, srtr.values, rtol=0,
                        atol=1e-12 * np.abs(srtr.values).max())


@pytest.mark.parametrize("roll", [1, 3, -5])
def test_ifft_arbitrary_cyclic_roll_coords(roll):
    N, M = 16, 12
    rng = np.random.RandomState(7)
    x = rng.randn(N, M) + 1j * rng.randn(N, M)
    da = LabeledArray(x, dims=("y", "x"),
                      coords={"y": np.arange(N) * 0.5,
                              "x": np.arange(M) * 0.25})
    lag = [float(np.arange(N)[N // 2] * 0.5),
           float(np.arange(M)[M // 2] * 0.25)]
    _, ft = both("fft", da, dim=["y", "x"], shift=True)
    ref, _ = both("ifft", ft, dim=["freq_y", "freq_x"], lag=lag)
    fv = np.asarray(ft.values)
    fy = ft["freq_y"].values
    rolled = LabeledArray(np.roll(fv, roll, axis=0), dims=ft.dims,
                          coords={"freq_y": np.roll(fy, roll),
                                  "freq_x": ft["freq_x"].values})
    got, _ = both("ifft", rolled, dim=["freq_y", "freq_x"], lag=lag)
    npt.assert_allclose(got.values, ref.values, atol=1e-11)
    perm = rng.permutation(N)
    permuted = LabeledArray(fv[perm], dims=ft.dims,
                            coords={"freq_y": fy[perm],
                                    "freq_x": ft["freq_x"].values})
    got2, _ = both("ifft", permuted, dim=["freq_y", "freq_x"], lag=lag)
    npt.assert_allclose(got2.values, ref.values, atol=1e-11)
    assert port_arg(permuted).dims == ft.dims
