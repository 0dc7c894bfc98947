"""pad and unpad of xrft_tpu_torch against xrft_tpu, following
``tests/test_padding.py`` test for test: the same seeded inputs through both
packages on the CPU (``torch_parity.both``: dims, name, attrs, coordinates
and values), with that file's numpy oracles kept.  The complex modes are in
``test_torch_repairs.py``.
"""

import numpy as np
import numpy.testing as npt
import pytest

torch = pytest.importorskip("torch")

import xrft_tpu
from xrft_tpu import LabeledArray

from torch_parity import IMPLS, both, port_arg, raises_same


def sample():
    return LabeledArray(
        np.arange(1, 10, dtype=float).reshape(3, 3),
        dims=("y", "x"),
        coords={"x": [0, 1, 2], "y": [-5, -4, -3]},
    )


def test_pad_coords_extrapolated():
    p, _ = both("pad", sample(), x=2, y=1)
    assert p.shape == (5, 7)
    npt.assert_array_equal(p["x"].values, [-2, -1, 0, 1, 2, 3, 4])
    npt.assert_array_equal(p["y"].values, [-6, -5, -4, -3, -2])
    assert p["x"].attrs["pad_width"] == 2
    assert p["y"].attrs["pad_width"] == 1
    npt.assert_array_equal(p.values[0], np.zeros(7))
    npt.assert_array_equal(p.values[1, 2:5], [1, 2, 3])


def test_pad_asymmetric():
    p, _ = both("pad", sample(), x=(1, 4))
    assert p.shape == (3, 8)
    npt.assert_array_equal(p["x"].values, [-1, 0, 1, 2, 3, 4, 5, 6])
    assert p["x"].attrs["pad_width"] == (1, 4)
    npt.assert_array_equal(p.values[0], [0, 1, 2, 3, 0, 0, 0, 0])


@pytest.mark.parametrize("mode", [
    "constant", "edge", "linear_ramp", "maximum", "mean", "median",
    "minimum", "reflect", "symmetric", "wrap",
])
def test_pad_modes_match_numpy(mode):
    da = sample()
    p, _ = both("pad", da, {"x": 2}, mode=mode)
    expected = np.pad(da.values, [(0, 0), (2, 2)], mode=mode)
    npt.assert_array_equal(p.values, expected)


def test_pad_constant_values():
    p, _ = both("pad", sample(), {"x": 1}, constant_values=7.5)
    npt.assert_array_equal(p.values[:, 0], [7.5, 7.5, 7.5])


def test_pad_coord_attrs_kept():
    da = sample()
    da.coords["x"].attrs["units"] = "m"
    p, _ = both("pad", da, x=1)
    assert p["x"].attrs["units"] == "m"
    assert p["x"].attrs["pad_width"] == 1


def test_pad_bad_coords_raise():
    da = sample().assign_coords(x2=(("x",), [10.0, 11.0, 12.0]))
    e = raises_same("pad", da, x=1)
    assert "drop" in str(e)


def test_pad_uneven_coords_raise():
    da = LabeledArray(np.arange(4.0), dims=["x"],
                      coords={"x": [0.0, 1.0, 2.5, 3.0]})
    e = raises_same("pad", da, x=1)
    assert "evenly spaced" in str(e)


def test_unpad_roundtrip():
    da = sample()
    p, p_ref = both("pad", da, x=2, y=1)
    u, _ = both("unpad", p_ref)
    npt.assert_array_equal(u.values, da.values)
    npt.assert_array_equal(u["x"].values, da["x"].values)
    npt.assert_array_equal(u["y"].values, da["y"].values)
    assert "pad_width" not in u["x"].attrs


def test_unpad_explicit_width():
    _, p_ref = both("pad", sample(), x=2, y=1)
    u, _ = both("unpad", p_ref, x=1, y=1)
    assert u.shape == (3, 5)
    npt.assert_array_equal(u["x"].values, [-1, 0, 1, 2, 3])


def test_unpad_without_attrs_raises():
    e = raises_same("unpad", sample())
    assert "padded" in str(e)


@pytest.mark.parametrize("impl", IMPLS)
def test_pad_fft_ifft_unpad_roundtrip(impl):
    """pad, fft, ifft and unpad in the port, each step held to xrft_tpu's,
    under every fft_impl (float64 data: the K4 recursion under
    "kernel")."""
    N = 16
    x = np.linspace(0, 1, N, endpoint=False)
    rng = np.random.RandomState(0)
    da = LabeledArray(rng.randn(N), dims=["x"], coords={"x": x})
    padded, padded_ref = both("pad", da, x=4)
    F, F_ref = both("fft", padded_ref, true_phase=True, true_amplitude=True,
                    impl=impl)
    lag = F["freq_x"].attrs["direct_lag"]
    back, back_ref = both("ifft", F_ref, true_phase=True,
                          true_amplitude=True, lag=lag, impl=impl)
    pw = padded["x"].attrs["pad_width"]
    real = LabeledArray(np.asarray(back_ref.values).real, dims=["x"],
                        coords={"x": back_ref["x"].copy(
                            attrs={**back_ref["x"].attrs, "pad_width": pw})})
    unpadded, _ = both("unpad", real)
    npt.assert_allclose(unpadded.values, da.values, atol=1e-11)
    npt.assert_allclose(unpadded["x"].values, x, atol=1e-11)
    # the port's own chain, start to end
    chain = port_arg(real).copy(data=back.data.real.contiguous())
    import xrft_tpu_torch as xt

    npt.assert_allclose(xt.unpad(chain).values, da.values, atol=1e-11)


def test_pad_per_dim_mapping_kwargs():
    rng = np.random.RandomState(0)
    da = LabeledArray(rng.rand(4, 6), dims=["y", "x"],
                      coords={"y": np.arange(4.0), "x": np.arange(6.0)})

    p, _ = both("pad", da, {"y": 1, "x": 2}, mode="constant",
                constant_values={"y": 7.0, "x": (1.0, 2.0)})
    ref = np.pad(da.values, ((1, 1), (2, 2)), mode="constant",
                 constant_values=((7.0, 7.0), (1.0, 2.0)))
    npt.assert_array_equal(p.values, ref)

    p, _ = both("pad", da, {"y": 1, "x": 1}, mode="constant",
                constant_values={"x": 3.0})
    ref = np.pad(da.values, 1, mode="constant",
                 constant_values=((0.0, 0.0), (3.0, 3.0)))
    npt.assert_array_equal(p.values, ref)

    p, _ = both("pad", da, {"x": 2}, mode="linear_ramp",
                end_values={"x": (5.0, -1.0)})
    ref = np.pad(da.values, ((0, 0), (2, 2)), mode="linear_ramp",
                 end_values=((0, 0), (5.0, -1.0)))
    npt.assert_array_equal(p.values, ref)

    p, _ = both("pad", da, {"x": 2}, mode="maximum", stat_length={"x": 2})
    ref = np.pad(da.values, ((0, 0), (2, 2)), mode="maximum",
                 stat_length=((4, 4), (2, 2)))
    npt.assert_array_equal(p.values, ref)

    e = raises_same("pad", da, {"x": 1}, mode="constant",
                    constant_values={"z": 1.0})
    assert "unknown dims" in str(e)
