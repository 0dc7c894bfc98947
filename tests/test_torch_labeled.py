"""The port's host and elementwise layers against xrft_tpu on the CPU:
LabeledArray and interop round trips, coordinate math, detrend and windows
(float64, 1e-12), and the package's independence from JAX and pandas.
"""

import os
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import numpy.testing as npt
import pytest

torch = pytest.importorskip("torch")

import xrft_tpu
from xrft_tpu import coords as ref_ce
from xrft_tpu.detrend import detrend as ref_detrend
from xrft_tpu.ops.window import apply_window as ref_apply_window
import xrft_tpu_torch as xt
from xrft_tpu_torch import coords as ce
from xrft_tpu_torch.interop import from_reference, to_numpy
from xrft_tpu_torch.ops.window import apply_window

REPO = Path(__file__).resolve().parent.parent
TOL = 1e-12


def _ref_array(seed=0, shape=(3, 8, 10)):
    rng = np.random.RandomState(seed)
    return xrft_tpu.LabeledArray(
        rng.randn(*shape),
        dims=("time", "y", "x"),
        coords={"time": np.arange(shape[0]) * 2.0,
                "y": np.linspace(-1.0, 1.0, shape[1]),
                "x": np.arange(shape[2]) * 0.1,
                "label": (("y",), np.arange(shape[1]) * 10, {"units": "m"})},
        attrs={"units": "K"},
        name="temp",
    )


def _assert_same(a, b, rtol=0.0):
    """Same dims, coords (dims, values, attrs), attrs, name and values (to
    ``rtol``: reductions may sum in another order)."""
    assert tuple(a.dims) == tuple(b.dims)
    assert a.name == b.name and dict(a.attrs) == dict(b.attrs)
    assert set(a.coords) == set(b.coords)
    for c in a.coords:
        assert tuple(a.coords[c].dims) == tuple(b.coords[c].dims)
        npt.assert_array_equal(a.coords[c].values, b.coords[c].values)
        assert dict(a.coords[c].attrs) == dict(b.coords[c].attrs)
    npt.assert_allclose(np.asarray(a.values), np.asarray(b.values),
                        rtol=rtol, atol=0)


@pytest.mark.parametrize("dtype", [np.float32, np.float64, np.complex128])
def test_interop_round_trip(dtype):
    ref = _ref_array()
    ref = xrft_tpu.LabeledArray(ref.values.astype(dtype), dims=ref.dims,
                                coords=ref.coords, attrs=ref.attrs,
                                name=ref.name)
    port = from_reference(ref, device="cpu")
    assert isinstance(port.data, torch.Tensor)
    assert port.data.device.type == "cpu"
    assert port.values.dtype == np.dtype(dtype)
    _assert_same(port, ref)
    back = xrft_tpu.LabeledArray(**to_numpy(port))
    _assert_same(back, ref)


def test_labeled_ops_match_reference():
    ref = _ref_array()
    port = from_reference(ref, device="cpu")
    w_ref = xrft_tpu.LabeledArray(np.arange(10.0) + 1, dims=("x",))
    w = xt.LabeledArray(np.arange(10.0) + 1, dims=("x",), device="cpu")
    for op in (lambda a, b: a * b, lambda a, b: a - b, lambda a, b: b / a,
               lambda a, b: a + 2.0, lambda a, b: 3.0 - a,
               lambda a, b: a ** 2):
        _assert_same(op(port, w), op(ref, w_ref))
    _assert_same(port.mean(["y", "x"]), ref.mean(["y", "x"]), rtol=TOL)
    _assert_same(port.sum("time"), ref.sum("time"), rtol=TOL)
    _assert_same(port.transpose("x", "time", "y"),
                 ref.transpose("x", "time", "y"))
    _assert_same(port.assign_coords(x=np.arange(10) * 3.0),
                 ref.assign_coords(x=np.arange(10) * 3.0))
    assert port.sizes == ref.sizes
    assert port.get_axis_num(["x", "y"]) == ref.get_axis_num(["x", "y"])
    with pytest.raises(ValueError, match="conflicting sizes"):
        port * xt.LabeledArray(np.ones(3), dims=("x",), device="cpu")
    with pytest.raises(ValueError, match="size"):
        xt.LabeledArray(np.ones((2, 3)), dims=("a", "b"),
                        coords={"a": np.arange(3)}, device="cpu")


def _coords():
    t0 = np.datetime64("2000-01-01T00:00:00")
    return [
        xrft_tpu.labeled.Coord(("x",), np.arange(7) * 0.5 - 1.0, None, "x"),
        xrft_tpu.labeled.Coord(("x",), np.arange(8)[::-1] * 3.0, None, "x"),
        xrft_tpu.labeled.Coord(
            ("t",), t0 + np.arange(6) * np.timedelta64(90, "s"), None, "t"),
        xrft_tpu.labeled.Coord(
            ("t",), t0 + np.arange(5) * np.timedelta64(1500, "ms"), None,
            "t"),
    ]


@pytest.mark.parametrize("i", range(4))
def test_coords_match_reference(i):
    rc = _coords()[i]
    c = xt.Coord(rc.dims, rc.values, rc.attrs, rc.name)
    npt.assert_array_equal(ce.diff_coord(c), ref_ce.diff_coord(rc))
    assert ce.lag_coord(c) == ref_ce.lag_coord(rc)
    assert ce.get_coordinate_spacing(c, 1e-3) == \
        ref_ce.get_coordinate_spacing(rc, 1e-3)
    assert ce.is_valid_fft_coord(c) == ref_ce.is_valid_fft_coord(rc)
    n, d = c.values.size, ce.get_coordinate_spacing(c, 1e-3)
    for real in (False, True):
        for shift in (False, True):
            for a, b in zip(ce.freq_grids([n, n], [d, 2 * d], real, shift),
                            ref_ce.freq_grids([n, n], [d, 2 * d], real,
                                              shift)):
                npt.assert_array_equal(a, b)
            for a, b in zip(ce.ifreq_grids([n], [d], real, shift),
                            ref_ce.ifreq_grids([n], [d], real, shift)):
                npt.assert_array_equal(a, b)
    assert xt.get_spacing(c) == xrft_tpu.utils.get_spacing(rc)


def test_coord_validation_matches_reference():
    for name in ("x", "freq_x"):
        assert ce.freq_dim_name(name) == ref_ce.freq_dim_name(name)
    uneven = np.array([0.0, 1.0, 3.0])
    with pytest.raises(ValueError, match="not evenly spaced"):
        ce.get_coordinate_spacing(xt.Coord("x", uneven, None, "x"), 1e-3)
    with pytest.raises(ValueError, match="unevenly spaced"):
        xt.get_spacing(xt.Coord("x", uneven, None, "x"))
    da = xt.LabeledArray(np.zeros(3), dims=("x",),
                         coords={"x": np.array(["a", "b", "c"])}, device="cpu")
    with pytest.raises(ValueError, match="numerical or datetime"):
        ce.check_valid_fft_coords(da, ["x"])


@pytest.mark.parametrize("dim", ["x", ["y", "x"], ["time", "y", "x"],
                                 ["x", "time"]])
@pytest.mark.parametrize("kind", ["constant", "linear", None])
def test_detrend_matches_reference(dim, kind):
    ref = _ref_array(seed=7)
    ref = xrft_tpu.LabeledArray(
        ref.values + np.arange(10) * 0.3 - np.arange(8)[:, None] * 0.2,
        dims=ref.dims, coords=ref.coords, name=ref.name)
    exp = ref_detrend(ref, dim, detrend_type=kind)
    got = xt.detrend(from_reference(ref, device="cpu"), dim, detrend_type=kind)
    assert got.dims == exp.dims and got.name == exp.name
    r = np.asarray(exp.values)
    assert np.abs(got.values - r).max() <= TOL * np.abs(r).max()
    with pytest.raises(NotImplementedError):
        xt.detrend(from_reference(ref, device="cpu"), dim, detrend_type="quadratic")


@pytest.mark.parametrize("window", ["hann", "hamming", "tukey", "flattop"])
@pytest.mark.parametrize("dims", [["x"], ["y", "x"]])
def test_apply_window_matches_reference(window, dims):
    ref = _ref_array(seed=3)
    w_ref, out_ref = ref_apply_window(ref, dims, window_type=window)
    w, out = apply_window(from_reference(ref, device="cpu"), dims, window_type=window)
    assert w.dims == w_ref.dims and out.dims == out_ref.dims
    npt.assert_allclose(w.values, np.asarray(w_ref.values), rtol=TOL)
    npt.assert_allclose(out.values, np.asarray(out_ref.values), rtol=TOL,
                        atol=TOL)
    with pytest.raises(NotImplementedError, match="not supported"):
        apply_window(from_reference(ref, device="cpu"), dims, window_type="nope")


def test_window_keeps_float32():
    da = xt.LabeledArray(np.ones((4, 6), np.float32), dims=("y", "x"), device="cpu")
    w, out = apply_window(da, ["y", "x"])
    assert w.dtype == torch.float32 and out.dtype == torch.float32


def test_package_imports_neither_jax_nor_pandas():
    pat = re.compile(r"^\s*(import|from)\s+(jax|pandas|xrft_tpu)\b", re.M)
    for path in (REPO / "xrft_tpu_torch").rglob("*.py"):
        assert not pat.search(path.read_text()), path


def test_entry_shape_runs_with_jax_and_pandas_blocked():
    code = (
        "import sys\n"
        "sys.modules['jax'] = None\n"
        "sys.modules['pandas'] = None\n"
        "import numpy as np, xrft_tpu_torch as xt\n"
        "B, N = 4, 256\n"
        "da = xt.LabeledArray(np.random.RandomState(0).randn(B, N, N)"
        ".astype(np.float32), dims=('time', 'y', 'x'),\n"
        "    coords={'time': np.arange(B, dtype=np.float64),\n"
        "            'y': np.arange(N) * 0.5, 'x': np.arange(N) * 0.5},"
        " device='cpu')\n"
        "ps = xt.power_spectrum(da, dim=['y', 'x'], window='hann',"
        " detrend='linear')\n"
        "assert ps.dims == ('time', 'freq_y', 'freq_x'), ps.dims\n"
        "assert ps.shape == (B, N, N) and np.isfinite(ps.values).all()\n"
        "iso = xt.isotropic_power_spectrum(da, dim=['y', 'x'], window='hann',"
        " detrend='linear', truncate=True)\n"
        "assert iso.dims == ('time', 'freq_r') and iso.shape == (B, N // 4)\n"
        "assert np.isfinite(iso.values).all()\n"
        "back = xt.ifft(xt.fft(da, dim=['y', 'x'], real_dim='x'),"
        " dim=['freq_y', 'freq_x'], real_dim='freq_x', lag=[64.0, 64.0])\n"
        "assert back.dims == ('time', 'y', 'x') and back.shape == (B, N, N)\n"
        "assert np.abs(back.values - da.values).max() < 1e-5\n"
        "hp = xt.power_spectrum(da, dim=['y', 'x'], window='hann',"
        " detrend='linear', engine='hp')\n"
        "assert str(hp.dtype) == 'torch.float64' and hp.shape == (B, N, N)\n"
        "assert np.abs(hp.values - ps.values).max() < 1e-5 * ps.values.max()\n"
        "from xrft_tpu_torch.config import fft_impl\n"
        "with fft_impl('matmul'):\n"
        "    pm = xt.power_spectrum(da, dim=['y', 'x'], window='hann',"
        " detrend='linear')\n"
        "assert np.abs(pm.values - ps.values).max() < 1e-5 * ps.values.max()\n"
        "w = xt.welch(da, dim='x', seglen=64)\n"
        "assert w.dims == ('time', 'y', 'freq_x') and w.shape == (B, N, 33)\n"
        "Z = xt.stft(da, dim='x', seglen=64)\n"
        "back = xt.istft(Z)\n"
        "assert np.abs(back.values - da.values).max() < 1e-5\n"
        "assert 'pandas' not in {m.split('.')[0] for m, v in"
        " sys.modules.items() if v is not None}\n"
        "assert 'jax' not in {m.split('.')[0] for m, v in sys.modules.items()"
        " if v is not None}\n"
        "print('ok')\n"
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "ok"


def test_host_data_goes_to_the_card_or_raises(monkeypatch):
    """Host data with no device asked for land on the CUDA device; without
    one they raise rather than run on the CPU.  device="cpu" and a CPU
    tensor stay on the CPU."""
    ref = _ref_array()
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        xt.LabeledArray(np.ones(3), dims=("x",))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        from_reference(ref)
    assert from_reference(ref, device="cpu").device.type == "cpu"
    assert xt.LabeledArray(np.ones(3), dims=("x",),
                           device="cpu").device.type == "cpu"
    t = torch.ones(3)
    da = xt.LabeledArray(t, dims=("x",))
    assert da.device.type == "cpu" and da.data is t
    ps = xt.power_spectrum(da.copy(data=torch.randn(16)), dim="x")
    assert ps.device.type == "cpu"


def test_products_leave_the_callers_tf32_setting_alone():
    """Every product of the port runs at full float32 grade inside
    config.full_fp32 and restores the caller's setting afterwards."""
    from xrft_tpu_torch.config import fft_impl, full_fp32
    from xrft_tpu_torch.ops import binning, dot, fft_fourstep

    before = torch.get_float32_matmul_precision()
    try:
        torch.backends.cuda.matmul.allow_tf32 = True
        with full_fp32():
            assert not torch.backends.cuda.matmul.allow_tf32
        assert torch.backends.cuda.matmul.allow_tf32
        dot.dot(torch.ones(4, 3), torch.ones(3, 5))
        fft_fourstep.fft_last_plain(torch.ones(2, 256))
        binning.binned_sum_plain(torch.ones(2, 6),
                                 binning.BinPlan(np.arange(6) % 2, 2))
        da = xt.LabeledArray(torch.randn(2, 32, 32), dims=("t", "y", "x"))
        with fft_impl("matmul"):
            xt.power_spectrum(da, dim=["y", "x"])
        assert torch.backends.cuda.matmul.allow_tf32
        torch.set_float32_matmul_precision("medium")
        dot.dot_plain(torch.ones(4, 3), torch.ones(3, 5))
        assert torch.get_float32_matmul_precision() == "medium"
    finally:
        torch.set_float32_matmul_precision(before)


def test_products_between_legacy_tf32_flips():
    """A caller who flips the legacy ``allow_tf32`` flag around the port's
    products: each product runs with TF32 off, and neither torch nor the
    port raises on the next check (restoring only the generic precision
    left oneDNN at "tf32", which torch then refused as a mix of its two
    APIs)."""
    from xrft_tpu_torch.config import full_fp32
    from xrft_tpu_torch.ops import fft_fourstep

    before = torch.get_float32_matmul_precision()
    matmul = torch.backends.cuda.matmul
    try:
        for flag in (True, False, True, False):
            matmul.allow_tf32 = flag
            fft_fourstep.fft_last_plain(torch.ones(2, 256))
            with full_fp32():
                assert not matmul.allow_tf32
                assert torch.get_float32_matmul_precision() == "highest"
            assert matmul.allow_tf32 is flag
            assert torch.get_float32_matmul_precision() == \
                ("high" if flag else "highest")
        matmul.fp32_precision = "tf32"
        with full_fp32():
            assert matmul.fp32_precision == "ieee"
        assert matmul.fp32_precision == "tf32"
    finally:
        matmul.fp32_precision = "none"
        torch.backends.mkldnn.matmul.fp32_precision = "none"
        torch.set_float32_matmul_precision(before)
