"""The plain references: they agree with numpy closed forms, a lower
precision fails the comparison each cell uses, and the harness hands the
reference exactly the inputs it handed the program."""

import numpy as np
import pytest
import torch

import bench_helpers as H
from harness import cells, compare, device, inputs, runner

PSD = cells.entry_module("reference", "power_spectrum")
IFFT = cells.entry_module("reference", "ifft")
KW = {"dim": ["y", "x"], "window": "hann", "detrend": "linear"}


def _grid(ny, nx, dy=0.5, dx=0.25):
    return {"time": np.arange(3.0), "y": np.arange(ny) * dy,
            "x": 10.0 + np.arange(nx) * dx}


def test_psd_reference_against_numpy_closed_form():
    """A plane plus a wave: the plane is removed exactly, and the spectrum
    is numpy's |fft2(hann * wave)|^2, scaled, shifted."""
    ny, nx, dy, dx = 24, 40, 0.5, 0.25
    c = _grid(ny, nx, dy, dx)
    i, j = np.meshgrid(np.arange(ny), np.arange(nx), indexing="ij")
    wave = np.cos(2 * np.pi * (3 * i / ny + 5 * j / nx))
    plane = 2.0 + 0.3 * i - 0.7 * j
    x = np.stack([wave + plane, 2 * wave - plane, wave])
    got = PSD.values(torch.as_tensor(x), c, ("time", "y", "x"), KW).numpy()
    # the wave's own plane fit, subtracted as numpy's lstsq would
    a = np.stack([np.ones(ny * nx), i.ravel() - (ny - 1) / 2,
                  j.ravel() - (nx - 1) / 2], axis=1)
    w = np.outer(0.5 - 0.5 * np.cos(2 * np.pi * np.arange(ny) / ny),
                 0.5 - 0.5 * np.cos(2 * np.pi * np.arange(nx) / nx))
    for k in range(3):
        coef = np.linalg.lstsq(a, x[k].ravel(), rcond=None)[0]
        res = x[k] - (a @ coef).reshape(ny, nx)
        f = np.fft.fftshift(np.fft.fft2(w * res))
        want = np.abs(f) ** 2 * (dy * dx) ** 2 / (ny * dy * nx * dx)
        np.testing.assert_allclose(got[k], want, rtol=1e-10,
                                   atol=1e-12 * want.max())
    dims, coords = PSD.labels(("time", "y", "x"), c, KW)
    assert dims == ("time", "freq_y", "freq_x")
    np.testing.assert_array_equal(
        coords["freq_x"], np.fft.fftshift(np.fft.fftfreq(nx, dx)))
    np.testing.assert_array_equal(coords["time"], c["time"])
    # Parseval: the density integrates to the windowed variance
    assert got[2].sum() / (ny * dy * nx * dx) == pytest.approx(
        (w * (wave - (a @ np.linalg.lstsq(a, wave.ravel(), rcond=None)[0])
              .reshape(ny, nx))) .__pow__(2).sum() * dy * dx
        / (ny * dy * nx * dx), rel=1e-10)


def test_ifft_reference_against_numpy_closed_form():
    """The inverse of numpy's rfft2, stored with freq_y fftshifted, is the
    field back, ifftshifted on both axes (shift=False)."""
    ny, nx, dy, dx = 16, 24, 0.5, 0.5
    rng = np.random.default_rng(0)
    field = rng.standard_normal((2, ny, nx))
    half = np.fft.fftshift(np.fft.rfft2(field), axes=-2)
    fy = np.fft.fftshift(np.fft.fftfreq(ny, dy))
    fx = np.fft.rfftfreq(nx, dx)
    kw = {"dim": ["freq_y", "freq_x"], "real_dim": "freq_x", "shift": False,
          "lag": None, "true_phase": False, "true_amplitude": False}
    coords = {"time": np.arange(2.0), "freq_y": fy, "freq_x": fx}
    dims = ("time", "freq_y", "freq_x")
    got = IFFT.values(torch.as_tensor(half), coords, dims, kw).numpy()
    np.testing.assert_allclose(got, np.fft.ifftshift(field, axes=(-2, -1)),
                               atol=1e-13)
    out_dims, out = IFFT.labels(dims, coords, kw)
    assert out_dims == ("time", "y", "x")
    np.testing.assert_allclose(out["y"], np.fft.fftfreq(ny, 1 / (ny * dy)))
    assert out["x"].size == nx


@pytest.mark.parametrize("name", ["mitgcm-4096.psd", "glorys12-daily.psd",
                                  "mitgcm-4096.irfft2",
                                  "mitgcm-4096.psd-hp"])
def test_program_passes_and_control_fails_at_test_size(name, tmp_path):
    """At a size a test can hold: the port on the CPU is inside the cell's
    limit; the control (the reference in the cell's lower precision) and
    the reference's output stored through float16 or bfloat16 are not."""
    root = H.tiny_root(tmp_path)
    cell = H.load_cell(root, name)
    ref = cells.entry_module("reference", cell.mix["entry"])
    ins = inputs.make(cell.config, cell.mix, 2 ** 31 + 11, "cpu")
    import xrft_tpu_torch as xt
    program = runner.Program(xt, cell, ins)
    limit = cell.limits["rel_err"]["limit"]
    x, coords = ins.args(0)
    out = program(0)
    chk = compare.checks([(lambda lo, hi: out.data[lo:hi], x, coords,
                           ins.dims, ins.kwargs, out)], ref, cell.limits)
    assert compare.passed(chk), chk
    lower = cell.limits["rel_err"]["control"]
    candidates = {
        lower: lambda lo, hi: ref.values(x[lo:hi], coords, ins.dims,
                                         ins.kwargs, lower),
        "float16": lambda lo, hi: ref.values(
            x[lo:hi], coords, ins.dims, ins.kwargs).to(torch.float16),
        "bfloat16": lambda lo, hi: ref.values(
            x[lo:hi], coords, ins.dims, ins.kwargs).to(torch.bfloat16)}
    for label, cand in candidates.items():
        e, t = compare.max_abs_err(cand, x, coords, ins.dims, ins.kwargs, ref)
        assert e / t > limit, (label, e / t, limit)


def test_harness_hands_the_reference_the_programs_inputs(tmp_path,
                                                         monkeypatch):
    """Every input the reference sees in a run is one the program saw:
    the same values and the same coordinates."""
    root = H.tiny_root(tmp_path)
    cell = H.load_cell(root, "glorys12-daily.psd")
    import xrft_tpu_torch as xt
    seen_program, seen_reference = [], []
    real_entry = xt.power_spectrum

    class Spy:
        LabeledArray = xt.LabeledArray

        @staticmethod
        def power_spectrum(da, **kw):
            seen_program.append((da.data.clone(),
                                 {c: v.values.copy()
                                  for c, v in da.coords.items()}))
            return real_entry(da, **kw)

    real_values = PSD.values

    def values(x, coords, dims, kwargs, precision="float64"):
        seen_reference.append((x.clone(), {c: np.array(v)
                                           for c, v in coords.items()}))
        return real_values(x, coords, dims, kwargs, precision)

    monkeypatch.setattr(PSD, "values", values)
    result, checks = runner.run(cell, 77, 0.05, False, device.Cpu(), 0.0,
                                Spy)
    assert result["correct"], checks
    assert len(seen_reference) >= 2          # the last call and the sample
    for x, coords in seen_reference:
        hit = False
        for px, pc in seen_program:
            for j in range(px.shape[0] - x.shape[0] + 1):
                if torch.equal(px[j:j + x.shape[0]], x):
                    lead = {k: (v[j:j + x.shape[0]] if k == "time" else v)
                            for k, v in pc.items()}
                    hit = hit or all(np.array_equal(lead[k], coords[k])
                                     for k in coords)
        assert hit


def test_tf32_rounding_keeps_ten_mantissa_bits():
    from reference._precision import rounded

    one = 1.0
    x = torch.tensor([one, one + 2 ** -10, one + 2 ** -11, one + 3 * 2 ** -11,
                      -(one + 2 ** -12), 3.0e-20], dtype=torch.float32)
    got = rounded(x, "tf32")
    want = torch.tensor([one, one + 2 ** -10, one, one + 2 ** -9, -one,
                         3.0e-20], dtype=torch.float32)
    want[-1] = rounded(want[-1:], "tf32")[0]
    assert torch.equal(got, want)
    bits = got.view(torch.int32) & 0x1FFF
    assert not bits.any()
    c = torch.complex(x, -x)
    assert torch.equal(rounded(c, "tf32"), torch.complex(got, -got))
    assert rounded(x, "float32") is x
