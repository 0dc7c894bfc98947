#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port, xrft_tpu_torch, on one NVIDIA GPU.

Run from the root of a checkout:

    python3 chip_smoke.py

It builds the package's CUDA kernels from ``xrft_tpu_torch/csrc`` with nvcc,
holds each kernel against its plain PyTorch version on the card, drives the
main path (the windowed, linearly detrended 2-D power spectrum of
8 x 4096 x 4096 float32 fields) through ``xrft_tpu_torch.power_spectrum`` and
checks it against the same pipeline in float64 through the plain routes, and
times the main path and each kernel beside its plain version.  Every phase
raises on failure; nothing is caught.  Its output ends with the card's name
and power limit, one JSON line on the kernels, and the JSON status line.
It fails, and prints no result, without a CUDA device or outside a checkout.
"""

import json
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

MAIN_SHAPE = (8, 4096, 4096)   # bench.py's flagship
ENTRY_SHAPE = (4, 256, 256)    # __graft_entry__.entry()
MAIN_KW = dict(dim=["y", "x"], window="hann", detrend="linear")
RUNS = 7                       # timed runs per measurement, after warm-up


def log(*args):
    print(*args, flush=True)


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()


def rel_err(got, ref) -> float:
    """max |got - ref| / max |ref|, in float64."""
    got, ref = got.to(ref.dtype), ref
    return ((got - ref).abs().max() / ref.abs().max()).item()


def check(cond: bool, what: str):
    if not cond:
        raise AssertionError(what)


def wall_ms(fn, runs=RUNS, warmup=2):
    """Median wall time in ms of fn(), each run bracketed by synchronize."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(runs):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def ab_ms(plain, kernel, rounds=RUNS):
    """Medians (plain, kernel) in ms, timed in turns plain, kernel, kernel,
    plain so that drift hits both alike."""
    wall_ms(plain, runs=1)
    wall_ms(kernel, runs=1)
    tp, tk = [], []
    for _ in range(rounds):
        tp.append(wall_ms(plain, runs=1, warmup=0))
        tk.append(wall_ms(kernel, runs=2, warmup=0))
        tp.append(wall_ms(plain, runs=1, warmup=0))
    return statistics.median(tp), statistics.median(tk)


def field(shape, seed, dtype=torch.float32):
    g = torch.Generator(device="cuda").manual_seed(seed)
    return torch.randn(shape, generator=g, device="cuda", dtype=dtype)


def labeled(xt, data):
    B, NY, NX = data.shape
    return xt.LabeledArray(
        data, dims=("time", "y", "x"),
        coords={"time": np.arange(B, dtype=np.float64),
                "y": np.arange(NY) * 0.5, "x": np.arange(NX) * 0.5})


def main():
    # ---- phase 1: device, versions, build --------------------------------
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device "
                         "(torch.cuda.is_available() is false)")
    import xrft_tpu_torch as xt
    from xrft_tpu_torch.config import fft_impl, psd_mirror_impl
    from xrft_tpu_torch.ops import _build, fft_fourstep, mirror

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = card_line()
    log(f"phase 1: {card}; torch {torch.__version__}, CUDA "
        f"{torch.version.cuda}, python {sys.version.split()[0]}")
    t0 = time.perf_counter()
    for name in ("mirror", "fft_fourstep"):
        _build.load(name)
    log(f"phase 1: csrc built and loaded in {time.perf_counter() - t0:.2f} s "
        f"(nvcc per source: {_build.build_seconds or 'up to date'})")

    # ---- phase 2: K1 against its plain version ---------------------------
    k1_err = 0.0
    for shape, nx in (((8, 4096, 2049), 4096), ((3, 1001, 499), 997)):
        F = field(shape, 1, torch.complex64)
        for shift in (True, False):
            got = mirror.mirror_psd(F, nx, shift, 0.37)
            ref = mirror.mirror_psd_plain(F, nx, shift, 0.37)
            torch.cuda.synchronize()
            torch.testing.assert_close(got, ref, rtol=1e-6, atol=0)
            err = (got - ref).abs().max().item()
            if shape[0] == 8:
                k1_err = max(k1_err, err)
            log(f"phase 2: K1 {shape}->{nx} shift={shift}: max abs err "
                f"{err:.3e} (rtol 1e-6)")
        del F, got, ref

    # ---- phase 3: K2 against its plain version and cuFFT -----------------
    k2_err = 0.0
    main_k2 = {(32768, 4096, False), (16392, 4096, True)}
    for rows, n, cplx, sign in ((32768, 4096, False, -1),
                                (16392, 4096, True, -1),
                                (4096, 256, True, -1),
                                (4096, 1000, False, -1),
                                (4096, 1000, True, 1)):
        x = field((rows, n), 2, torch.complex64 if cplx else torch.float32)
        got = fft_fourstep.fft_last(x, sign)
        plain = fft_fourstep.fft_last_plain(x, sign)
        x64 = x.to(torch.complex128)
        ref = torch.fft.fft(x64) if sign == -1 else torch.fft.ifft(x64) * n
        torch.cuda.synchronize()
        e_plain, e_ref = rel_err(got, plain.to(torch.complex128)), \
            rel_err(got, ref)
        check(e_plain <= 1e-5 and e_ref <= 1e-5,
              f"K2 n={n} rows={rows}: {e_plain:.3e} / {e_ref:.3e} > 1e-5")
        if (rows, n, cplx) in main_k2:
            k2_err = max(k2_err, (got - plain).abs().max().item())
        log(f"phase 3: K2 ({rows}, {n}) {'complex' if cplx else 'real'} "
            f"sign {sign:+d}: rel err vs plain {e_plain:.3e}, vs "
            f"complex128 cuFFT {e_ref:.3e} (limit 1e-5)")
        del x, got, plain, x64, ref

    # ---- phase 4: the main path ------------------------------------------
    da = labeled(xt, field(MAIN_SHAPE, 0))
    da64 = labeled(xt, da.data.double())
    with fft_impl("torch"), psd_mirror_impl("plain"):
        ref = xt.power_spectrum(da64, **MAIN_KW)
    mirror.mirror_psd.launches = 0
    fft_fourstep.fft_last.launches = 0
    with fft_impl("kernel"):
        ps_kernel = xt.power_spectrum(da, **MAIN_KW)
    torch.cuda.synchronize()
    launches = {"mirror_psd": mirror.mirror_psd.launches,
                "fft_fourstep": fft_fourstep.fft_last.launches}
    log(f"phase 4: main path {MAIN_SHAPE} under fft_impl='kernel': kernel "
        f"launches {launches}")
    check(all(v > 0 for v in launches.values()),
          f"a kernel of the main path was not launched: {launches}")
    mirror.mirror_psd.launches = 0
    with fft_impl("torch"):
        ps_torch = xt.power_spectrum(da, **MAIN_KW)
    torch.cuda.synchronize()
    check(mirror.mirror_psd.launches > 0,
          "fft_impl='torch' main path did not launch K1")
    for impl, ps in (("kernel", ps_kernel), ("torch", ps_torch)):
        check(ps.dims == ("time", "freq_y", "freq_x")
              and ps.shape == MAIN_SHAPE and ps.dtype == torch.float32,
              f"{impl}: unexpected output {ps!r}")
        check(bool(torch.isfinite(ps.data).all()), f"{impl}: non-finite PSD")
        for d in ("freq_y", "freq_x"):
            c = ps.coords[d]
            check(np.allclose(c.attrs["spacing"], 1 / (4096 * 0.5))
                  and np.array_equal(c.values, ref.coords[d].values),
                  f"{impl}: bad {d} coordinate")
        err = rel_err(ps.data, ref.data)
        check(err <= 1e-5, f"{impl}: rel err {err:.3e} vs float64 > 1e-5")
        log(f"phase 4: fft_impl={impl!r}: rel err vs float64 plain "
            f"pipeline {err:.3e} (limit 1e-5)")
    del ref, da64, ps_kernel, ps_torch

    # the entry shape, with Parseval: sum(P) df_y df_x == mean(|w*detrended|^2)
    rng = np.random.RandomState(0)
    small = labeled(xt, torch.as_tensor(
        rng.randn(*ENTRY_SHAPE).astype(np.float32), device="cuda"))
    ps = xt.power_spectrum(small, **MAIN_KW)
    from xrft_tpu_torch.ops.window import apply_window

    _, windowed = apply_window(xt.detrend(small, ["y", "x"], "linear"),
                               ["y", "x"])
    df = ps.coords["freq_y"].attrs["spacing"] * \
        ps.coords["freq_x"].attrs["spacing"]
    lhs = ps.data.double().sum(dim=(1, 2)) * df
    rhs = (windowed.data.double() ** 2).mean(dim=(1, 2))
    err = ((lhs - rhs).abs() / rhs).max().item()
    check(err <= 1e-5, f"entry shape: Parseval rel err {err:.3e} > 1e-5")
    log(f"phase 4: entry shape {ENTRY_SHAPE}: Parseval rel err {err:.3e} "
        f"(limit 1e-5)")

    # ---- phase 5: timings ------------------------------------------------
    log(f"phase 5: timings on {card}, median of {RUNS}+ runs after warm-up, "
        f"each between torch.cuda.synchronize() calls")

    def main_path(impl):
        def run():
            with fft_impl(impl):
                xt.power_spectrum(da, **MAIN_KW)
        return run

    t_main_torch, t_main_kernel = ab_ms(main_path("torch"),
                                                main_path("kernel"))
    log(f"phase 5: main path {MAIN_SHAPE}: fft_impl='torch' "
        f"{t_main_torch:.3f} ms, fft_impl='kernel' "
        f"{t_main_kernel:.3f} ms [{card}]")
    with psd_mirror_impl("plain"):
        t_main_plain = wall_ms(main_path("torch"))
    log(f"phase 5: main path, fft_impl='torch' with psd_mirror_impl='plain' "
        f"(no hand kernel): {t_main_plain:.3f} ms [{card}]")
    del da

    F = field((8, 4096, 2049), 3, torch.complex64)
    k1_plain, k1_ms = ab_ms(lambda: mirror.mirror_psd_plain(F, 4096, True, 1.0),
                            lambda: mirror.mirror_psd(F, 4096, True, 1.0))
    gbytes = (F.numel() * 8 + 8 * 4096 * 4096 * 4) / 1e9
    log(f"phase 5: K1 (8, 4096, 2049)->4096: kernel {k1_ms:.3f} ms "
        f"({gbytes / k1_ms * 1e3:.0f} GB/s of the {gbytes:.2f} GB it must move), "
        f"plain {k1_plain:.3f} ms [{card}]")
    del F

    k2_ms = k2_plain = 0.0
    for rows, cplx in ((32768, False), (16392, True)):
        x = field((rows, 4096), 4, torch.complex64 if cplx else torch.float32)
        tp, tk = ab_ms(lambda: fft_fourstep.fft_last_plain(x),
                       lambda: fft_fourstep.fft_last(x))
        t_cufft = wall_ms(lambda: torch.fft.fft(x))
        k2_ms += tk
        k2_plain += tp
        log(f"phase 5: K2 ({rows}, 4096) {'complex' if cplx else 'real'}: "
            f"kernel {tk:.3f} ms, plain {tp:.3f} ms, torch.fft.fft (cuFFT) "
            f"{t_cufft:.3f} ms [{card}]")
        del x

    log(card)
    log(json.dumps({"kernels": [
        {"name": "mirror_psd", "route": "cuda",
         "source": "xrft_tpu_torch/csrc/mirror.cu",
         "replaces": "xrft_tpu/ops/pallas_mirror.py:82",
         "launches": launches["mirror_psd"], "max_abs_err": k1_err,
         "ms": k1_ms, "plain_ms": k1_plain},
        {"name": "fft_fourstep", "route": "cuda",
         "source": "xrft_tpu_torch/csrc/fft_fourstep.cu",
         "replaces": "xrft_tpu/ops/pallas_fft.py:284",
         "launches": launches["fft_fourstep"], "max_abs_err": k2_err,
         "ms": k2_ms, "plain_ms": k2_plain},
    ]}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
