#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port, xrft_tpu_torch, on one NVIDIA GPU.

Run from the root of a checkout:

    python3 chip_smoke.py

It builds the package's CUDA kernels from ``xrft_tpu_torch/csrc`` with nvcc
(one nvcc per source, all at once), holds each kernel against its plain
PyTorch version on the card, and drives four paths at full width:

  * the main path, the windowed, linearly detrended 2-D power spectrum of
    8 x 4096 x 4096 float32 fields (``xrft_tpu_torch.power_spectrum``),
    against the same pipeline in float64 through the plain routes;
  * the isotropic path, the same spectrum summed into 1024 radial bins
    (``isotropic_power_spectrum``), with the 2048^2 grid of config 3 and the
    isotropic cross spectrum of a (2, 4096, 4096) pair;
  * the float64 precision path, the same spectrum with ``engine="hp"``
    under cuFFT in complex128 and under the FP64 kernel K4, with config 2's
    1024^2 field against the numpy float64 closed form, the hp roundtrips,
    the hp fft at 2048^2 and the isotropic hp spectrum;
  * the inverse flagship, ``ifft`` of an 8 x 4096 x 2049 complex64 half
    spectrum to 8 x 4096 x 4096, under cuFFT and under K2 with sign +1;
  * the matmul route, the flagship PSD under ``fft_impl="matmul"`` with its
    level-0 product on K5a, unpacked and packed;
  * the segmented estimators at full width: the Welch flagship (8 x 4096^2
    in 1024^2 hann segments, without and with 50% overlap) under cuFFT and
    the matmul route, the spectrogram, stft/istft and csd/coherence of
    8 x 2^22-sample series, and the hp Welch of one 1024^2 field against
    numpy float64;
  * pad in every mode on the card against numpy.pad;
  * the scipy-namesake families at full width, each against its float64
    result through cuFFT (and scipy on the host where that is cheap): the
    DCT flagship (dct along x then y of 8 x 4096^2) with DCT-I, DST-I and
    DCT-IV, the float64 dctn under cuFFT and the K4 recursion, hilbert2,
    hilbert and envelope, fftconvolve and the direct convolution of a
    4096^2 field with a 63^2 kernel and the direct/fft crossover table,
    oaconvolve, resample_poly, decimate, savgol_filter and upfirdn on the
    8 x 2^22 signal, zoom_fft and czt, fht/ifht of 4096 float64 profiles,
    resample, and lombscargle of 64 x 65,536 samples at 16,384 frequencies.
    Their K2 and K4 launches are counted from 0 around each "kernel" run;
  * the sharded path on a one-rank NCCL group (phase 25);
  * the matmul engine's pair path under ``fft_impl="matmul"`` (phase 26):
    the inverse flagship's irfftn, the PSD and the shifted fft of a GLORYS12
    stack (8 x 2041 x 4320; 2041 = 13 x 157 takes K2 and Bluestein), DST-I
    at 8194 points and the istft of 8 x 2^22 samples, each with its K1-K5
    launches counted and checked, and K2 at those shapes against cuFFT and
    the engine's einsum recursion;
  * integer, float16 and complex input at full width (phase 27): the
    flagship PSD of uint16 counts under every fft_impl and of int32 counts
    under cuFFT and the K4 recursion, welch, spectrogram and periodogram of
    int16 series, pad of complex64 data in the modes that order complex
    values, and float16 transforms, each held to xrft_tpu's dtype rules;
    then float16 namesakes (dct/idct, dctn/idctn, DCT-I and DST-I, czt of
    the flagship, resample_poly, decimate and savgol_filter of the 8 x 2^22
    signal), each bit for bit the float32 call on the same values, with its
    launches, within 1e-5 of the float64 values;
  * fields far from zero mean (phase 28): the flagship PSD of SST in
    kelvin and of surface pressure in Pa under every fft_impl and the Welch
    flagship of SST, each within 1e-5 of the same call on the float64
    values, and the flagship's prologue time;
  * K6, the detrend-and-window prologue (phase 29): its registers and
    spills as ptxas reports them, K6 against its plain version in float32
    and float64 over two axes and three, and its time on the flagship and
    GLORYS12 stacks of 64 fields in float32, the flagship's in float64 and
    one rank's 512 x 2048^2 slab of the dns-2048 cube over (z, y, x),
    beside its bound and the plain version, each timed stack also held to
    the plain version's output.

``python3 chip_smoke.py --prologue`` times the flagship and its prologue
alone (phase 28's timing), for the package beside the script;
``python3 chip_smoke.py --k6 [DIR]`` runs phase 29 alone, and with DIR,
another checkout (say the parent commit, unpacked by ``git archive``),
holds each timed stack's output bit for bit to that checkout's K6 and
times the two in turns in one process.

It times each path and each kernel beside its plain version, the one
PyTorch call that computes the same function where there is one, and the
least time the card could take (bytes at 3.35 TB/s or operations at the
FP32/FP64/TF32 peak, whichever is longer), and checks that the built dot
library holds tensor-core and TMA instructions (HGMMA, UTMALDG and UTMASTG
in its SASS).  Every phase
raises on failure; nothing is caught.  Its output ends with the card's name
and power limit, one JSON line on the kernels, and the JSON status line.
It fails, and prints no result, without a CUDA device or outside a checkout.
"""

import json
import statistics
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from functools import partial

import numpy as np
import scipy.signal as sps
import torch

MAIN_SHAPE = (8, 4096, 4096)   # bench.py's flagship
ENTRY_SHAPE = (4, 256, 256)    # __graft_entry__.entry()
MAIN_KW = dict(dim=["y", "x"], window="hann", detrend="linear")
ISO_KW = dict(MAIN_KW, truncate=True)
CONFIG3_SHAPE = (2048, 2048)   # bench.py's config 3 large grid
CONFIG3_KW = dict(dim=["y", "x"], truncate=True)   # 512 bins
CROSS_SHAPE = (2, 4096, 4096)
HP_KW = dict(MAIN_KW, engine="hp")
CONFIG2_N = 1024               # bench.py:500-515, config 2's hp shape
HP_FFT_N = 2048                # bench.py:517-529
INV_SHAPE = (8, 4096, 2049)    # bench.py:337-383, the inverse flagship
INV_KW = dict(dim=["freq_y", "freq_x"], real_dim="freq_x", shift=False,
              true_phase=False, true_amplitude=False, lag=None)
# K4's shapes: (131072, 256), the direct prime stage at 251, and the
# recursion at 4096 (8 x 4096 rows); the hp path at 8 x 4096^2 runs
# (524288, 256) and (8388608, 16) on each axis
K4_SHAPES = ((131072, 256), (4096, 251), (524288, 256), (8388608, 16),
             (32768, 4096))
K4_MAIN = {(524288, 256), (8388608, 16)}
RUNS = 7                       # timed runs per measurement, after warm-up
SOURCES = ("mirror", "fft_fourstep", "binned_sum", "dft64", "dot",
           "prologue")
# K5's shapes: the flagship's level-0 operand (the x axis split (32, 128):
# 8*4096 blocks of 32 x 128) and the packed A/B shape
# (scripts/perf_pallas_dot.py:91-146)
K5_ENGINE = (MAIN_SHAPE[0] * MAIN_SHAPE[1], 32, 128)
K5_PACKED_N = 1 << 20
WELCH_SEG = 1024               # bench.py:385-411
SG_SHAPE, SG_SEG, SG_DT = (8, 1 << 22), 4096, 2.5e-4   # bench.py:413-445
HP_WELCH_N, HP_WELCH_SEG = 1024, 256
# the scipy-namesake phases: bench.py:457-487's convolution operands, the
# square kernels of the direct/fft crossover, the filter taps, the Hankel
# profiles, the resampled length, the Lomb-Scargle series and frequencies
CONV_N, CONV_K = 4096, 63
CROSSOVER_KS = (3, 7, 15, 31, 63, 127)
FIR_TAPS = 255
FHT_SHAPE = (4096, 4096)
RESAMPLE_NUM = 3000
LS_SHAPE, LS_FREQS = (64, 65536), 16384
# the matmul engine's pair path: 8 daily fields of Copernicus Marine's
# GLORYS12V1 global 1/12 degree reanalysis grid (GLOBAL_MULTIYEAR_PHY_001_030:
# 4320 lon x 2041 lat, 2041 = 13 x 157), and K2's shapes on it (the packed
# rfft along lon at 2160, lat at 2041, the Bluestein transforms at 512)
GLORYS_SHAPE = (8, 2041, 4320)
GLORYS_KW = dict(dim=["lat", "lon"], window="hann", detrend="linear")
PAIR_K2_SHAPES = ((16328, 2160), (17288, 2041), (449280, 512))
# H100 SXM peaks (NVIDIA's data sheet): HBM3, FP32 outside the tensor cores,
# FP64 on the tensor cores, dense TF32 on the tensor cores
HBM_BYTES_S, FP32_FLOP_S, FP64_FLOP_S = 3.35e12, 67e12, 67e12
TF32_FLOP_S = 495e12
T0 = time.perf_counter()
DEV = "cuda"


def log(*args):
    print(f"[{time.perf_counter() - T0:7.1f} s]", *args, flush=True)


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()


def dot_sass(build) -> list:
    """The tensor-core and TMA instructions (HGMMA, HMMA in TF32, UTMALDG,
    UTMASTG, UBLKCP) in the SASS of the built dot library, as cuobjdump
    prints them."""
    from pathlib import Path

    tool = Path(build._nvcc()).parent / "cuobjdump"
    lib = build.BUILD_DIR / f"dot-{build.digest('dot')}.so"
    text = subprocess.run([str(tool), "-sass", str(lib)], capture_output=True,
                          text=True, check=True).stdout
    out = []
    for line in text.splitlines():
        ins = line.split("*/")[1].strip() if "*/" in line else ""
        if ins.startswith(("HGMMA", "UTMALDG", "UTMASTG", "UBLKCP")) or (
                ins.startswith("HMMA") and "TF32" in ins):
            out.append(ins)
    return out


def rel_err(got, ref) -> float:
    """max |got - ref| / max |ref|, in float64."""
    got, ref = got.to(ref.dtype), ref
    return ((got - ref).abs().max() / ref.abs().max()).item()


def check(cond: bool, what: str):
    if not cond:
        raise AssertionError(what)


def bound(nbytes, flops, peak=FP32_FLOP_S):
    """(ms, "bytes" or "operations"): the least time the card could take to
    move ``nbytes`` (each input read once, each output written once) and do
    ``flops``, whichever takes longer."""
    tb, to = nbytes / HBM_BYTES_S * 1e3, flops / peak * 1e3
    return (tb, "bytes") if tb >= to else (to, "operations")


def fft_flops(rows, n):
    """5 n log2 n per complex row: the operation count of a radix-2 FFT, the
    least any DFT algorithm is held to here."""
    return 5.0 * n * np.log2(n) * rows


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


def event_ms(fn, runs=20, warmup=3, batch=5):
    """Median device time in ms of one fn() between two CUDA events around
    ``batch`` calls back to back (the kernel alone: neither the host's
    synchronize nor, once the queue runs ahead, its launch overhead)."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(runs):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(batch):
            fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end) / batch)
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
    g = torch.Generator(device=DEV).manual_seed(seed)
    return torch.randn(shape, generator=g, device=DEV, dtype=dtype)


def labeled(xt, data):
    B, NY, NX = data.shape
    return xt.LabeledArray(
        data, dims=("time", "y", "x"),
        coords={"time": np.arange(B, dtype=np.float64),
                "y": np.arange(NY) * 0.5, "x": np.arange(NX) * 0.5})


def config3_field(xt):
    """bench.py's config 3 large grid: one 2048^2 field, unit spacing."""
    n3 = CONFIG3_SHAPE[0]
    return xt.LabeledArray(field(CONFIG3_SHAPE, 9), dims=("y", "x"),
                           coords={"y": np.arange(n3) * 1.0,
                                   "x": np.arange(n3) * 1.0})


def radial_codes(binning, n, nbins, dx):
    """pd.cut codes of the fftshifted radial wavenumber of an n x n grid."""
    k = np.fft.fftshift(np.fft.fftfreq(n, dx))
    return binning.cut_codes(np.sqrt(k[:, None] ** 2 + k[None, :] ** 2), nbins)


def odd_codes(binning):
    """1001 x 999 radial codes into 250 bins, every 97th point dropped."""
    k0 = np.fft.fftshift(np.fft.fftfreq(1001, 0.3))
    k1 = np.fft.fftshift(np.fft.fftfreq(999, 0.3))
    codes, nbins = binning.cut_codes(
        np.sqrt(k0[:, None] ** 2 + k1[None, :] ** 2), 250)
    codes[::97] = -1
    return codes, nbins


def bincount_oracle(x, codes, nbins):
    """float64 per-bin sums by torch.bincount on the card, per component."""
    c = torch.as_tensor(codes.astype(np.int64), device=x.device)
    keep = c >= 0
    ck = c[keep]

    def real(v):
        rows = [torch.bincount(ck, weights=r[keep].double(), minlength=nbins)
                for r in v.reshape(-1, v.shape[-1])]
        return torch.stack(rows).reshape(v.shape[:-1] + (nbins,))

    if x.is_complex():
        return torch.complex(real(x.real), real(x.imag))
    return real(x)


def k3_phase(binning, card):
    """K3 against its plain version and a float64 bincount oracle, with two
    launches compared bit for bit, then K3 alone timed against plain."""
    result = {}
    n, n3 = MAIN_SHAPE[-1], CONFIG3_SHAPE[-1]
    cases = (("full", radial_codes(binning, n, n // 4, 0.5), MAIN_SHAPE[:1]),
             ("config3", radial_codes(binning, n3, n3 // 4, 1.0), (1,)),
             ("odd", odd_codes(binning), (3,)))
    for name, (codes, nbins), batch in cases:
        plan = binning.BinPlan(codes, nbins)
        t0 = time.perf_counter()
        plan.on(DEV)
        log(f"phase 6: K3 plan {name} ({codes.size} points, {nbins} bins) "
            f"built and copied in {time.perf_counter() - t0:.3f} s")
        shape = batch + (codes.size,)
        for dtype in (torch.float32, torch.float64, torch.complex64):
            x = field(shape, 7, dtype)
            got = binning.binned_sum(x, plan)
            again = binning.binned_sum(x, plan)
            plain = binning.binned_sum_plain(x, plan)
            ref = bincount_oracle(x, codes, nbins)
            torch.cuda.synchronize()
            check(got.dtype == dtype and got.shape == batch + (nbins,),
                  f"K3 {name} {dtype}: output {got.dtype} {tuple(got.shape)}")
            check(torch.equal(got, again),
                  f"K3 {name} {dtype}: two launches differ")
            single = dtype in (torch.float32, torch.complex64)
            e_ref = rel_err(got, ref)
            e_plain = rel_err(got, plain.to(ref.dtype))
            # the plain route's float32 prefix difference carries about
            # 2^-24 of the running prefix, hence its wider limit
            lim_ref, lim_plain = (2e-6, 1e-5) if single else (1e-12, 1e-12)
            check(e_ref <= lim_ref and e_plain <= lim_plain,
                  f"K3 {name} {dtype}: rel err {e_ref:.3e} vs float64 oracle "
                  f"(limit {lim_ref}), {e_plain:.3e} vs plain "
                  f"(limit {lim_plain})")
            if name == "full" and dtype == torch.float32:
                result["max_abs_err"] = (got - plain).abs().max().item()
            log(f"phase 6: K3 {name} {tuple(shape)} {dtype}: rel err vs "
                f"float64 bincount {e_ref:.3e} (limit {lim_ref}), vs plain "
                f"{e_plain:.3e} (limit {lim_plain}); two launches "
                f"bit-identical")
            del x, got, again, plain, ref
        if name != "odd":
            x = field(shape, 8)
            tp, tk = ab_ms(lambda: binning.binned_sum_plain(x, plan),
                           lambda: binning.binned_sum(x, plan))
            ev = event_ms(lambda: binning.binned_sum(x, plan))
            # the one PyTorch call: index_add_ along the point axis, the
            # out-of-range points into a spare bin
            idx = torch.as_tensor(np.where(codes >= 0, codes, nbins),
                                  dtype=torch.long, device=DEV)
            spare = torch.zeros(batch + (nbins + 1,), device=DEV)
            t_lib = wall_ms(lambda: spare.zero_().index_add_(1, idx, x))
            # the function's bytes: the data once, pandas' codes once (int16
            # at 1024 bins) and the output once, whatever the plan's layout
            nbytes = x.numel() * 4 + codes.size * codes.itemsize + \
                x.shape[0] * nbins * 4
            b_ms, b_by = bound(nbytes, x.numel())
            h = plan.host()
            nslots = h["run_slot"].size
            log(f"phase 6: K3 {name} {tuple(shape)} float32: kernel "
                f"{tk:.3f} ms in the A/B loop, {ev:.3f} ms back to back "
                f"({b_ms / ev:.1%} of the {b_by} bound {b_ms:.3f} ms: "
                f"{nbytes / 1e9:.4f} GB); plain {tp:.3f} ms, index_add_ "
                f"{t_lib:.3f} ms; plan: {h['tile_run'].size - 1} tiles of "
                f"{h['tile']} points, {nslots} runs, slots "
                f"{2 * nslots * x.shape[0] * 4 / (x.numel() * 4):.1%} of the "
                f"data [{card}]")
            if name == "full":
                result.update(ms=tk, plain_ms=tp, library_ms=t_lib,
                              bound_ms=b_ms, bound_by=b_by, event_ms=ev)
            del x, idx, spare
    return result


def isotropic_phase(xt, binning, mirror):
    """The isotropic path at full width against the float64 pipeline
    through the plain routes, config 3's 2048^2 grid, and the isotropic
    cross spectrum; returns K3's launches on the isotropic path."""
    from xrft_tpu_torch.config import (binned_sum_impl, fft_impl,
                                       psd_mirror_impl)

    def plain64(da, **kw):
        da64 = da.copy(data=da.data.double())
        with fft_impl("torch"), psd_mirror_impl("plain"), \
                binned_sum_impl("plain"):
            return xt.isotropic_power_spectrum(da64, **kw)

    da = labeled(xt, field(MAIN_SHAPE, 0))
    ref = plain64(da, **ISO_KW)
    mirror.mirror_psd.launches = 0
    binning.binned_sum.launches = 0
    iso = xt.isotropic_power_spectrum(da, **ISO_KW)
    torch.cuda.synchronize()
    launches = {"binned_sum": binning.binned_sum.launches,
                "mirror_psd": mirror.mirror_psd.launches}
    log(f"phase 7: isotropic path {MAIN_SHAPE}: kernel launches {launches}")
    check(all(v > 0 for v in launches.values()),
          f"a kernel of the isotropic path was not launched: {launches}")
    nbins = MAIN_SHAPE[-1] // 4
    check(iso.dims == ("time", "freq_r")
          and iso.shape == (MAIN_SHAPE[0], nbins)
          and iso.dtype == torch.float32, f"unexpected output {iso!r}")
    check(bool(torch.isfinite(iso.data).all()), "non-finite isotropic PSD")
    kr, kr_ref = iso.coords["freq_r"].values, ref.coords["freq_r"].values
    check(np.array_equal(kr, kr_ref, equal_nan=True),
          "freq_r differs from the float64 run's")
    err = rel_err(iso.data, ref.data)
    check(err <= 1e-5, f"isotropic path: rel err {err:.3e} vs float64 > 1e-5")
    ps = xt.power_spectrum(da, **MAIN_KW)
    tot_ps = ps.data.double().sum(dim=(1, 2))
    cons = ((iso.data.double().sum(dim=1) - tot_ps).abs() / tot_ps).max()
    check(cons.item() <= 1e-5, f"conservation rel err {cons.item():.3e}")
    log(f"phase 7: isotropic path: rel err vs float64 plain pipeline "
        f"{err:.3e} (limit 1e-5); sum(iso) vs sum(PSD) rel err "
        f"{cons.item():.3e} (limit 1e-5); freq_r equal to the float64 run's, "
        f"{int(np.isnan(kr).sum())} NaN (beyond Nyquist) of {nbins}")
    del da, ref, iso, ps

    da3 = config3_field(xt)
    ref3 = plain64(da3, **CONFIG3_KW)
    before = binning.binned_sum.launches
    iso3 = xt.isotropic_power_spectrum(da3, **CONFIG3_KW)
    torch.cuda.synchronize()
    err3 = rel_err(iso3.data, ref3.data)
    check(binning.binned_sum.launches > before
          and iso3.shape == (CONFIG3_SHAPE[0] // 4,) and err3 <= 1e-5,
          f"config 3: rel err {err3:.3e} vs float64")
    log(f"phase 7: config 3 {CONFIG3_SHAPE}: rel err vs float64 {err3:.3e} "
        f"(limit 1e-5)")
    del da3, ref3, iso3

    # the cross path: self cross spectrum of a (2, 4096, 4096) pair
    dac = labeled(xt, field(CROSS_SHAPE, 5))
    before = binning.binned_sum.launches
    cs = xt.isotropic_cross_spectrum(dac, dac, **ISO_KW)
    n_cross = binning.binned_sum.launches - before
    ps_iso = xt.isotropic_power_spectrum(dac, **ISO_KW)
    torch.cuda.synchronize()
    # isotropize sums the complex cross spectrum as it is, so K3 ran on
    # complex64 data if it ran and the result is complex64
    check(n_cross > 0 and cs.dtype == torch.complex64,
          f"cross path: {n_cross} K3 launches, dtype {cs.dtype}")
    errc = rel_err(cs.data.real, ps_iso.data.double())
    check(errc <= 1e-6, f"cross path: Re(iso cross) vs iso PSD {errc:.3e}")
    log(f"phase 7: isotropic cross spectrum {CROSS_SHAPE}: K3 ran "
        f"{n_cross}x on complex64; Re(self cross) vs isotropic PSD rel err "
        f"{errc:.3e} (limit 1e-6)")
    return launches["binned_sum"]


def device_split(fn, label, card, calls=3):
    """Device time per kernel of fn() from one torch.profiler run (kernel
    events only: an aten op's own entry repeats its kernels' time); returns
    (device ms, wall ms) per call."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3 / calls
    rows = []
    for e in prof.key_averages():
        t = getattr(e, "self_device_time_total", None)
        if t is None:
            t = e.self_cuda_time_total
        if e.device_type == DeviceType.CUDA and t > 0:
            rows.append((t / 1e3 / calls, e.key))
    rows.sort(reverse=True)
    dev = sum(t for t, _ in rows)
    if not rows:
        log(f"{label}: the profiler recorded no device time")
        return dev, wall
    log(f"{label}: device {dev:.3f} ms per call against {wall:.3f} ms of "
        f"wall time under the profiler, idle share {1 - dev / wall:.1%} "
        f"[{card}]")
    for t, name in rows[:14]:
        log(f"    {t:8.3f} ms  {name[:100]}")
    return dev, wall


def isotropic_timings(xt, binning, card):
    from xrft_tpu_torch.config import binned_sum_impl
    from xrft_tpu_torch.isotropic import _radial_plan

    da = labeled(xt, field(MAIN_SHAPE, 0))

    def iso(impl, da=da, kw=ISO_KW):
        def run():
            with binned_sum_impl(impl):
                xt.isotropic_power_spectrum(da, **kw)
        return run

    _radial_plan.cache_clear()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    iso("kernel")()
    torch.cuda.synchronize()
    first = (time.perf_counter() - t0) * 1e3
    tp, tk = ab_ms(iso("plain"), iso("kernel"))
    t_ps = wall_ms(lambda: xt.power_spectrum(da, **MAIN_KW))
    log(f"phase 8: isotropic path {MAIN_SHAPE}: first call (host plan "
        f"built) {first:.1f} ms; steady state binned_sum_impl='kernel' "
        f"{tk:.3f} ms, 'plain' {tp:.3f} ms; power_spectrum alone "
        f"{t_ps:.3f} ms [{card}]")
    device_split(iso("kernel"), "phase 8: isotropic path, 'kernel'", card)
    device_split(iso("plain"), "phase 8: isotropic path, 'plain'", card)
    del da

    da3 = config3_field(xt)
    tp3, tk3 = ab_ms(iso("plain", da3, CONFIG3_KW),
                     iso("kernel", da3, CONFIG3_KW))
    log(f"phase 8: config 3 {CONFIG3_SHAPE}: binned_sum_impl='kernel' "
        f"{tk3:.3f} ms, 'plain' {tp3:.3f} ms [{card}]")


def k4_phase(dft64, card):
    """K4 against its plain version (n <= 256) and complex128 cuFFT, with
    two launches compared bit for bit, then timed against both; returns its
    error and times at the hp path's two shapes."""
    result = {"max_abs_err": 0.0, "ms": 0.0, "plain_ms": 0.0,
              "library_ms": 0.0}
    nbytes = flops = 0.0
    for rows, n in K4_SHAPES:
        x = field((rows, n), 11, torch.complex128)
        signs = (-1, 1) if (rows, n) not in K4_MAIN else (-1,)
        for sign in signs:
            got = dft64.fft_last(x, sign)
            again = dft64.fft_last(x, sign)
            ref = torch.fft.fft(x) if sign == -1 else torch.fft.ifft(x) * n
            # the recursion has no plain version of its own: cuFFT is its
            # oracle, and K4 meets its plain version inside it at n <= 256
            plain = dft64.dft_last_plain(x, sign) if n <= 256 else got
            torch.cuda.synchronize()
            check(torch.equal(got, again),
                  f"K4 ({rows}, {n}) sign {sign:+d}: two launches differ")
            e_ref, e_plain = rel_err(got, ref), rel_err(got, plain)
            check(e_ref <= 1e-12 and e_plain <= 1e-13,
                  f"K4 ({rows}, {n}) sign {sign:+d}: rel err {e_ref:.3e} vs "
                  f"cuFFT (limit 1e-12), {e_plain:.3e} vs plain (limit 1e-13)")
            if (rows, n) in K4_MAIN:
                result["max_abs_err"] = max(result["max_abs_err"],
                                            (got - plain).abs().max().item())
            log(f"phase 9: K4 ({rows}, {n}) complex128 sign {sign:+d}"
                f"{' (recursion)' if n > 256 else ''}: rel err vs "
                f"complex128 cuFFT {e_ref:.3e} (limit 1e-12)"
                + (f", vs plain {e_plain:.3e} (limit 1e-13)" if n <= 256
                   else "") + "; two runs bit-identical")
            del got, again, ref, plain
        t_cufft = wall_ms(lambda: torch.fft.fft(x))
        if n <= 256:
            tp, tk = ab_ms(lambda: dft64.dft_last_plain(x),
                           lambda: dft64.dft_last(x))
            if (rows, n) in K4_MAIN:
                result["ms"] += tk
                result["plain_ms"] += tp
                result["library_ms"] += t_cufft
                nbytes += 2 * rows * n * 16
                flops += fft_flops(rows, n)
            b_ms = bound(2 * rows * n * 16, fft_flops(rows, n), FP64_FLOP_S)[0]
            log(f"phase 9: K4 ({rows}, {n}): kernel {tk:.3f} ms "
                f"({2 * rows * n * 16 / tk / 1e6:.0f} GB/s, {b_ms / tk:.1%} "
                f"of the bound {b_ms:.3f} ms), plain x @ W {tp:.3f} ms, "
                f"cuFFT {t_cufft:.3f} ms; back to back between CUDA events "
                f"kernel {event_ms(lambda: dft64.dft_last(x)):.3f} ms, cuFFT "
                f"{event_ms(lambda: torch.fft.fft(x)):.3f} ms [{card}]")
        else:
            tk = wall_ms(lambda: dft64.fft_last(x))
            log(f"phase 9: K4 recursion ({rows}, {n}): {tk:.3f} ms, cuFFT "
                f"{t_cufft:.3f} ms [{card}]")
        del x
    result["bound_ms"], result["bound_by"] = bound(nbytes, flops, FP64_FLOP_S)
    return result


def hp_oracle(v, dx):
    """bench.py:536-550: the hp PSD's numpy float64 closed form (linear
    detrend, hann window, density) of one square field."""
    n = v.shape[0]
    i = np.arange(n) - (n - 1) / 2
    s2 = (i ** 2).sum()
    vm = v - v.mean()
    ay = (vm * i[:, None]).sum() / (s2 * n)
    ax = (vm * i[None, :]).sum() / (s2 * n)
    vd = vm - ay * i[:, None] - ax * i[None, :]
    w = sps.windows.hann(n, sym=False)
    F = np.fft.fftshift(np.fft.fftn(vd * np.outer(w, w))) * dx * dx
    return np.abs(F) ** 2 * (1.0 / (n * dx)) ** 2


def hp_phase(xt, kernels, card):
    """The float64 precision path at full width under both fft_impl
    values, config 2 against numpy, the hp roundtrips, the hp fft at 2048^2
    and the isotropic hp spectrum; returns K4's launches on the hp path."""
    from xrft_tpu_torch.config import fft_impl

    dft64, binning = kernels["dft64"], kernels["binned_sum"]
    da = labeled(xt, field(MAIN_SHAPE, 0))
    with fft_impl("torch"):
        ref = xt.power_spectrum(da, **HP_KW)
    for k in kernels.values():
        k.launches = 0
    with fft_impl("kernel"):
        ps = xt.power_spectrum(da, **HP_KW)
    torch.cuda.synchronize()
    launches = {name: k.launches for name, k in kernels.items()}
    log(f"phase 10: hp path {MAIN_SHAPE} under fft_impl='kernel': kernel "
        f"launches {launches}")
    check(launches["dft64"] > 0,
          f"K4 was not launched on the hp path: {launches}")
    for impl, p in (("kernel", ps), ("torch", ref)):
        check(p.dims == ("time", "freq_y", "freq_x") and p.shape == MAIN_SHAPE
              and p.dtype == torch.float64, f"hp {impl}: unexpected {p!r}")
        check(bool(torch.isfinite(p.data).all()), f"hp {impl}: non-finite")
    err = rel_err(ps.data, ref.data)
    check(err <= 1e-12, f"hp path: K4 vs cuFFT rel err {err:.3e} > 1e-12")
    ps32 = xt.power_spectrum(da, **MAIN_KW)
    err32 = rel_err(ps32.data, ref.data)
    check(err32 <= 1e-5, f"float32 PSD vs hp PSD rel err {err32:.3e}")
    log(f"phase 10: hp PSD, fft_impl='kernel' vs 'torch' (cuFFT complex128) "
        f"rel err {err:.3e} (limit 1e-12); the float32 PSD against it "
        f"{err32:.3e} (limit 1e-5)")
    del ps, ps32

    # the isotropic hp spectrum: K3 in float64, conserving the hp total
    before = binning.launches
    iso = xt.isotropic_power_spectrum(da, **dict(ISO_KW, engine="hp"))
    torch.cuda.synchronize()
    nbins = MAIN_SHAPE[-1] // 4
    check(binning.launches > before and iso.dtype == torch.float64
          and iso.shape == (MAIN_SHAPE[0], nbins),
          f"isotropic hp: {binning.launches - before} K3 launches, {iso!r}")
    tot = ref.data.sum(dim=(1, 2))
    cons = ((iso.data.sum(dim=1) - tot).abs() / tot).max().item()
    check(cons <= 1e-12, f"isotropic hp conservation rel err {cons:.3e}")
    log(f"phase 10: isotropic hp {MAIN_SHAPE}, {nbins} bins: K3 ran in "
        f"float64; sum(iso) vs sum(hp PSD) rel err {cons:.3e} (limit 1e-12)")
    del iso, ref

    # config 2's hp shape against the numpy float64 closed form
    n2 = CONFIG2_N
    d2 = xt.LabeledArray(field((n2, n2), 12), dims=("y", "x"),
                         coords={"y": np.arange(n2) * 0.5,
                                 "x": np.arange(n2) * 0.5})
    oracle = hp_oracle(d2.values.astype(np.float64), 0.5)
    n1 = 512
    t1 = np.arange(n1) * 0.25
    d1 = xt.LabeledArray(field((n1,), 14), dims=("t",), coords={"t": t1})
    sig = d1.values.astype(np.float64)
    for impl in ("torch", "kernel"):
        with fft_impl(impl):
            ps2 = xt.power_spectrum(d2, **HP_KW)
            ft = xt.fft(d1, dim=["t"], engine="hp")
            back = xt.ifft(ft, dim=["freq_t"], engine="hp",
                           lag=[float(t1[n1 // 2])])
            back64 = xt.ifft64(xt.fft64(d1, dim="t"), dim="freq_t",
                               lag=float(t1[n1 // 2]))
        e2 = float(np.abs(ps2.values - oracle).max() / oracle.max())
        e_rt = float(np.abs(back.values.real - sig).max())
        e_64 = float(np.abs(back64.values.real - sig).max())
        check(e2 <= 1e-10 and e_rt <= 1e-12 and e_64 <= 1e-12,
              f"{impl}: config 2 hp rel err {e2:.3e} (limit 1e-10), "
              f"roundtrips {e_rt:.3e} / {e_64:.3e} (limit 1e-12)")
        log(f"phase 10: fft_impl={impl!r}: config 2 hp PSD ({n2}^2) vs numpy "
            f"float64 rel err {e2:.3e} (limit 1e-10); hp fft/ifft roundtrip "
            f"({n1} points) max abs err {e_rt:.3e}, fft64/ifft64 {e_64:.3e} "
            f"(limit 1e-12)")

    # the hp fft at 2048^2, both routes, then the A/B times
    n7 = HP_FFT_N
    d7 = xt.LabeledArray(field((n7, n7), 15), dims=("y", "x"),
                         coords={"y": np.arange(n7) * 1.0,
                                 "x": np.arange(n7) * 1.0})
    kw7 = dict(dim=["y", "x"], engine="hp", true_phase=False,
               true_amplitude=False)

    def run(impl, fn, *args, **kw):
        def go():
            with fft_impl(impl):
                return fn(*args, **kw)
        return go

    e7 = rel_err(run("kernel", xt.fft, d7, **kw7)().data,
                 run("torch", xt.fft, d7, **kw7)().data)
    check(e7 <= 1e-12, f"hp fft {n7}^2: K4 vs cuFFT rel err {e7:.3e}")
    tt, tk = ab_ms(run("torch", xt.fft, d7, **kw7),
                   run("kernel", xt.fft, d7, **kw7))
    log(f"phase 10: hp fft {n7}^2: K4 vs cuFFT rel err {e7:.3e} (limit "
        f"1e-12); fft_impl='torch' {tt:.3f} ms, 'kernel' {tk:.3f} ms [{card}]")
    t2t, t2k = ab_ms(run("torch", xt.power_spectrum, d2, **HP_KW),
                     run("kernel", xt.power_spectrum, d2, **HP_KW))
    log(f"phase 10: config 2 hp PSD {n2}^2: fft_impl='torch' {t2t:.3f} ms, "
        f"'kernel' {t2k:.3f} ms [{card}]")
    tt, tk = ab_ms(run("torch", xt.power_spectrum, da, **HP_KW),
                   run("kernel", xt.power_spectrum, da, **HP_KW))
    t_iso = wall_ms(run("torch", xt.isotropic_power_spectrum, da,
                        **dict(ISO_KW, engine="hp")))
    log(f"phase 10: hp PSD {MAIN_SHAPE}: fft_impl='torch' {tt:.3f} ms, "
        f"'kernel' {tk:.3f} ms; isotropic hp ('torch') {t_iso:.3f} ms "
        f"[{card}]")
    device_split(run("torch", xt.power_spectrum, da, **HP_KW),
                 "phase 10: hp PSD, 'torch'", card)
    device_split(run("kernel", xt.power_spectrum, da, **HP_KW),
                 "phase 10: hp PSD, 'kernel'", card)
    return launches["dft64"]


def inverse_spectrum():
    """The inverse flagship's input: the half spectrum of a real field (y in
    natural order), Hermitian, as the inverse assumes (cuFFT's c2r does not
    drop the imaginary parts of a half spectrum that is not, as numpy's
    irfft does)."""
    n = INV_SHAPE[1]
    return torch.fft.rfftn(field(INV_SHAPE[:2] + (n,), 13), dim=(1, 2))


def inverse_half(xt, data, order):
    """The half spectrum as the labelled input of ``ifft``, freq_y in
    natural ("natural") or fftshifted ("shifted") order: the same spectrum,
    data and freq_y shifted together."""
    n = INV_SHAPE[1]
    fy = np.fft.fftfreq(n, 0.5)
    if order == "shifted":
        data, fy = torch.fft.fftshift(data, dim=1), np.fft.fftshift(fy)
    return xt.LabeledArray(data, dims=("time", "freq_y", "freq_x"),
                           coords={"freq_y": fy,
                                   "freq_x": np.fft.rfftfreq(n, 0.5)})


def inverse_phase(xt, fft_fourstep, card):
    """The inverse flagship under cuFFT and K2 (sign +1), against the same
    call in complex128, with freq_y fftshifted and in natural order (the
    same spectrum, so the two give the same bits), then timed."""
    from xrft_tpu_torch.config import fft_impl

    n = INV_SHAPE[1]
    F = inverse_spectrum()
    half = partial(inverse_half, xt)

    with fft_impl("torch"):
        ref = xt.ifft(half(F.to(torch.complex128), "shifted"), **INV_KW)
    outs = {}
    for order in ("shifted", "natural"):
        fft_fourstep.fft_last.launches = 0
        with fft_impl("kernel"):
            outs["kernel", order] = xt.ifft(half(F, order), **INV_KW)
        torch.cuda.synchronize()
        k2 = fft_fourstep.fft_last.launches
        check(k2 > 0, f"K2 was not launched on the inverse path ({order})")
        with fft_impl("torch"):
            outs["torch", order] = xt.ifft(half(F, order), **INV_KW)
        for impl in ("torch", "kernel"):
            out = outs[impl, order]
            check(out.dims == ("time", "y", "x")
                  and out.shape == INV_SHAPE[:2] + (n,)
                  and out.dtype == torch.float32,
                  f"inverse {impl} {order}: unexpected output {out!r}")
            err = rel_err(out.data, ref.data)
            check(err <= 1e-5, f"inverse {impl} {order}: rel err {err:.3e}")
            log(f"phase 11: inverse flagship {INV_SHAPE}->{n}, freq_y "
                f"{order}, fft_impl={impl!r}: rel err vs complex128 "
                f"{err:.3e} (limit 1e-5)" + (f"; K2 launches {k2}"
                                              if impl == "kernel" else ""))
    for impl in ("torch", "kernel"):
        check(torch.equal(outs[impl, "shifted"].data,
                          outs[impl, "natural"].data),
              f"inverse {impl}: natural order differs from shifted")
    del outs, ref

    def run(impl, order):
        daft = half(F, order)

        def go():
            with fft_impl(impl):
                xt.ifft(daft, **INV_KW)
        return go

    for order in ("shifted", "natural"):
        tt, tk = ab_ms(run("torch", order), run("kernel", order))
        log(f"phase 11: inverse flagship, freq_y {order}: fft_impl='torch' "
            f"{tt:.3f} ms, 'kernel' {tk:.3f} ms [{card}]")
    for impl in ("torch", "kernel"):
        device_split(run(impl, "shifted"),
                     f"phase 11: inverse flagship, {impl!r}", card)


def k5_phase(dot, card):
    """K5a and K5c (both 3xTF32 on the tensor cores; K5c with W resident
    and X by TMA) each against their plain version at the flagship's
    level-0 operand and at the packed A/B shape, repeats bit for bit, K5b at
    the packed shape; then each timed against its plain version and
    torch.matmul, in A/B loops and back to back between CUDA events.
    Returns the kernels' entries."""
    w = field((64, 32), 21)
    wp = dot.pack_block_diag(w, 4)                       # (256, 128)
    cases = {"engine": (w, field(K5_ENGINE, 22)),
             "packed": (wp, field((128, K5_PACKED_N), 23))}
    out = {}
    for name, (wm, xm) in cases.items():
        tmap = dot.dma_tensor_map(xm)
        check(tmap is not None, f"K5c {name}: no TMA tensor map for X")
        m, k = wm.shape
        producer = (f"TMA, {tmap['rank']}-D map, box {tmap['box']}, "
                    f"W in groups of {-(-m // 64)} CTAs")
        got = dot.dot(wm, xm)
        again = dot.dot(wm, xm)
        dma = dot.dot_dma(wm, xm)
        dma_again = dot.dot_dma(wm, xm)
        plain = dot.dot_plain(wm, xm)
        torch.cuda.synchronize()
        err = rel_err(got, plain)
        check(err <= 1e-6, f"K5a {name}: rel err {err:.3e} vs plain > 1e-6")
        check(torch.equal(got, again), f"K5a {name}: two launches differ")
        err_c = rel_err(dma, plain)
        check(err_c <= 1e-6 and torch.equal(dma, dma_again),
              f"K5c {name}: rel err {err_c:.3e} vs plain (limit 1e-6), "
              f"repeats equal {torch.equal(dma, dma_again)}")
        max_abs = (got - plain).abs().max().item()
        max_abs_c = (dma - plain).abs().max().item()
        ac = (got - dma).abs().max().item()
        ncols = got.shape[1]
        del got, again, dma, dma_again, plain
        tp, tk = ab_ms(lambda: dot.dot_plain(wm, xm),
                       lambda: dot.dot(wm, xm))
        ta, tc = ab_ms(lambda: dot.dot(wm, xm), lambda: dot.dot_dma(wm, xm))
        t_lib = wall_ms(lambda: torch.matmul(wm, xm))
        ev_k = event_ms(lambda: dot.dot(wm, xm))
        ev_c = event_ms(lambda: dot.dot_dma(wm, xm))
        ev_lib = event_ms(lambda: torch.matmul(wm, xm))
        nbytes = (k + m) * ncols * 4 + m * k * 4
        flops = 2.0 * m * k * ncols
        # K5a and K5c: three TF32 products on the tensor cores
        b_ms, b_by = bound(nbytes, 3 * flops, TF32_FLOP_S)
        log(f"phase 12: K5a/K5c {name} ({m},{k})@({k},{ncols}): rel err vs "
            f"plain K5a {err:.3e}, K5c {err_c:.3e} (limit 1e-6), K5a vs K5c "
            f"max abs {ac:.3e}, repeats bit-identical; K5c's X producer: "
            f"{producer}; {b_by} bound {b_ms:.3f} ms (3xTF32 at 495 TFLOP/s "
            f"against {nbytes / 1e9:.3f} GB at 3.35 TB/s); A/B loop K5a "
            f"{tk:.3f} ms (plain {tp:.3f}), K5c {tc:.3f} ms (K5a beside it "
            f"{ta:.3f}), torch.matmul {t_lib:.3f} ms; back to back between "
            f"CUDA events K5a {ev_k:.3f} ms, K5c {ev_c:.3f} ms "
            f"({b_ms / ev_c:.1%} of the bound), torch.matmul {ev_lib:.3f} ms; "
            f"K5c faster than torch.matmul: {ev_c < ev_lib} [{card}]")
        out[name] = dict(max_abs_err=max_abs, ms=tk, plain_ms=tp,
                         library_ms=t_lib, bound_ms=b_ms, bound_by=b_by,
                         dma_ms=tc, dma_max_abs_err=max_abs_c,
                         dma_event_ms=ev_c, dma_producer=producer,
                         event_ms=ev_k, library_event_ms=ev_lib)
    wm, xm = cases["packed"]
    got = dot.dot_fold(wm, xm)
    plain = dot.dot_fold_plain(wm, xm)
    torch.cuda.synchronize()
    err = rel_err(got, plain)
    check(err <= 1e-6, f"K5b: rel err {err:.3e} vs plain > 1e-6")
    max_abs = (got - plain).abs().max().item()
    del got, plain
    tp, tk = ab_ms(lambda: dot.dot_fold_plain(wm, xm),
                   lambda: dot.dot_fold(wm, xm))
    # the library's product of the whole (256, 128) weight, then the fold:
    # the same function and operations that the bound counts
    def lib():
        y = torch.matmul(wm, xm)
        return y[:128] + 1e-38 * y[128:]
    t_lib = wall_ms(lib)
    nbytes = 2 * 128 * K5_PACKED_N * 4 + wm.numel() * 4
    b_ms, b_by = bound(nbytes, 2.0 * 256 * 128 * K5_PACKED_N)
    log(f"phase 12: K5b (256,128)@(128,{K5_PACKED_N}) folded to 128 rows: "
        f"rel err vs plain {err:.3e} (limit 1e-6); kernel {tk:.3f} ms "
        f"({b_ms / tk:.1%} of the {b_by} bound {b_ms:.3f} ms), plain "
        f"{tp:.3f} ms, torch.matmul then the fold {t_lib:.3f} ms [{card}]")
    out["fold"] = dict(max_abs_err=max_abs, ms=tk, plain_ms=tp,
                       library_ms=t_lib, bound_ms=b_ms, bound_by=b_by)
    return out


def plain64(xt, fn, *das, **kw):
    """fn on float64 copies of the inputs through cuFFT and the plain
    routes: the reference the float32 paths are held to."""
    from xrft_tpu_torch.config import fft_impl, psd_mirror_impl

    with fft_impl("torch"), psd_mirror_impl("plain"):
        return fn(*[d.copy(data=d.data.double()) for d in das], **kw)


def matmul_phase(xt, kernels, card):
    """The flagship PSD under fft_impl="matmul", level-0 unpacked and
    packed, against the float64 pipeline; K5a must launch once per call.
    Returns every kernel's launches on the unpacked run."""
    from xrft_tpu_torch.config import fft_impl, level0_impl

    da = labeled(xt, field(MAIN_SHAPE, 0))
    ref = plain64(xt, xt.power_spectrum, da, **MAIN_KW)
    launches = {}
    for impl in ("unpacked", "packed"):
        for k in kernels.values():
            k.launches = 0
        with fft_impl("matmul"), level0_impl(impl):
            ps = xt.power_spectrum(da, **MAIN_KW)
        torch.cuda.synchronize()
        launches[impl] = {n: k.launches for n, k in kernels.items()}
        log(f"phase 13: matmul route {MAIN_SHAPE}, level0_impl={impl!r}: "
            f"kernel launches {launches[impl]}")
        check(launches[impl]["dot"] == 1,
              f"K5a launched {launches[impl]['dot']} times, not once")
        check(ps.dims == ("time", "freq_y", "freq_x")
              and ps.shape == MAIN_SHAPE and ps.dtype == torch.float32
              and bool(torch.isfinite(ps.data).all()),
              f"matmul {impl}: unexpected output {ps!r}")
        err = rel_err(ps.data, ref.data)
        check(err <= 1e-5, f"matmul {impl}: rel err {err:.3e} vs float64")
        log(f"phase 13: matmul route, {impl}: rel err vs float64 plain "
            f"pipeline {err:.3e} (limit 1e-5)")
        del ps
    del ref

    def run(impl, level0="unpacked"):
        def go():
            with fft_impl(impl), level0_impl(level0):
                xt.power_spectrum(da, **MAIN_KW)
        return go

    tt, tm = ab_ms(run("torch"), run("matmul"), rounds=3)
    tpk = wall_ms(run("matmul", "packed"), runs=3)
    log(f"phase 13: flagship PSD {MAIN_SHAPE}: fft_impl='torch' {tt:.3f} ms, "
        f"'matmul' unpacked {tm:.3f} ms, packed {tpk:.3f} ms [{card}]")
    device_split(run("matmul"), "phase 13: matmul route, unpacked", card)
    device_split(run("matmul", "packed"), "phase 13: matmul route, packed",
                 card)
    return launches["unpacked"]


def welch_oracle(v, dx, seg):
    """The hp Welch PSD of one square field in numpy float64: hann
    segments of seg^2, no detrend, density, averaged over the segments."""
    n = v.shape[0]
    s = v.reshape(n // seg, seg, n // seg, seg).transpose(0, 2, 1, 3)
    w = sps.windows.hann(seg, sym=False)
    F = np.fft.fftshift(np.fft.fft2(s * np.outer(w, w)), axes=(-2, -1))
    F = F * dx * dx
    return (np.abs(F) ** 2 * (1.0 / (seg * dx)) ** 2).mean(axis=(0, 1))


def segments_phase(xt, k5a, card):
    """The segmented estimators at full width against float64 pipelines,
    each timed; under fft_impl="matmul" the Welch flagship must launch K5a.
    Returns K5a's launches on the Welch flagship under "matmul"."""
    from xrft_tpu_torch.config import fft_impl

    da = labeled(xt, field(MAIN_SHAPE, 0)).chunk(
        {"y": WELCH_SEG, "x": WELCH_SEG})
    k5_launches = 0
    for ov in (None, 0.5):
        kw = dict(dim=["y", "x"], window="hann", chunks_to_segments=True,
                  segment_overlap={"y": ov, "x": ov} if ov else None)
        ref = plain64(xt, xt.power_spectrum, da, **kw)
        runs = {}
        for impl in ("torch", "matmul"):
            k5a.launches = 0
            with fft_impl(impl):
                ps = xt.power_spectrum(da, **kw)
            torch.cuda.synchronize()
            n5 = k5a.launches
            if impl == "matmul":
                check(n5 > 0, "K5a was not launched on the Welch path")
                if ov is None:
                    k5_launches = n5
            check(ps.shape == ref.shape and ps.dtype == torch.float32
                  and bool(torch.isfinite(ps.data).all()),
                  f"Welch {impl} overlap {ov}: unexpected output {ps!r}")
            err = rel_err(ps.data, ref.data)
            check(err <= 1e-5, f"Welch {impl} overlap {ov}: rel err "
                               f"{err:.3e} vs float64")

            def go(impl=impl):
                with fft_impl(impl):
                    xt.power_spectrum(da, **kw)
            runs[impl] = go
            log(f"phase 14: Welch flagship {MAIN_SHAPE} in {WELCH_SEG}^2 "
                f"segments, overlap {ov}, fft_impl={impl!r}: output "
                f"{tuple(ps.shape)}, rel err vs float64 {err:.3e} (limit "
                f"1e-5), K5a launches {n5}")
            del ps
        del ref
        tt, tm = ab_ms(runs["torch"], runs["matmul"], rounds=3)
        log(f"phase 14: Welch flagship, overlap {ov}: fft_impl='torch' "
            f"{tt:.3f} ms, 'matmul' {tm:.3f} ms [{card}]")
        if ov is None:
            device_split(runs["torch"], "phase 14: Welch flagship, 'torch'",
                         card)
            device_split(runs["matmul"],
                         "phase 14: Welch flagship, 'matmul'", card)
    del da

    def series(seed):
        return xt.LabeledArray(field(SG_SHAPE, seed), dims=("z", "t"),
                               coords={"t": np.arange(SG_SHAPE[1]) * SG_DT})

    sig, sig2 = series(31), series(32)
    sg_kw = dict(dim="t", seglen=SG_SEG, window="hann")
    ref = plain64(xt, xt.spectrogram, sig, **sg_kw)
    for impl in ("torch", "matmul"):
        with fft_impl(impl):
            sg = xt.spectrogram(sig, **sg_kw)
            t_sg = wall_ms(lambda: xt.spectrogram(sig, **sg_kw), runs=3,
                           warmup=1)
        torch.cuda.synchronize()
        err = rel_err(sg.data, ref.data)
        check(sg.shape == ref.shape and err <= 1e-5,
              f"spectrogram {impl}: {tuple(sg.shape)}, rel err {err:.3e}")
        log(f"phase 14: spectrogram {SG_SHAPE}, {SG_SEG}-point hann, "
            f"fft_impl={impl!r}: output {tuple(sg.shape)}, rel err vs "
            f"float64 {err:.3e} (limit 1e-5), {t_sg:.3f} ms [{card}]")
    del sg, ref

    st_kw = dict(dim="t", seglen=SG_SEG, window="hann")
    Z = xt.stft(sig, **st_kw)
    Zref = plain64(xt, xt.stft, sig, **st_kw)
    back = xt.istft(Z)
    torch.cuda.synchronize()
    e_z = rel_err(Z.data, Zref.data)
    e_rt = rel_err(back.data, sig.data.double())
    check(back.shape == sig.shape and e_z <= 1e-5 and e_rt <= 1e-5,
          f"stft: rel err {e_z:.3e}, roundtrip {e_rt:.3e}")
    t_st = wall_ms(lambda: xt.stft(sig, **st_kw), runs=3, warmup=1)
    t_ist = wall_ms(lambda: xt.istft(Z), runs=3, warmup=1)
    log(f"phase 14: stft {SG_SHAPE} -> {tuple(Z.shape)}: rel err vs float64 "
        f"{e_z:.3e} (limit 1e-5), {t_st:.3f} ms; istft roundtrip rel err "
        f"{e_rt:.3e} (limit 1e-5), {t_ist:.3f} ms [{card}]")
    del Z, Zref, back

    c = xt.csd(sig, sig2, dim="t", seglen=SG_SEG)
    cref = plain64(xt, xt.csd, sig, sig2, dim="t", seglen=SG_SEG)
    coh_kw = dict(dim="t", real_dim="t", chunks_to_segments=True,
                  segment_overlap=0.5)
    c1, c2 = sig.chunk({"t": SG_SEG}), sig2.chunk({"t": SG_SEG})
    coh = xt.coherence(c1, c2, **coh_kw)
    coh_ref = plain64(xt, xt.coherence, c1, c2, **coh_kw)
    torch.cuda.synchronize()
    e_c = rel_err(c.data, cref.data)
    e_coh = (coh.data.double() - coh_ref.data).abs().max().item()
    check(e_c <= 1e-5 and e_coh <= 1e-5,
          f"csd rel err {e_c:.3e}, coherence abs err {e_coh:.3e}")
    t_c = wall_ms(lambda: xt.csd(sig, sig2, dim="t", seglen=SG_SEG), runs=3,
                  warmup=1)
    t_coh = wall_ms(lambda: xt.coherence(c1, c2, **coh_kw), runs=3, warmup=1)
    log(f"phase 14: csd {SG_SHAPE} x 2: rel err vs float64 {e_c:.3e} (limit "
        f"1e-5), {t_c:.3f} ms; coherence: abs err {e_coh:.3e} (limit 1e-5), "
        f"{t_coh:.3f} ms [{card}]")
    del sig, sig2, c, cref, coh, coh_ref, c1, c2

    n = HP_WELCH_N
    dh = xt.LabeledArray(field((n, n), 33), dims=("y", "x"),
                         coords={"y": np.arange(n) * 0.5,
                                 "x": np.arange(n) * 0.5}).chunk(
        {"y": HP_WELCH_SEG, "x": HP_WELCH_SEG})
    oracle = welch_oracle(dh.values.astype(np.float64), 0.5, HP_WELCH_SEG)
    hp_kw = dict(dim=["y", "x"], window="hann", chunks_to_segments=True,
                 engine="hp")
    for impl in ("torch", "matmul"):
        with fft_impl(impl):
            hp = xt.power_spectrum(dh, **hp_kw).mean(["y_segment",
                                                      "x_segment"])
            t_hp = wall_ms(lambda: xt.power_spectrum(dh, **hp_kw), runs=3,
                           warmup=1)
        e_hp = float(np.abs(hp.values - oracle).max() / oracle.max())
        check(hp.dtype == torch.float64 and e_hp <= 1e-10,
              f"hp Welch {impl}: rel err {e_hp:.3e} vs numpy float64")
        log(f"phase 14: hp Welch {n}^2 in {HP_WELCH_SEG}^2 segments, "
            f"fft_impl={impl!r}: rel err vs numpy float64 {e_hp:.3e} (limit "
            f"1e-10), {t_hp:.3f} ms [{card}]")
    return k5_launches


# every mode of pad, with numpy.pad's keywords on (z, t) and then on (y, x)
PAD_MODES = (
    ("constant", {}), ("constant", dict(constant_values=(1.0, -2.0))),
    ("edge", {}), ("wrap", {}), ("reflect", {}), ("symmetric", {}),
    ("reflect", dict(reflect_type="odd")),
    ("symmetric", dict(reflect_type="odd")),
    ("linear_ramp", {}), ("linear_ramp", dict(end_values=(0.5, -1.5))),
    ("maximum", dict(stat_length=64)), ("minimum", {}),
    ("mean", dict(stat_length=(100, 7))), ("median", dict(stat_length=33)),
)


def pad_phase(xt, card):
    """pad in every mode on the card, on the stft's 8 x 2^22 series (2048
    points a side, the stft's boundary pad) and on a 2-D field padded on
    both axes (the corners), against numpy.pad on the host: bit for bit, or
    2e-6 of max for the mean (its sum in another order)."""
    sig = xt.LabeledArray(field(SG_SHAPE, 34), dims=("z", "t"),
                          coords={"t": np.arange(SG_SHAPE[1]) * SG_DT})
    fld = xt.LabeledArray(field((257, 300), 35), dims=("y", "x"),
                          coords={"y": np.arange(257) * 0.5,
                                  "x": np.arange(300) * 0.5})
    host_sig, host_fld = sig.values, fld.values
    for mode, kw in PAD_MODES:
        for da, host, widths in ((sig, host_sig, dict(t=(2048, 2048))),
                                 (fld, host_fld, dict(y=(3, 300),
                                                      x=(70, 1)))):
            got = xt.pad(da, widths, mode=mode, **kw)
            torch.cuda.synchronize()
            check(got.data.is_cuda, f"pad {mode} {kw}: left the card")
            np_w = [widths.get(d, (0, 0)) for d in da.dims]
            want = np.pad(host, np_w, mode=mode, **kw)
            g = got.values
            err = float(np.abs(g - want).max() / np.abs(want).max())
            lim = 2e-6 if mode == "mean" else 0.0
            check(g.shape == want.shape and g.dtype == want.dtype
                  and err <= lim, f"pad {mode} {kw} {tuple(host.shape)}: "
                                  f"rel err {err:.3e} vs numpy (limit {lim})")
        t_pad = wall_ms(lambda: xt.pad(sig, dict(t=(2048, 2048)), mode=mode,
                                       **kw), runs=3, warmup=1)
        log(f"phase 15: pad {mode} {kw}: on the card, equal to numpy.pad "
            f"{'within 2e-6 of max' if mode == 'mean' else 'bit for bit'} "
            f"on {SG_SHAPE} and on (257, 300) padded on both axes; "
            f"{t_pad:.3f} ms on {SG_SHAPE} [{card}]")


# ---- phases 16-24: the scipy-namesake families --------------------------


def counted(kernels, fn):
    """fn() with every kernel's launch count set to 0 just before; returns
    its result and the counts just after."""
    for k in kernels.values():
        k.launches = 0
    out = fn()
    torch.cuda.synchronize()
    return out, {name: k.launches for name, k in kernels.items()}


def under(impl, fn, *args, **kw):
    """fn(*args, **kw) under config.fft_impl = impl."""
    from xrft_tpu_torch.config import fft_impl

    with fft_impl(impl):
        return fn(*args, **kw)


def routes(kernels, label, fn, ref, lim, phase, card, impls=("torch",
                                                               "kernel")):
    """fn() under each fft_impl in ``impls`` against the float64 ``ref``
    (rel err <= lim): under "kernel" a kernel of ``kernels`` must launch,
    under "torch" none.  Logs the errors, launches and times; returns the
    last result."""
    for impl in impls:
        out, n = counted(kernels, lambda: under(impl, fn))
        err = rel_err(out.data, ref.data)
        check(out.shape == ref.shape
              and bool(torch.isfinite(out.data).all()),
              f"{label} {impl}: unexpected output {out!r}")
        check(err <= lim, f"{label} {impl}: rel err {err:.3e} > {lim}")
        check((sum(n.values()) > 0) == (impl == "kernel"),
              f"{label} {impl}: kernel launches {n}")
        t = wall_ms(lambda: under(impl, fn), runs=3, warmup=1)
        log(f"phase {phase}: {label}, fft_impl={impl!r}: rel err vs float64 "
            f"{err:.3e} (limit {lim}), launches {n}, {t:.3f} ms [{card}]")
    return out


def host_split(fn, label, top=8):
    """The host functions that take the most of one fn() call (cProfile,
    own time, the call ended by a synchronize)."""
    import cProfile
    import io
    import pstats

    prof = cProfile.Profile()
    prof.enable()
    fn()
    torch.cuda.synchronize()
    prof.disable()
    out = io.StringIO()
    stats = pstats.Stats(prof, stream=out)
    log(f"{label}: {stats.total_tt * 1e3:.3f} ms under cProfile; by own "
        f"time:")
    for (path, line, name), row in sorted(
            stats.stats.items(), key=lambda kv: -kv[1][2])[:top]:
        log(f"    {row[2] * 1e3:8.3f} ms  {path.split('/')[-1]}:{line} "
            f"{name} ({row[1]} calls)")


def host_row(d, row=0):
    """One row of the leading axis as host float64 numpy."""
    return d.data[row].double().cpu().numpy()


def host_err(got, want) -> float:
    return float(np.abs(np.asarray(got) - want).max() / np.abs(want).max())


def trig_phase(xt, k2, k4, card):
    """Phases 16-17: dct(dct(x, "x"), "y") of the flagship (bench.py:447-455)
    and idctn back, DCT-I and DST-I along x (K2 at 8190 = 90 x 91 and 8194 =
    34 x 241), one type-IV dct along x, under cuFFT and K2, against float64
    through cuFFT; then the same dctn in float64 under cuFFT and the K4
    recursion against scipy.fft.dctn on the host."""
    import scipy.fft as sfft

    da = labeled(xt, field(MAIN_SHAPE, 40))
    da64 = labeled(xt, da.data.double())

    def dct2(d):
        return xt.dct(xt.dct(d, dim="x"), dim="y")

    ref = under("torch", dct2, da64)
    got = routes({"fft_fourstep": k2}, f"dct2 flagship {MAIN_SHAPE}",
                 lambda: dct2(da), ref, 1e-5, 16, card)
    for impl in ("torch", "kernel"):
        back = under(impl, xt.idctn, got, dim=["y", "x"])
        e_rt = rel_err(back.data, da64.data)
        check(e_rt <= 1e-5, f"idctn roundtrip {impl}: rel err {e_rt:.3e}")
        log(f"phase 16: idctn roundtrip, fft_impl={impl!r}: rel err "
            f"{e_rt:.3e} (limit 1e-5)")
    del got, back, ref
    device_split(lambda: under("kernel", dct2, da), "phase 16: dct2 "
                 "flagship, 'kernel'", card)
    for fn, kind in ((xt.dct, "DCT-I"), (xt.dst, "DST-I")):
        ref = under("torch", fn, da64, dim="x", type=1)
        routes({"fft_fourstep": k2}, f"{kind} along x",
               lambda: fn(da, dim="x", type=1), ref, 1e-5, 16, card)
        del ref
    ref = xt.dct(da64, dim="x", type=4)
    t0 = time.perf_counter()
    got = xt.dct(da, dim="x", type=4)
    torch.cuda.synchronize()
    t_first = (time.perf_counter() - t0) * 1e3
    t4 = wall_ms(lambda: xt.dct(da, dim="x", type=4), runs=3, warmup=0)
    e4 = rel_err(got.data, ref.data)
    check(e4 <= 1e-5, f"DCT-IV: rel err {e4:.3e}")
    log(f"phase 16: DCT-IV along x (a 4096 x 4096 product in full float32): "
        f"rel err vs float64 {e4:.3e} (limit 1e-5), {t4:.3f} ms "
        f"({t_first:.3f} ms the first call, which builds the matrix) "
        f"[{card}]")
    del got, ref, da

    # phase 17: the float64 dctn, cuFFT against the K4 recursion and scipy
    hp = {}
    for impl in ("torch", "kernel"):
        hp[impl], n = counted({"dft64": k4}, lambda: under(
            impl, xt.dctn, da64, dim=["y", "x"]))
        check((n["dft64"] > 0) == (impl == "kernel"),
              f"hp dctn {impl}: K4 launches {n}")
        t = wall_ms(lambda: under(impl, xt.dctn, da64, dim=["y", "x"]),
                    runs=3, warmup=1)
        errs = [host_err(host_row(hp[impl], b),
                         sfft.dctn(host_row(da64, b))) for b in (0, 1)]
        check(max(errs) <= 1e-12, f"hp dctn {impl}: rel err {errs} vs scipy")
        log(f"phase 17: dctn {MAIN_SHAPE} float64, fft_impl={impl!r}: rel "
            f"err vs scipy.fft.dctn (fields 0, 1) {errs[0]:.3e}, "
            f"{errs[1]:.3e} (limit 1e-12), K4 launches {n['dft64']}, "
            f"{t:.3f} ms [{card}]")
    e = rel_err(hp["kernel"].data, hp["torch"].data)
    check(e <= 1e-12, f"hp dctn: K4 vs cuFFT rel err {e:.3e}")
    log(f"phase 17: hp dctn, K4 recursion vs cuFFT complex128: rel err "
        f"{e:.3e} (limit 1e-12)")
    device_split(lambda: under("kernel", xt.dctn, da64, dim=["y", "x"]),
                 "phase 17: hp dctn, 'kernel'", card)


def analytic_phase(xt, k2, card):
    """Phase 18: hilbert2 of the flagship, hilbert and envelope along x
    (n = 4096) under cuFFT and K2, and hilbert along t of the 8 x 2^22
    spectrogram signal under cuFFT, each against float64 through cuFFT;
    "kernel" must raise on the 2^22 rows (K2's lengths end at 65536)."""
    da = labeled(xt, field(MAIN_SHAPE, 41))
    da64 = labeled(xt, da.data.double())
    for fn, kw, label in ((xt.hilbert2, dict(dim=["y", "x"]), "hilbert2"),
                          (xt.hilbert, dict(dim="x"), "hilbert along x"),
                          (xt.envelope, dict(dim="x"), "envelope along x")):
        ref = under("torch", fn, da64, **kw)
        routes({"fft_fourstep": k2}, f"{label} {MAIN_SHAPE}",
               lambda: fn(da, **kw), ref, 1e-5, 18, card)
        del ref
    device_split(lambda: under("kernel", xt.hilbert2, da, dim=["y", "x"]),
                 "phase 18: hilbert2 flagship, 'kernel'", card)
    del da, da64
    sig = xt.LabeledArray(field(SG_SHAPE, 42), dims=("z", "t"),
                          coords={"t": np.arange(SG_SHAPE[1]) * SG_DT})
    ref = xt.hilbert(sig.copy(data=sig.data.double()), dim="t")
    routes({"fft_fourstep": k2}, f"hilbert along t {SG_SHAPE}",
           lambda: xt.hilbert(sig, dim="t"), ref, 1e-5, 18, card,
           impls=("torch",))
    try:
        under("kernel", xt.hilbert, sig, dim="t")
        raise AssertionError("hilbert of 2^22 rows under 'kernel' did not "
                             "raise")
    except ValueError as e:
        check("four-step kernel" in str(e), f"unexpected error: {e}")
        log(f"phase 18: hilbert along t {SG_SHAPE} under 'kernel' raises, "
            f"as it must: {e}")


def convolve_phase(xt, k2, card):
    """Phase 19: fftconvolve of a 4096^2 field with a 63^2 kernel,
    mode="same" (bench.py:457-474), under cuFFT and K2 (8192-point
    transforms), against float64 through cuFFT; convolve(method="direct")
    on the same operands (one cuDNN convolution at full float32 grade,
    bench.py:476-487) against the same reference; the TF32 default shown
    beside it; then the direct/fft crossover for square kernels from 3^2 to
    127^2 on the same field."""
    import torch.nn.functional as F

    from xrft_tpu_torch.config import config

    def field2(shape, seed):
        return xt.LabeledArray(field(shape, seed), dims=("y", "x"),
                               coords={"y": np.arange(shape[0]) * 1.0,
                                       "x": np.arange(shape[1]) * 1.0})

    n = CONV_N
    da = field2((n, n), 43)
    kern = field2((CONV_K, CONV_K), 44)
    ref = xt.fftconvolve(da.copy(data=da.data.double()),
                         kern.copy(data=kern.data.double()), mode="same")
    routes({"fft_fourstep": k2}, f"fftconvolve {n}^2 * {CONV_K}^2 same",
           lambda: xt.fftconvolve(da, kern, mode="same"), ref, 1e-5, 19,
           card)
    direct = xt.convolve(da, kern, mode="same", method="direct")
    fft32 = xt.fftconvolve(da, kern, mode="same")
    torch.cuda.synchronize()
    e_d = rel_err(direct.data, ref.data)
    e_df = rel_err(direct.data, fft32.data.double())
    check(direct.dtype == torch.float32 and e_d <= 1e-5 and e_df <= 1e-5,
          f"direct convolution: rel err {e_d:.3e} vs float64, {e_df:.3e} "
          f"vs the float32 fft route (TF32?)")
    check(np.array_equal(direct.coords["x"].values, ref.coords["x"].values),
          "direct convolution: support grid differs from the fft route's")
    t_direct = event_ms(lambda: xt.convolve(da, kern, mode="same",
                                            method="direct"),
                        runs=3, warmup=1, batch=1)
    # the trap: the same correlation through cuDNN at its TF32 default
    conv = torch.backends.cudnn.conv
    saved, conv.fp32_precision = conv.fp32_precision, "tf32"
    try:
        lo, hi = CONV_K // 2, (CONV_K - 1) // 2
        padded = F.pad(da.data, [lo, hi, lo, hi])[None, None]
        flipped = kern.data.flip((0, 1))[None, None]
        tf32 = F.conv2d(padded, flipped)[0, 0]
        t_tf32 = event_ms(lambda: F.conv2d(padded, flipped), runs=1,
                          warmup=0, batch=1)
    finally:
        conv.fp32_precision = saved
    e_tf32 = rel_err(tf32, ref.data)
    log(f"phase 19: convolve(method='direct') {n}^2 * {CONV_K}^2: rel err "
        f"vs float64 {e_d:.3e}, vs the float32 fft route {e_df:.3e} (limit "
        f"1e-5), {t_direct:.3f} ms between CUDA events; the same "
        f"convolution at cuDNN's TF32 default: rel err {e_tf32:.3e}, "
        f"{t_tf32:.3f} ms [{card}]")
    del tf32, direct, fft32, ref, padded
    device_split(lambda: xt.convolve(da, kern, mode="same", method="direct"),
                 "phase 19: direct convolution", card)
    device_split(lambda: under("kernel", xt.fftconvolve, da, kern,
                               mode="same"),
                 "phase 19: fftconvolve, 'kernel'", card)

    rows, crossover = [], 0
    for k in CROSSOVER_KS:
        kk = field2((k, k), 45)
        t_d = wall_ms(lambda: xt.convolve(da, kk, mode="same",
                                          method="direct"), runs=3, warmup=1)
        t_f = wall_ms(lambda: xt.convolve(da, kk, mode="same",
                                          method="fft"), runs=3, warmup=1)
        e = rel_err(xt.convolve(da, kk, mode="same", method="direct").data,
                    xt.fftconvolve(da.copy(data=da.data.double()),
                                   kk.copy(data=kk.data.double()),
                                   mode="same").data)
        check(e <= 1e-5, f"direct {k}^2: rel err {e:.3e} vs float64")
        if t_d < t_f and crossover == (rows[-1][0] ** 2 if rows else 0):
            crossover = k * k
        rows.append((k, t_d, t_f, e))
    log(f"phase 19: direct vs fft ('torch') on {n}^2, mode='same' "
        f"[{card}]:")
    for k, t_d, t_f, e in rows:
        log(f"    {k:4d}^2 = {k * k:6d} elements: direct {t_d:8.3f} ms, fft "
            f"{t_f:8.3f} ms, direct rel err vs float64 {e:.3e}")
    log(f"phase 19: measured direct_conv_max {crossover} (the largest "
        f"kernel of the run of sizes from 3^2 up where direct is faster); "
        f"config.direct_conv_max = {config.direct_conv_max}")
    pick = xt.choose_conv_method(da, kern, mode="same", measure=True)
    log(f"phase 19: choose_conv_method(measure=True) for {CONV_K}^2: {pick}")


def filter_phase(xt, k2, card):
    """Phase 20: on the 8 x 2^22 float32 signal, oaconvolve with a 255-tap
    firwin (cuFFT, and K2 in blocks of nfft = 2048), resample_poly(up=3,
    down=2), decimate(q=4), savgol_filter(101, 3) and upfirdn(up=2,
    down=3), each against float64 through cuFFT on the card and against
    scipy.signal on the host for one row."""
    sig = xt.LabeledArray(field(SG_SHAPE, 46), dims=("z", "t"),
                          coords={"t": np.arange(SG_SHAPE[1]) * SG_DT})
    sig64 = sig.copy(data=sig.data.double())
    h = xt.firwin(FIR_TAPS, 0.1)
    taps = xt.LabeledArray(torch.as_tensor(h, dtype=torch.float32,
                                           device=DEV), dims=("t",))
    row = host_row(sig64)
    cases = (
        ("oaconvolve", lambda s, tp: xt.oaconvolve(s, tp, dims="t",
                                                   mode="same"),
         lambda: sps.oaconvolve(row, h, mode="same"), ("torch", "kernel")),
        ("resample_poly(3, 2)", lambda s, tp: xt.resample_poly(s, 3, 2),
         lambda: sps.resample_poly(row, 3, 2), ("torch",)),
        ("decimate(4)", lambda s, tp: xt.decimate(s, 4),
         lambda: sps.decimate(row, 4, ftype="fir"), ("torch",)),
        ("savgol_filter(101, 3)", lambda s, tp: xt.savgol_filter(s, 101, 3),
         lambda: sps.savgol_filter(row, 101, 3), ("torch",)),
        ("upfirdn(2, 3)", lambda s, tp: xt.upfirdn(h, s, 2, 3),
         lambda: sps.upfirdn(h, row, 2, 3), ("torch",)),
    )
    for label, fn, scipy_fn, impls in cases:
        ref = fn(sig64, taps.copy(data=taps.data.double()))
        got = routes({"fft_fourstep": k2}, f"{label} {SG_SHAPE}",
                     lambda: fn(sig, taps), ref, 1e-5, 20, card, impls)
        e = host_err(host_row(got), scipy_fn())
        check(e <= 1e-5, f"{label}: rel err {e:.3e} vs scipy.signal")
        log(f"phase 20: {label}: row 0 against scipy.signal on the host: "
            f"rel err {e:.3e} (limit 1e-5)")
        del ref, got
    device_split(lambda: xt.resample_poly(sig, 3, 2),
                 "phase 20: resample_poly(3, 2), 'torch'", card)
    host_split(lambda: xt.resample_poly(sig, 3, 2),
               "phase 20: resample_poly(3, 2), host")
    device_split(lambda: under("kernel", xt.oaconvolve, sig, taps, dims="t",
                               mode="same"),
                 "phase 20: oaconvolve, 'kernel'", card)


def czt_phase(xt, k2, card):
    """Phase 21: zoom_fft (band [0.1, 0.6] of fs = 2) and czt along x of
    the flagship (n = m = 4096, chirp length 8192) under cuFFT and K2,
    against float64 through cuFFT and, for one row, scipy.signal."""
    da = labeled(xt, field(MAIN_SHAPE, 47))
    da64 = labeled(xt, da.data.double())
    row = da64.data[0, 0].cpu().numpy()
    for label, fn, scipy_fn in (
            ("zoom_fft [0.1, 0.6]",
             lambda d: xt.zoom_fft(d, [0.1, 0.6], dim="x"),
             lambda: sps.zoom_fft(row, [0.1, 0.6], fs=2.0)),
            ("czt", lambda d: xt.czt(d, dim="x"), lambda: sps.czt(row))):
        ref = fn(da64)
        got = routes({"fft_fourstep": k2}, f"{label} along x {MAIN_SHAPE}",
                     lambda: fn(da), ref, 1e-5, 21, card)
        e = host_err(got.data[0, 0].cpu().numpy(), scipy_fn())
        check(e <= 1e-5, f"{label}: rel err {e:.3e} vs scipy.signal")
        log(f"phase 21: {label}: row (0, 0) against scipy.signal: rel err "
            f"{e:.3e} (limit 1e-5)")
        del ref, got
    device_split(lambda: under("kernel", xt.zoom_fft, da, [0.1, 0.6],
                               dim="x"),
                 "phase 21: zoom_fft flagship, 'kernel'", card)


def fht_phase(xt, k4, card):
    """Phase 22: fht and ifht of 4096 log-spaced float64 profiles of 4096
    points (mu = 0, the low-ringing offset) under cuFFT and the K4
    recursion, against scipy.fft.fht on the host for two rows, and the
    round trip.  dln is passed as scipy gets it: the one derived from the
    coordinate differs in its last bits, which the kernel's phase
    2 y (ln 2 - offset) carries to about 1e-11 of the result."""
    import scipy.fft as sfft

    r = np.logspace(-4.0, 2.0, FHT_SHAPE[1])
    dln = float(np.log(r[1] / r[0]))
    offset = xt.fhtoffset(dln, 0.0)
    env = torch.as_tensor(np.exp(-(np.log(r) / 3.0) ** 2), device=DEV)
    prof = xt.LabeledArray(field(FHT_SHAPE, 48, torch.float64) * env,
                           dims=("z", "r"), coords={"r": r})
    a = prof.values
    out = {}
    for impl in ("torch", "kernel"):
        A, n = counted({"dft64": k4}, lambda: under(
            impl, xt.fht, prof, dln=dln, mu=0.0, offset=offset, dim="r"))
        back = under(impl, xt.ifht, A, dln=dln, mu=0.0, offset=offset,
                     dim="freq_r")
        torch.cuda.synchronize()
        check((n["dft64"] > 0) == (impl == "kernel"),
              f"fht {impl}: K4 launches {n}")
        errs = [host_err(host_row(A, b),
                         sfft.fht(a[b], dln, mu=0.0, offset=offset))
                for b in (0, 1)]
        e_rt = rel_err(back.data, prof.data)
        check(max(errs) <= 1e-12 and e_rt <= 1e-12,
              f"fht {impl}: rel err {errs} vs scipy, roundtrip {e_rt:.3e}")
        t = wall_ms(lambda: under(impl, xt.fht, prof, dln=dln, mu=0.0,
                                  offset=offset, dim="r"), runs=3, warmup=1)
        log(f"phase 22: fht {FHT_SHAPE} float64, fft_impl={impl!r}: rel err "
            f"vs scipy.fft.fht (rows 0, 1) {errs[0]:.3e}, {errs[1]:.3e} "
            f"(limit 1e-12), ifht roundtrip {e_rt:.3e} (limit 1e-12), K4 "
            f"launches {n['dft64']}, {t:.3f} ms [{card}]")
        out[impl] = A
    e = rel_err(out["kernel"].data, out["torch"].data)
    check(e <= 1e-12, f"fht: K4 vs cuFFT rel err {e:.3e}")
    device_split(lambda: under("kernel", xt.fht, prof, dln=dln, mu=0.0,
                               offset=offset, dim="r"),
                 "phase 22: fht, 'kernel'", card)


def resample_phase(xt, k2, card):
    """Phase 23: resample of the flagship along x, 4096 -> 3000 (K2 runs
    3000 = 12 x 250), under cuFFT and K2, and of the 8 x 2^22 signal to
    2^21 under cuFFT, against float64 through cuFFT."""
    da = labeled(xt, field(MAIN_SHAPE, 49))
    ref = xt.resample(labeled(xt, da.data.double()), RESAMPLE_NUM, dim="x")
    routes({"fft_fourstep": k2}, f"resample {MAIN_SHAPE} -> {RESAMPLE_NUM} "
           f"along x", lambda: xt.resample(da, RESAMPLE_NUM, dim="x"), ref,
           1e-5, 23, card)
    device_split(lambda: under("kernel", xt.resample, da, RESAMPLE_NUM,
                               dim="x"),
                 "phase 23: resample flagship, 'kernel'", card)
    del da, ref
    sig = xt.LabeledArray(field(SG_SHAPE, 50), dims=("z", "t"),
                          coords={"t": np.arange(SG_SHAPE[1]) * SG_DT})
    half = SG_SHAPE[1] // 2
    ref = xt.resample(sig.copy(data=sig.data.double()), half, dim="t")
    routes({"fft_fourstep": k2}, f"resample {SG_SHAPE} -> {half} along t",
           lambda: xt.resample(sig, half, dim="t"), ref, 1e-5, 23, card,
           impls=("torch",))


def lombscargle_phase(xt, card):
    """Phase 24: lombscargle of 64 series of 65,536 irregular samples at
    16,384 frequencies, float64 and float32 (the basis built in float64 on
    the card, one product at full float32 grade); float32 against float64."""
    rng = np.random.RandomState(51)
    nb, n = LS_SHAPE
    t = np.sort(rng.uniform(0.0, float(n), n))
    t[0] = 0.0
    freqs = 2 * np.pi * np.linspace(1e-3, 0.5, LS_FREQS)
    y = field(LS_SHAPE, 52, torch.float64) + torch.cos(
        torch.as_tensor(0.7 * t, device=DEV))
    out = {}
    for dtype in (torch.float64, torch.float32):
        da = xt.LabeledArray(y.to(dtype), dims=("z", "t"), coords={"t": t})
        t0 = time.perf_counter()
        out[dtype] = xt.lombscargle(da, freqs, floating_mean=True).data
        torch.cuda.synchronize()
        first = (time.perf_counter() - t0) * 1e3
        ms = wall_ms(lambda: xt.lombscargle(da, freqs, floating_mean=True),
                     runs=2, warmup=0)
        log(f"phase 24: lombscargle {LS_SHAPE} at {LS_FREQS} frequencies, "
            f"{str(dtype).removeprefix('torch.')}: {ms:.3f} ms ({first:.3f} "
            f"first call) [{card}]")
        if dtype == torch.float32:
            device_split(lambda: xt.lombscargle(da, freqs,
                                                floating_mean=True),
                         "phase 24: lombscargle float32", card)
        del da
    e = rel_err(out[torch.float32], out[torch.float64])
    check(bool(torch.isfinite(out[torch.float32]).all()) and e <= 1e-5,
          f"lombscargle float32: rel err {e:.3e} vs float64")
    log(f"phase 24: lombscargle float32 vs float64: rel err {e:.3e} (limit "
        f"1e-5)")


# ---- phase 25: the sharded path on a one-rank NCCL group ------------------


def nccl_kernels(fn, calls=3) -> dict:
    """{kernel name: count} of the NCCL kernels that torch.profiler records
    on the card over ``calls`` calls of fn()."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    return {e.key: e.count for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA and "nccl" in e.key.lower()}


def under_config(cfg, impl, fn):
    """fn() under config.fft_impl = impl and the config values ``cfg``."""
    from xrft_tpu_torch.config import config

    saved = {k: getattr(config, k) for k in cfg}
    try:
        for k, v in cfg.items():
            setattr(config, k, v)
        return under(impl, fn)
    finally:
        for k, v in saved.items():
            setattr(config, k, v)


def sharded_phase(xt, kernels, card):
    """Phase 25: the sharded path (xrft_tpu_torch.parallel) on the card, as
    a one-rank NCCL group with a DeviceMesh {"fp": 1} over it.  The flagship
    with y sharded goes through the pencil chain (its NCCL all_to_all moves
    the sharding onto the batch axis) and the kernels run on the local
    block: the PSD under cuFFT and under K2 (with K1), the isotropic PSD in
    1024 bins (K3), the hp PSD under the K4 recursion, the Welch flagship in
    1024^2 segments and the 1-D Welch, and hilbert sharded on the batch.
    One 4096^2 field with y sharded has no batch to park the sharding on,
    so its chain takes a roundtrip step and y stays sharded: its PSD (K1 on
    the block, y's one rank holding the whole axis), the same PSD through
    the plain Hermitian expansion (whose mirror gathers along y are NCCL
    all_to_alls of the complex spectrum), and its isotropic PSD (K3 on the
    rank's stretch of the grid, then an all_reduce).  Each path is held
    against the unsharded call on the same field and timed beside it, with
    its device split; the NCCL kernels of the flagship PSD and of each 2-D
    path are counted in a profile."""
    import torch.distributed as dist
    from torch.distributed.tensor import Replicate, Shard

    from xrft_tpu_torch import parallel as par

    dist.init_process_group("nccl", store=dist.HashStore(), rank=0,
                            world_size=1, device_id=torch.device("cuda", 0))
    try:
        mesh = par.make_mesh({"fp": 1})
        shards = {"y": "fp"}
        da = labeled(xt, field(MAIN_SHAPE, 0))
        dac = da.chunk({"y": WELCH_SEG, "x": WELCH_SEG})
        ny, nx = MAIN_SHAPE[1:]
        da2 = xt.LabeledArray(field((ny, nx), 3), dims=("y", "x"),
                              coords={"y": np.arange(ny) * 0.5,
                                      "x": np.arange(nx) * 0.5})
        seg_kw = dict(dim=["y", "x"], window="hann", chunks_to_segments=True)
        seg_dims = ["y_segment", "x_segment"]
        plain_mirror = {"psd_mirror_impl": "plain"}
        s0, rep = (Shard(0),), (Replicate(),)
        paths = [
            # label, field, impl, config, unsharded, sharded, limit, kernels
            # that must run, planned placement (None: not checked)
            ("PSD", da, "torch", {}, lambda: xt.power_spectrum(da, **MAIN_KW),
             lambda: par.sharded_power_spectrum(da, mesh, shards, **MAIN_KW),
             2e-6, {"mirror_psd": 1}, s0),
            ("PSD", da, "kernel", {},
             lambda: xt.power_spectrum(da, **MAIN_KW),
             lambda: par.sharded_power_spectrum(da, mesh, shards, **MAIN_KW),
             2e-6, {"mirror_psd": 1, "fft_fourstep": 2}, s0),
            ("isotropic PSD, 1024 bins", da, "kernel", {},
             lambda: xt.isotropic_power_spectrum(da, **ISO_KW),
             lambda: par.sharded_isotropic_power_spectrum(da, mesh, shards,
                                                          **ISO_KW),
             2e-6, {"binned_sum": 1, "fft_fourstep": 2}, s0),
            ("hp PSD", da, "kernel", {},
             lambda: xt.power_spectrum(da, **HP_KW),
             lambda: par.sharded_power_spectrum(da, mesh, shards, **HP_KW),
             1e-12, {"dft64": 1}, s0),
            (f"Welch flagship, {WELCH_SEG}^2 segments", da, "torch", {},
             lambda: xt.power_spectrum(dac, **seg_kw).mean(seg_dims),
             lambda: par.sharded_power_spectrum(dac, mesh, shards,
                                                **seg_kw).mean(seg_dims),
             2e-6, {}, None),
            (f"welch along x, seglen {WELCH_SEG}", da, "kernel", {},
             lambda: xt.welch(da, dim="x", seglen=WELCH_SEG),
             lambda: par.sharded_welch(da, mesh, {"time": "fp"}, dim="x",
                                       seglen=WELCH_SEG),
             2e-6, {"fft_fourstep": 1}, None),
            ("hilbert along x, sharded on time", da, "kernel", {},
             lambda: xt.hilbert(da, dim="x"),
             lambda: par.sharded("hilbert", da, mesh=mesh,
                                 dim_shards={"time": "fp"}, dim="x"),
             2e-6, {"fft_fourstep": 2}, None),
            ("2-D PSD, roundtrip", da2, "kernel", {},
             lambda: xt.power_spectrum(da2, **MAIN_KW),
             lambda: par.sharded_power_spectrum(da2, mesh, shards,
                                                **MAIN_KW),
             2e-6, {"mirror_psd": 1, "fft_fourstep": 2}, s0),
            ("2-D PSD, roundtrip, plain mirror", da2, "kernel", plain_mirror,
             lambda: xt.power_spectrum(da2, **MAIN_KW),
             lambda: par.sharded_power_spectrum(da2, mesh, shards,
                                                **MAIN_KW),
             2e-6, {"fft_fourstep": 2}, s0),
            ("2-D isotropic PSD, roundtrip, 1024 bins", da2, "kernel", {},
             lambda: xt.isotropic_power_spectrum(da2, **ISO_KW),
             lambda: par.sharded_isotropic_power_spectrum(da2, mesh, shards,
                                                          **ISO_KW),
             2e-6, {"mirror_psd": 1, "binned_sum": 1, "fft_fourstep": 2},
             rep),
        ]
        for label, x, impl, cfg, plain, shard, lim, need, planned in paths:
            run_plain = partial(under_config, cfg, impl, plain)
            run_shard = partial(under_config, cfg, impl, shard)
            ref = run_plain()
            got, n = counted(kernels, run_shard)
            block = got.data.to_local()
            err = rel_err(block, ref.data)
            check(isinstance(got.data, torch.distributed.tensor.DTensor)
                  and got.dims == ref.dims and block.shape == ref.shape
                  and bool(torch.isfinite(block).all()),
                  f"sharded {label}: unexpected output {got!r}")
            check(err <= lim, f"sharded {label} {impl}: rel err {err:.3e} "
                              f"vs unsharded > {lim}")
            check(all(n[k] >= v for k, v in need.items()),
                  f"sharded {label} {impl}: kernel launches {n}, need {need}")
            placement = tuple(got.data.placements)
            check(planned is None or placement == planned,
                  f"sharded {label}: placement {placement}, planned "
                  f"{planned}")
            t_plain, t_shard = ab_ms(run_plain, run_shard, rounds=3)
            log(f"phase 25: sharded {label} {tuple(x.shape)}, fft_impl="
                f"{impl!r}{' ' + str(cfg) if cfg else ''}: rel err vs unsharded {err:.3e} "
                f"(limit {lim}), placement {placement}, launches {n}; "
                f"sharded {t_shard:.3f} ms, unsharded {t_plain:.3f} ms, "
                f"pencil overhead at one rank {t_shard - t_plain:+.3f} ms "
                f"[{card}]")
            device_split(run_shard, f"phase 25: sharded {label}, {impl!r}",
                         card)
            if x is da2 or label == "PSD" and impl == "kernel":
                nccl = nccl_kernels(run_shard)
                log(f"phase 25: NCCL kernels in the profile of 3 sharded "
                    f"{label} calls: {sum(nccl.values())} ({nccl}) [{card}]")
                check(sum(nccl.values()) >= 1,
                      f"the sharded {label}'s profile holds no NCCL kernel")
            del ref, got, block
    finally:
        dist.destroy_process_group()


def glorys(xt, data):
    """A (time, lat, lon) stack on GLORYS12's 1/12 degree grid: lat from
    -80 to 90, lon from -180."""
    B, nlat, nlon = data.shape
    return xt.LabeledArray(
        data, dims=("time", "lat", "lon"),
        coords={"time": np.arange(B, dtype=np.float64),
                "lat": -80.0 + np.arange(nlat) / 12.0,
                "lon": -180.0 + np.arange(nlon) / 12.0})


def pair_phase(xt, kernels, card):
    """Phase 26: the matmul engine's pair path (``ops/matmul_fft.py``) at
    full width under fft_impl="matmul": (A) the inverse flagship, whose
    irfftn the stacked engine cannot run alone; (B) the PSD and (C) the
    shifted fft of a GLORYS12 stack, whose 2041 = 13 x 157 latitudes no
    stacked plan covers; (D) DST-I along x of the flagship (8194 = 2 x 17 x
    241 points); and the istft of phase 14's stft.  Each is held against the
    same call in float64 through cuFFT, with every kernel's launches counted
    from 0 and checked against the route, timed beside "torch" and "kernel"
    and profiled.  Then K2 at the pair path's shapes against cuFFT and the
    engine's own einsum recursion (``matmul_fft._split_last``)."""
    from xrft_tpu_torch.ops import matmul_fft

    def leg(label, fn, ref, expect, lim=1e-5):
        out, n = counted(kernels, lambda: under("matmul", fn))
        want = {k: expect.get(k, 0) for k in kernels}
        check(tuple(out.shape) == tuple(ref.shape) and tuple(out.dims) ==
              tuple(ref.dims) and bool(torch.isfinite(out.data).all()),
              f"{label}: unexpected output {out!r}")
        err = rel_err(out.data, ref.data)
        check(err <= lim, f"{label}: rel err {err:.3e} > {lim}")
        check(n == want, f"{label}: launches {n}, expected {want}")
        ms = {impl: wall_ms(lambda: under(impl, fn), runs=3, warmup=1)
              for impl in ("matmul", "torch", "kernel")}
        log(f"phase 26: {label}, fft_impl='matmul': rel err vs float64 "
            f"{err:.3e} (limit {lim}), launches {n}; ms "
            + ", ".join(f"{k!r} {v:.3f}" for k, v in ms.items())
            + f" [{card}]")
        device_split(lambda: under("matmul", fn),
                     f"phase 26: {label}, 'matmul'", card)
        return out

    # (A) the inverse flagship (bench.py:337-383): the stacked inverse along
    # freq_y, then the packed half-length inverse (stacked, 2048 points)
    F = inverse_spectrum()
    ref = under("torch", xt.ifft, inverse_half(xt, F.to(torch.complex128),
                                               "shifted"), **INV_KW)
    for order in ("shifted", "natural"):
        half = inverse_half(xt, F, order)
        out = leg(f"(A) inverse flagship {INV_SHAPE}, freq_y {order}",
                  lambda: xt.ifft(half, **INV_KW), ref, {})
        e_t = rel_err(out.data, under("torch", xt.ifft, half,
                                      **INV_KW).data.double())
        check(e_t <= 1e-5, f"(A) {order}: rel err vs cuFFT {e_t:.3e}")
        log(f"phase 26: (A) freq_y {order}: rel err vs 'torch' on the same "
            f"complex64 input {e_t:.3e} (limit 1e-5)")
        del out, half
    del F, ref

    # (B) and (C): the GLORYS12 stack
    da = glorys(xt, field(GLORYS_SHAPE, 260))
    da64 = da.copy(data=da.data.double())
    ref = plain64(xt, xt.power_spectrum, da, **GLORYS_KW)
    leg(f"(B) power_spectrum {GLORYS_SHAPE} (lat, lon), hann, linear",
        lambda: xt.power_spectrum(da, **GLORYS_KW), ref,
        {"fft_fourstep": 2, "mirror_psd": 1})
    ref = under("torch", xt.fft, da64, dim=["lat", "lon"])
    leg(f"(C) fft {GLORYS_SHAPE} (lat, lon), shift and true_phase",
        lambda: xt.fft(da, dim=["lat", "lon"]), ref, {"fft_fourstep": 2})
    del da, da64, ref

    # (D) DST-I along x of the flagship field (bench.py:447-455): 8194 points
    da = labeled(xt, field(MAIN_SHAPE, 40))
    ref = under("torch", xt.dst, da.copy(data=da.data.double()), dim="x",
                type=1)
    leg(f"(D) DST-I along x of {MAIN_SHAPE} ({2 * MAIN_SHAPE[2] + 2} "
        f"points)",
        lambda: xt.dst(da, dim="x", type=1), ref, {"fft_fourstep": 1})
    del da, ref

    # the istft of phase 14's stft under "matmul"
    sig = xt.LabeledArray(field(SG_SHAPE, 31), dims=("z", "t"),
                          coords={"t": np.arange(SG_SHAPE[1]) * SG_DT})
    Z = xt.stft(sig, dim="t", seglen=SG_SEG, window="hann")
    back, n = counted(kernels, lambda: under("matmul", xt.istft, Z))
    e_rt = rel_err(back.data, sig.data.double())
    check(back.shape == sig.shape and e_rt <= 1e-5
          and not any(n.values()),
          f"istft under 'matmul': rel err {e_rt:.3e}, launches {n}")
    ms = {impl: wall_ms(lambda: under(impl, xt.istft, Z), runs=3, warmup=1)
          for impl in ("matmul", "torch")}
    log(f"phase 26: istft of the {SG_SHAPE} stft {tuple(Z.shape)} under "
        f"'matmul': roundtrip rel err {e_rt:.3e} (limit 1e-5), launches "
        f"{n}; ms " + ", ".join(f"{k!r} {v:.3f}" for k, v in ms.items())
        + f" [{card}]")
    device_split(lambda: under("matmul", xt.istft, Z),
                 "phase 26: istft, 'matmul'", card)
    del sig, Z, back

    # K2 at the pair path's shapes against cuFFT and the einsum recursion
    k2 = kernels["fft_fourstep"]
    for rows, n in PAIR_K2_SHAPES:
        x = field((rows, n), 7, torch.complex64)
        ref = torch.fft.fft(x.to(torch.complex128))
        rec, inner = counted(kernels, lambda: matmul_fft._split_last(x, n,
                                                                     -1))
        errs = [rel_err(y, ref) for y in (k2(x), torch.fft.fft(x), rec)]
        check(max(errs) <= 1e-5, f"({rows}, {n}): rel errs {errs}")
        del ref, rec
        t = [event_ms(f, runs=5) for f in (
            lambda: k2(x), lambda: torch.fft.fft(x),
            lambda: matmul_fft._split_last(x, n, -1))]
        nbytes = 2 * x.numel() * x.element_size()
        b_ms, b_by = bound(nbytes, fft_flops(rows, n))
        log(f"phase 26: K2 ({rows}, {n}) complex64 back to back: kernel "
            f"{t[0]:.3f} ms ({b_ms / t[0]:.1%} of the {b_by} bound "
            f"{b_ms:.3f} ms), cuFFT {t[1]:.3f} ms, the pair engine's einsum "
            f"recursion {t[2]:.3f} ms (K2 launches inside it: "
            f"{inner['fft_fourstep']}); rel err vs complex128: kernel "
            f"{errs[0]:.3e}, cuFFT {errs[1]:.3e}, recursion {errs[2]:.3e} "
            f"[{card}]")
        del x


# ---- phase 27: integer, float16 and complex input on the repaired routes -


REPAIR_PAD_MODES = (("maximum", {}), ("minimum", dict(stat_length=64)),
                    ("median", {}),
                    ("linear_ramp", dict(end_values=(0.5 - 2j, -1.5))))
RFFT16 = "RFFT input must be float32 or float64, got float16"
# the uint16 PSD against the float64 values: PERF.md's float32 limit (a fit
# rounded at the data's magnitude, 2048, once put 1.94e-5 of max at DC)
U16_LIMIT = 1e-5


def repair_phase(xt, kernels, card):
    """Phase 27: the dtypes the port takes as ``xrft_tpu`` takes them, at
    the flagship's full width.  uint16 counts (an imagery user's data)
    through the flagship PSD under every fft_impl, in float32 as
    ``xrft_tpu`` computes them: bit for bit the float32 pipeline on the same
    values, within U16_LIMIT of the float64 values; int32 counts on the
    float64 route, "kernel" (the K4 recursion) against "torch"; welch,
    spectrogram and periodogram of int16 series at their default constant
    detrend; pad of complex64 data in the modes that order complex values,
    against numpy.pad bit for bit; float16 data, whose real fft raises
    xrft_tpu's ValueError under every route and whose complex fft
    promotes.  Then the PSD times of the integer inputs beside
    the float32 flagship's, and the float16 namesakes
    (:func:`float16_namesakes`)."""
    g = torch.Generator(device=DEV).manual_seed(270)
    counts = torch.randint(0, 4096, MAIN_SHAPE, generator=g, device=DEV,
                           dtype=torch.int32)          # 12-bit counts
    ref = under("torch", xt.power_spectrum, labeled(xt, counts.double()),
                **MAIN_KW)

    # uint16: promoted to float32 (exactly: the counts fit its 24 bits), so
    # every route gives the float32 pipeline's result on the same values bit
    # for bit.  The detrend fits the residual of a pilot, so neither errs at
    # DC by the rounding of a fit at the counts' magnitude (mean 2048)
    u16 = labeled(xt, counts.to(torch.uint16))
    f32 = labeled(xt, counts.float())
    must = {"torch": ("mirror_psd",), "kernel": ("fft_fourstep",
                                                 "mirror_psd"),
            "matmul": ("dot",)}
    for impl, names in must.items():
        ps, n = counted(kernels, lambda: under(impl, xt.power_spectrum, u16,
                                               **MAIN_KW))
        same = under(impl, xt.power_spectrum, f32, **MAIN_KW)
        err = rel_err(ps.data, ref.data)
        worst = tuple(int(i) for i in np.unravel_index(
            int((ps.data.double() - ref.data).abs().argmax()), MAIN_SHAPE))
        check(ps.dtype == torch.float32 and ps.shape == MAIN_SHAPE
              and tuple(ps.dims) == ("time", "freq_y", "freq_x")
              and bool(torch.isfinite(ps.data).all()),
              f"uint16 PSD {impl}: unexpected output {ps!r}")
        check(torch.equal(ps.data, same.data),
              f"uint16 PSD {impl}: differs from the float32 pipeline on the "
              f"same values")
        check(err <= U16_LIMIT, f"uint16 PSD {impl}: rel err {err:.3e} vs "
              f"the float64 values > {U16_LIMIT}")
        check(all(n[k] > 0 for k in names),
              f"uint16 PSD {impl}: launches {n}, expected {names}")
        log(f"phase 27: uint16 PSD {MAIN_SHAPE}, fft_impl={impl!r}: float32, "
            f"equal bit for bit to the float32 pipeline on the same values; "
            f"rel err vs the float64 values through 'torch' {err:.3e} "
            f"(limit {U16_LIMIT}), largest at {worst} (DC is (b, 2048, "
            f"2048)); launches {n}")
        del ps, same

    # int32: promoted to float64, "kernel" (K4) against "torch"
    i32 = labeled(xt, counts)
    out = {}
    for impl, names in (("torch", ("mirror_psd",)),
                        ("kernel", ("dft64", "mirror_psd"))):
        out[impl], n = counted(kernels, lambda: under(
            impl, xt.power_spectrum, i32, **MAIN_KW))
        check(out[impl].dtype == torch.float64
              and out[impl].shape == MAIN_SHAPE,
              f"int32 PSD {impl}: unexpected output {out[impl]!r}")
        check(all(n[k] > 0 for k in names),
              f"int32 PSD {impl}: launches {n}, expected {names}")
        log(f"phase 27: int32 PSD {MAIN_SHAPE}, fft_impl={impl!r}: float64, "
            f"launches {n}")
    err = rel_err(out["kernel"].data, out["torch"].data)
    e_ref = rel_err(out["torch"].data, ref.data)
    check(err <= 1e-12 and e_ref <= 1e-12,
          f"int32 PSD: 'kernel' vs 'torch' {err:.3e}, 'torch' vs the "
          f"float64 values {e_ref:.3e} (limit 1e-12)")
    log(f"phase 27: int32 PSD: rel err 'kernel' vs 'torch' {err:.3e}, "
        f"'torch' vs the float64 values {e_ref:.3e} (limit 1e-12)")
    del out, ref

    # int16 series through the segment estimators, constant detrend
    s16 = torch.randint(-3000, 3000, SG_SHAPE, generator=g, device=DEV,
                        dtype=torch.int16)
    sig = xt.LabeledArray(s16, dims=("z", "t"),
                          coords={"t": np.arange(SG_SHAPE[1]) * SG_DT})
    sig64 = sig.copy(data=s16.double())
    for name, kw in (("welch", dict(dim="t", seglen=SG_SEG)),
                     ("spectrogram", dict(dim="t", seglen=SG_SEG)),
                     ("periodogram", dict(dim="t"))):
        fn = getattr(xt, name)
        got, want = fn(sig, **kw), fn(sig64, **kw)
        err = rel_err(got.data, want.data)
        check(got.dtype == torch.float32 and got.shape == want.shape
              and bool(torch.isfinite(got.data).all()) and err <= 1e-5,
              f"int16 {name}: {got!r}, rel err {err:.3e}")
        log(f"phase 27: {name} of int16 {SG_SHAPE}, detrend='constant': "
            f"float32 {tuple(got.shape)}, rel err vs the float64 values "
            f"{err:.3e} (limit 1e-5)")
        del got, want
    del s16, sig, sig64

    # complex pad, bit for bit against numpy.pad
    fld = labeled(xt, field(MAIN_SHAPE, 272, torch.complex64))
    host = fld.values
    widths = dict(y=(3, 5), x=(70, 1))
    for mode, kw in REPAIR_PAD_MODES:
        got = xt.pad(fld, widths, mode=mode, **kw)
        torch.cuda.synchronize()
        check(got.data.is_cuda, f"complex pad {mode}: left the card")
        want = np.pad(host, [(0, 0), widths["y"], widths["x"]], mode=mode,
                      **kw)
        g_h = got.values
        check(g_h.dtype == want.dtype and np.array_equal(g_h, want),
              f"complex pad {mode} {kw}: differs from numpy.pad")
        t_pad = wall_ms(lambda: xt.pad(fld, widths, mode=mode, **kw),
                        runs=3, warmup=1)
        log(f"phase 27: pad {mode} {kw} of complex64 {MAIN_SHAPE} on y and "
            f"x: equal to numpy.pad bit for bit; {t_pad:.3f} ms [{card}]")
        del got, g_h, want
    del fld, host

    # float16: the real transform raises, the complex one promotes
    h = labeled(xt, field(MAIN_SHAPE, 273).half())
    ref = under("torch", xt.fft, h.copy(data=h.data.double()),
                dim=["y", "x"])
    for impl in ("torch", "kernel", "matmul"):
        try:
            under(impl, xt.fft, h, dim=["y", "x"], real_dim="x")
        except ValueError as e:
            check(str(e) == RFFT16, f"float16 rfft {impl}: {e}")
        else:
            raise AssertionError(f"float16 rfft {impl}: did not raise")
        f, n = counted(kernels, lambda: under(impl, xt.fft, h,
                                              dim=["y", "x"]))
        err = rel_err(f.data, ref.data)
        check(f.dtype == torch.complex64 and err <= 1e-5
              and (impl != "kernel" or n["fft_fourstep"] > 0),
              f"float16 fft {impl}: {f.dtype}, rel err {err:.3e}, "
              f"launches {n}")
        log(f"phase 27: float16 {MAIN_SHAPE}, fft_impl={impl!r}: the real "
            f"fft raises ValueError({RFFT16!r}); the complex fft gives "
            f"complex64, rel err vs complex128 {err:.3e} (limit 1e-5), "
            f"launches {n}")
        del f
    del h, ref

    # the cost of the promotion, beside the float32 flagship
    ms = {label: wall_ms(lambda: under("torch", xt.power_spectrum, da,
                                       **MAIN_KW), runs=5)
          for label, da in (("float32", f32), ("uint16", u16),
                            ("int32", i32))}
    log(f"phase 27: flagship PSD {MAIN_SHAPE} under 'torch', ms by input "
        f"dtype: " + ", ".join(f"{k} {v:.3f}" for k, v in ms.items())
        + f" [{card}]")
    del f32, u16, i32, counts
    float16_namesakes(xt, kernels, card)


F16_LIMIT = 1e-5               # a float32 pipeline against float64
ALL_ROUTES = ("torch", "kernel", "matmul")


def float16_case(xt, kernels, card, label, fn, h, impls, raises=()):
    """``fn`` of the float16 data ``h`` under each route of ``impls``: a
    float32 (complex64) result, bit for bit ``fn`` of the float32 copy
    with the same kernel launches (and K2's under "kernel"), within
    F16_LIMIT of ``fn`` of the float64 copy through cuFFT; both calls'
    times.  Under each route of ``raises`` the float16 call raises the
    float32 call's ValueError."""
    f32 = h.copy(data=h.data.float())
    ref = under("torch", fn, h.copy(data=h.data.double()))
    expect = torch.complex64 if ref.data.is_complex() else torch.float32
    for impl in impls:
        got, n16 = counted(kernels, lambda: under(impl, fn, h))
        want, n32 = counted(kernels, lambda: under(impl, fn, f32))
        err = rel_err(got.data, ref.data)
        check(got.dtype == expect and got.shape == ref.shape
              and bool(torch.isfinite(got.data).all()),
              f"float16 {label} {impl}: unexpected output {got!r}")
        check(want.dtype == expect and torch.equal(got.data, want.data),
              f"float16 {label} {impl}: differs from the float32 call on "
              f"the same values")
        check(err <= F16_LIMIT, f"float16 {label} {impl}: rel err "
              f"{err:.3e} vs the float64 values > {F16_LIMIT}")
        check(n16 == n32 and (impl != "kernel" or n16["fft_fourstep"] > 0),
              f"float16 {label} {impl}: launches {n16}, the float32 call's "
              f"{n32}")
        del got, want
        t16 = wall_ms(lambda: under(impl, fn, h), runs=3, warmup=1)
        t32 = wall_ms(lambda: under(impl, fn, f32), runs=3, warmup=1)
        log(f"phase 27: float16 {label}, fft_impl={impl!r}: "
            f"{str(expect).removeprefix('torch.')}, equal bit for bit to the "
            f"float32 call; rel err vs the float64 values {err:.3e} (limit "
            f"{F16_LIMIT}); launches {n16} as float32's; float16 "
            f"{t16:.3f} ms, float32 {t32:.3f} ms [{card}]")
    for impl in raises:
        errs = []
        for d in (h, f32):
            try:
                under(impl, fn, d)
            except ValueError as e:
                errs.append(str(e))
            else:
                raise AssertionError(f"{label} {impl}: did not raise")
        check(errs[0] == errs[1], f"float16 {label} {impl}: {errs}")
        log(f"phase 27: float16 {label}, fft_impl={impl!r}: raises the "
            f"float32 call's ValueError({errs[0]!r})")
    del f32, ref


def float16_namesakes(xt, kernels, card):
    """Phase 27, the namesakes: float16 data compute in float32 from their
    first operation, on every route.  dct/idct along x and dctn/idctn of the
    flagship, DCT-I and DST-I along x (8190 and 8194 points, where cuFFT's
    half precision would raise), czt along x, under each fft_impl;
    resample_poly(3, 2), decimate(4) and savgol_filter(101, 3) of the 8 x
    2^22 signal under cuFFT and the matmul engines (their transforms exceed
    K2's lengths, so "kernel" raises, for float16 as for float32)."""
    h = labeled(xt, field(MAIN_SHAPE, 274).half())
    for label, fn in (
            ("dct along x", lambda d: xt.dct(d, dim="x")),
            ("idct along x", lambda d: xt.idct(d, dim="x")),
            ("dctn", lambda d: xt.dctn(d, dim=["y", "x"])),
            ("idctn", lambda d: xt.idctn(d, dim=["y", "x"])),
            ("DCT-I along x (8190 points)",
             lambda d: xt.dct(d, dim="x", type=1)),
            ("DST-I along x (8194 points)",
             lambda d: xt.dst(d, dim="x", type=1)),
            ("czt along x", lambda d: xt.czt(d, dim="x"))):
        float16_case(xt, kernels, card, f"{label} {MAIN_SHAPE}", fn, h,
                     ALL_ROUTES)
    del h
    sig = xt.LabeledArray(field(SG_SHAPE, 275).half(), dims=("z", "t"),
                          coords={"t": np.arange(SG_SHAPE[1]) * SG_DT})
    for label, fn in (
            ("resample_poly(3, 2)", lambda d: xt.resample_poly(d, 3, 2)),
            ("decimate(4)", lambda d: xt.decimate(d, 4)),
            ("savgol_filter(101, 3)",
             lambda d: xt.savgol_filter(d, 101, 3))):
        float16_case(xt, kernels, card, f"{label} {SG_SHAPE}", fn, sig,
                     ("torch", "matmul"), raises=("kernel",))



# ---- phase 28: fields far from zero mean ---------------------------------
# (label, mean, spread) of the flagship's fields: the zero-mean field of
# phase 4 (seed 0), sea-surface temperature in kelvin, surface pressure in Pa
FAR_FIELDS = (("zero-mean", 0.0, 1.0), ("SST", 290.0, 2.0),
              ("pressure", 101325.0, 500.0))
FAR_LIMIT = 1e-5               # PERF.md's float32 limit against float64
# the launches of one flagship PSD on each route
PSD_LAUNCHES = {"torch": {"mirror_psd": 1, "detrend_window": 3},
                "kernel": {"fft_fourstep": 2, "mirror_psd": 1,
                           "detrend_window": 3},
                "matmul": {"dot": 1, "mirror_psd": 1, "detrend_window": 3}}


def far_field(xt, label):
    """FAR_FIELDS' field ``label`` on the flagship's grid, float32 on the
    card: mean + spread times phase 4's standard normal field."""
    _, mean, spread = next(f for f in FAR_FIELDS if f[0] == label)
    return labeled(xt, mean + spread * field(MAIN_SHAPE, 0))


def far_phase(xt, kernels, card):
    """Phase 28: the flagship PSD of fields far from zero mean, SST in
    kelvin and surface pressure in Pa, beside the zero-mean field, under
    every fft_impl: each within FAR_LIMIT of the same call on the float64
    values, with the launches of PSD_LAUNCHES.  Then the Welch flagship of
    SST (1024^2 hann segments, constant detrend per segment) under every
    fft_impl, and the prologue's device time (:func:`prologue_timing`)."""
    for label, _, _ in FAR_FIELDS:
        da = far_field(xt, label)
        ref = plain64(xt, xt.power_spectrum, da, **MAIN_KW)
        for impl, want in PSD_LAUNCHES.items():
            ps, n = counted(kernels, lambda: under(impl, xt.power_spectrum,
                                                   da, **MAIN_KW))
            err = rel_err(ps.data, ref.data)
            worst = tuple(int(i) for i in np.unravel_index(
                int((ps.data.double() - ref.data).abs().argmax()),
                MAIN_SHAPE))
            check(ps.dtype == torch.float32 and ps.shape == MAIN_SHAPE
                  and bool(torch.isfinite(ps.data).all()),
                  f"{label} PSD {impl}: unexpected output {ps!r}")
            check(err <= FAR_LIMIT, f"{label} PSD {impl}: rel err {err:.3e} "
                  f"vs the float64 values > {FAR_LIMIT}")
            check(n == {k: want.get(k, 0) for k in n},
                  f"{label} PSD {impl}: launches {n}, expected {want}")
            log(f"phase 28: {label} PSD {MAIN_SHAPE}, fft_impl={impl!r}: "
                f"rel err vs the float64 values {err:.3e} (limit "
                f"{FAR_LIMIT}), largest at {worst} (DC is (b, 2048, 2048)); "
                f"launches {n}")
            del ps
        del da, ref

    da = far_field(xt, "SST").chunk({"y": WELCH_SEG, "x": WELCH_SEG})
    kw = dict(dim=["y", "x"], window="hann", detrend="constant",
              chunks_to_segments=True)
    ref = plain64(xt, xt.power_spectrum, da, **kw)
    for impl, names in (("torch", ()), ("kernel", ("fft_fourstep",)),
                        ("matmul", ("dot",))):
        ps, n = counted(kernels, lambda: under(impl, xt.power_spectrum, da,
                                               **kw))
        err = rel_err(ps.data, ref.data)
        check(ps.dtype == torch.float32 and ps.shape == ref.shape
              and bool(torch.isfinite(ps.data).all()),
              f"SST Welch {impl}: unexpected output {ps!r}")
        check(err <= FAR_LIMIT, f"SST Welch {impl}: rel err {err:.3e} vs "
              f"the float64 values > {FAR_LIMIT}")
        check(all(n[k] > 0 for k in names),
              f"SST Welch {impl}: launches {n}, expected {names}")
        log(f"phase 28: SST Welch flagship {MAIN_SHAPE} in {WELCH_SEG}^2 "
            f"hann segments, detrend='constant', fft_impl={impl!r}: output "
            f"{tuple(ps.shape)}, rel err vs the float64 values {err:.3e} "
            f"(limit {FAR_LIMIT}); launches {n}")
        del ps
    del da, ref
    return prologue_timing(xt, card)


def prologue_timing(xt, card):
    """The float32 flagship PSD of the zero-mean field and of SST: its wall
    ms under "torch" and "kernel" (medians, in turns), its device ms under
    "kernel", and the device ms of its prologue alone (the linear detrend
    and the hann window), each from torch.profiler over three calls.
    Returns {field: {reading: ms}}."""
    from xrft_tpu_torch.config import fft_impl
    from xrft_tpu_torch.detrend import detrend_and_window

    out = {}
    for label in ("zero-mean", "SST"):
        da = far_field(xt, label)

        def psd(impl):
            def run():
                with fft_impl(impl):
                    xt.power_spectrum(da, **MAIN_KW)
            return run

        def prologue():
            detrend_and_window(da, ["y", "x"], "linear", "hann")

        t_torch, t_kernel = ab_ms(psd("torch"), psd("kernel"))
        dev, _ = device_split(psd("kernel"), f"phase 28: {label} flagship "
                              f"PSD, 'kernel'", card)
        pro, pro_wall = device_split(prologue, f"phase 28: {label} "
                                     f"prologue (linear detrend, hann)", card)
        out[label] = {"psd_torch_ms": t_torch, "psd_kernel_ms": t_kernel,
                      "psd_kernel_device_ms": dev, "prologue_device_ms": pro,
                      "prologue_wall_ms": pro_wall}
        log(f"phase 28: {label} flagship PSD {MAIN_SHAPE}: wall 'torch' "
            f"{t_torch:.3f} ms, 'kernel' {t_kernel:.3f} ms, device "
            f"'kernel' {dev:.3f} ms; prologue device {pro:.3f} ms "
            f"[{card}]")
        del da
    return out


def prologue_only():
    """``python3 chip_smoke.py --prologue``: :func:`prologue_timing` alone,
    for the package beside this script (so a copy of the script in another
    checkout times that checkout's prologue); its last line is the
    readings' JSON."""
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device "
                         "(torch.cuda.is_available() is false)")
    import xrft_tpu_torch as xt
    from xrft_tpu_torch.ops import _build

    card = card_line()
    with ThreadPoolExecutor(3) as pool:
        for job in [pool.submit(_build.load, name)
                    for name in ("mirror", "fft_fourstep", "prologue")]:
            job.result()
    print(card, flush=True)
    print(json.dumps(prologue_timing(xt, card)), flush=True)


# ---- phase 29: K6, the detrend-and-window prologue ------------------------

# K6 held to its plain version at these shapes (the flagship's rows at 8
# fields, an odd ragged row, a stack of 128 planes over three axes), then
# timed on the benchmark's stacks: the flagship and GLORYS12 in float32, the
# flagship in float64 (the hp path); on few long rows (8 series of 2^22
# values, cut into chunks of 8192); and on one rank's slab of the dns-2048
# cell over (z, y, x)
K6_CHECK_SHAPES = (((8, 4096, 4096), ["y", "x"]),
                   ((3, 257, 1001), ["y", "x"]),
                   ((1, 128, 512, 512), ["z", "y", "x"]))
K6_SHAPES = (((64, 4096, 4096), torch.float32, ["y", "x"]),
             ((64, 2041, 4320), torch.float32, ["y", "x"]),
             ((64, 4096, 4096), torch.float64, ["y", "x"]),
             ((8, 1, 1 << 22), torch.float32, ["y", "x"]),
             ((1, 512, 2048, 2048), torch.float32, ["z", "y", "x"]))
K6_LIMIT = {torch.float32: 2.0 ** -22, torch.float64: 1e-13}


def k6_labeled(xt, data):
    """``labeled`` for a (time, y, x) stack; a (component, z, y, x) one with
    the same spacing."""
    if data.ndim == 3:
        return labeled(xt, data)
    dims = ("component", "z", "y", "x")
    return xt.LabeledArray(data, dims=dims, coords={
        d: np.arange(n) * 0.5 for d, n in zip(dims[1:], data.shape[1:])})


def blocked_rel_err(got, ref, block=1 << 26) -> float:
    """``rel_err`` a block of values at a time: no temporary of the whole
    stack."""
    g, r = got.reshape(-1), ref.reshape(-1)
    err = top = 0.0
    for k in range(0, r.numel(), block):
        err = max(err, (g[k:k + block].to(r.dtype) - r[k:k + block]).abs()
                  .max().item())
        top = max(top, r[k:k + block].abs().max().item())
    return err / top


def k6_ptxas(build) -> list:
    """``nvcc -Xptxas -v`` on csrc/prologue.cu: each kernel's entry,
    registers and spill lines."""
    flags = [f for f in build.NVCC_FLAGS if f != "-shared"]
    out = build.BUILD_DIR / "prologue-ptxas.o"
    build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    proc = subprocess.run(
        [build._nvcc(), *flags, "-Xptxas", "-v", "-c", "-o", str(out),
         str(build.CSRC / "prologue.cu")],
        capture_output=True, text=True, check=True)
    out.unlink(missing_ok=True)
    return [ln.strip() for ln in (proc.stdout + proc.stderr).splitlines()
            if "entry function" in ln or "registers" in ln or "spill" in ln]


def parent_prologue(root):
    """K6's wrapper (``xrft_tpu_torch/ops/prologue.py``) of the checkout at
    ``root``, imported beside this tree's as ``parent_ops.prologue`` with
    the ``ops/_build.py`` that builds its library there."""
    import importlib
    import types
    from pathlib import Path

    ops = Path(root).resolve() / "xrft_tpu_torch" / "ops"
    if not (ops / "prologue.py").is_file():
        raise SystemExit(f"chip_smoke: no K6 wrapper at {ops}")
    pkg = types.ModuleType("parent_ops")
    pkg.__path__ = [str(ops)]
    sys.modules["parent_ops"] = pkg
    return importlib.import_module("parent_ops.prologue")


def k6_against(parent, kernel, x, axes, w, label, rounds=5):
    """``kernel()`` (this tree's K6 on ``x``, the window's factors ``w``)
    against the parent's K6 on the same input: the outputs bit for bit,
    then both timed between CUDA events in turns, parent, this, this,
    parent, ``rounds`` times; the medians in ms."""
    nd = x.ndim
    q = parent.plan(x.shape, x.shape, axes, True, {a: 0 for a in axes})

    def theirs():
        return parent.detrend_window(x, q, wz=w.get(nd - 3), wy=w[nd - 2],
                                     wx=w[nd - 1])

    check(torch.equal(kernel(), theirs()),
          f"{label}: the output differs from the parent's")
    tp, tc = [], []
    for _ in range(rounds):
        tp.append(event_ms(theirs, runs=5, warmup=1, batch=5))
        tc.append(event_ms(kernel, runs=5, warmup=1, batch=5))
        tc.append(event_ms(kernel, runs=5, warmup=1, batch=5))
        tp.append(event_ms(theirs, runs=5, warmup=1, batch=5))
    return statistics.median(tp), statistics.median(tc)


def k6_phase(xt, build, card, parent=None):
    """Phase 29: K6 (``csrc/prologue.cu``) through
    ``detrend.detrend_and_window`` against ``detrend_and_window_plain``:
    float32 and float64, constant and linear, hann and no window, SST in
    kelvin, over two axes and three, within K6_LIMIT of the plain output's
    max, two calls bit for bit, three launches a call.  Then K6_SHAPES'
    linear hann prologue of SST in kelvin, held within K6_LIMIT of the
    plain version's, and timed back
    to back between CUDA events, the kernel alone (``ms``) and the whole
    prologue (``call_ms``: the window's factors made on the host and
    copied, which blocks), beside the plain version, the bound (the stack
    read once and the FFT's input written once at 3.35 TB/s) and K6's own
    traffic (read twice, written once), and its kernels' device split.
    With ``parent`` (another checkout's ``ops/prologue.py``,
    :func:`parent_prologue`), each timed stack's output is also held bit
    for bit to the parent's K6 and both are timed in turns
    (:func:`k6_against`).  Returns the timings' rows."""
    import importlib

    from xrft_tpu_torch.ops import prologue
    from xrft_tpu_torch.ops.window import window_vectors

    det = importlib.import_module("xrft_tpu_torch.detrend")
    lines = k6_ptxas(build)
    for ln in lines:
        log(f"phase 29: ptxas: {ln}")
    check(all(" 0 bytes spill stores, 0 bytes spill loads" in ln
              for ln in lines if "spill" in ln),
          "K6: a kernel spills registers")
    for shape, dims in K6_CHECK_SHAPES:
        for dtype in (torch.float32, torch.float64):
            da = k6_labeled(xt, 290 + 2 * field(shape, 29, dtype))
            for kind in ("constant", "linear"):
                for window in ("hann", None):
                    n0 = prologue.detrend_window.launches
                    got = det.detrend_and_window(da, dims, kind, window)
                    again = det.detrend_and_window(da, dims, kind, window)
                    n = prologue.detrend_window.launches - n0
                    ref = det.detrend_and_window_plain(da, dims, kind,
                                                       window)
                    torch.cuda.synchronize()
                    err = rel_err(got.data, ref.data)
                    check(torch.equal(got.data, again.data),
                          f"K6 {shape} {dtype}: two calls differ")
                    check(got.dtype == dtype and n == 6,
                          f"K6 {shape} {dtype}: {got.dtype}, {n} launches")
                    check(err <= K6_LIMIT[dtype], f"K6 {shape} {dtype} "
                          f"{kind} {window}: rel err {err:.3e} vs plain")
                    log(f"phase 29: K6 {shape} {dtype} {kind} {window}: rel "
                        f"err vs plain {err:.3e} (limit "
                        f"{K6_LIMIT[dtype]:.3e}); repeat bit-identical")
                    del got, again, ref
            del da
    rows = []
    for shape, dtype, dims in K6_SHAPES:
        # SST in kelvin, as above: the float64 moments matter there
        da = k6_labeled(xt, field(shape, 29, dtype).mul_(2).add_(290))
        args = (da, dims, "linear", "hann")

        def k6():
            return det.detrend_and_window(*args)

        def plain():
            return det.detrend_and_window_plain(*args)

        # the kernel alone: its plan and the window's factors made once
        x = da.data
        axes = tuple(da.get_axis_num(d) for d in dims)
        p = prologue.plan(x.shape, x.shape, axes, True, {a: 0 for a in axes})
        w = dict(zip(axes, window_vectors(da, dims, "hann", dtype,
                                          x.device)))
        nd = x.ndim

        def kernel():
            return prologue.detrend_window(x, p, wz=w.get(nd - 3),
                                           wy=w[nd - 2], wx=w[nd - 1])

        got = k6().data
        err = blocked_rel_err(got, plain().data)
        del got
        check(err <= K6_LIMIT[dtype], f"K6 {shape} {dtype} linear hann: "
              f"rel err {err:.3e} vs plain")
        t_kernel = event_ms(kernel, runs=10, warmup=2, batch=3)
        t_k6 = event_ms(k6, runs=10, warmup=2, batch=3)
        t_plain = event_ms(plain, runs=5, warmup=1, batch=2)
        value = x.numel() * x.element_size()
        least = bound(2 * value, 0)[0]
        dev, _ = device_split(k6, f"phase 29: K6 {shape} {dtype}", card)
        rows.append({"shape": list(shape), "dtype": str(dtype),
                     "ms": t_kernel, "call_ms": t_k6, "plain_ms": t_plain,
                     "bound_ms": least,
                     "traffic_bound_ms": bound(3 * value, 0)[0],
                     "device_ms": dev, "rel_err_vs_plain": err})
        if parent is not None:
            label = f"phase 29: K6 {shape} {dtype}"
            t_parent, t_this = k6_against(parent, kernel, x, axes, w, label)
            rows[-1].update(parent_ms=t_parent, this_ms=t_this)
            log(f"{label}, back to back in turns: the parent's "
                f"{t_parent:.3f} ms, this tree's {t_this:.3f} ms "
                f"({t_this / t_parent - 1:+.2%}); outputs bit for bit "
                f"equal [{card}]")
        log(f"phase 29: K6 {shape} {dtype}, linear + hann, back to back: "
            f"the kernel alone {t_kernel:.3f} ms ({least / t_kernel:.1%} of "
            f"the bound {least:.3f} ms; {3 * value / t_kernel / 1e6:.0f} "
            f"GB/s of its own traffic); the whole prologue (the window's "
            f"factors made and copied) {t_k6:.3f} ms, plain {t_plain:.3f} "
            f"ms; device {dev:.3f} ms; rel err vs plain {err:.3e} [{card}]")
        del da, x, w
    return rows


def k6_only(parent=None):
    """``python3 chip_smoke.py --k6 [DIR]``: phase 29 alone, against the K6
    of the checkout at DIR where given; its last line is the timings'
    JSON."""
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device "
                         "(torch.cuda.is_available() is false)")
    import xrft_tpu_torch as xt
    from xrft_tpu_torch.ops import _build

    card = card_line()
    _build.load("prologue")
    log(f"phase 29: {card}; nvcc {_build.build_seconds}")
    if parent is not None:
        parent = parent_prologue(parent)
    print(json.dumps(k6_phase(xt, _build, card, parent)), flush=True)


def main():
    # ---- phase 1: device, versions, build --------------------------------
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device "
                         "(torch.cuda.is_available() is false)")
    import xrft_tpu_torch as xt
    from xrft_tpu_torch.config import fft_impl, psd_mirror_impl
    from xrft_tpu_torch.ops import (_build, binning, dft64, dot, fft_fourstep,
                                    mirror, prologue)

    card = card_line()
    log(f"phase 1: {card}; torch {torch.__version__}, CUDA "
        f"{torch.version.cuda}, python {sys.version.split()[0]}")
    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(SOURCES)) as pool:
        for job in [pool.submit(_build.load, name) for name in SOURCES]:
            job.result()
    log(f"phase 1: csrc built and loaded in {time.perf_counter() - t0:.2f} s "
        f"(nvcc per source, in parallel: "
        f"{_build.build_seconds or 'up to date'})")
    sass = dot_sass(_build)
    ops = sorted({ln.split()[0].rstrip(";") for ln in sass})
    log(f"phase 1: the dot library's SASS holds {len(sass)} tensor-core and "
        f"TMA instructions of K5a and K5c: {', '.join(ops)}")
    check(any(o.startswith("HGMMA") for o in ops),
          "the dot library's SASS holds no HGMMA: not on the tensor cores")
    check(any(o.startswith("UTMALDG") for o in ops)
          and any(o.startswith("UTMASTG") for o in ops),
          "K5c's SASS holds no TMA load (UTMALDG) or store (UTMASTG)")

    # ---- phase 2: K1 against its plain version, bit for bit --------------
    k1_err = 0.0
    for shape, nx in (((8, 4096, 2049), 4096), ((3, 1001, 499), 997),
                      ((2, 3, 4099), 8193)):
        for dtype in (torch.complex64, torch.complex128):
            F = field(shape, 1, dtype)
            for shift in (True, False):
                got = mirror.mirror_psd(F, nx, shift, 0.37)
                ref = mirror.mirror_psd_plain(F, nx, shift, 0.37)
                torch.cuda.synchronize()
                check(got.dtype == ref.dtype and torch.equal(got, ref),
                      f"K1 {shape}->{nx} {dtype} shift={shift}: differs from "
                      f"plain, max abs err {(got - ref).abs().max().item()}")
                err = (got - ref).abs().max().item()
                if shape[0] == 8 and dtype == torch.complex64:
                    k1_err = max(k1_err, err)
                log(f"phase 2: K1 {shape}->{nx} {dtype} shift={shift}: equal "
                    f"to plain bit for bit")
            del F, got, ref

    # ---- phase 3: K2 against its plain version and cuFFT -----------------
    k2_err = 0.0
    main_k2 = {(32768, 4096, False), (16392, 4096, True)}
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = True   # a caller's setting
    for rows, n, cplx, sign in ((32768, 4096, False, -1),
                                (16392, 4096, True, -1),
                                (4096, 256, True, -1),
                                (4096, 1000, False, -1),
                                (4096, 1000, True, 1),
                                (4096, 1004, True, 1),
                                (64, 65536, False, -1)):
        x = field((rows, n), 2, torch.complex64 if cplx else torch.float32)
        got = fft_fourstep.fft_last(x, sign)
        again = fft_fourstep.fft_last(x, sign)
        plain = fft_fourstep.fft_last_plain(x, sign)
        x64 = x.to(torch.complex128)
        ref = torch.fft.fft(x64) if sign == -1 else torch.fft.ifft(x64) * n
        torch.cuda.synchronize()
        check(torch.equal(got, again), f"K2 n={n}: two launches differ")
        e_plain, e_ref = rel_err(got, plain.to(torch.complex128)), \
            rel_err(got, ref)
        check(e_plain <= 1e-5 and e_ref <= 1e-5,
              f"K2 n={n} rows={rows}: {e_plain:.3e} / {e_ref:.3e} > 1e-5")
        if (rows, n, cplx) in main_k2:
            k2_err = max(k2_err, (got - plain).abs().max().item())
        log(f"phase 3: K2 ({rows}, {n}) {'complex' if cplx else 'real'} "
            f"sign {sign:+d}{' (two passes)' if n > 8192 else ''}: rel err "
            f"vs plain {e_plain:.3e}, vs complex128 cuFFT {e_ref:.3e} (limit "
            f"1e-5); two launches bit-identical")
        del x, got, again, plain, x64, ref
    check(torch.backends.cuda.matmul.allow_tf32 is True,
          "the plain K2 changed the caller's TF32 setting")
    torch.backends.cuda.matmul.allow_tf32 = tf32
    log("phase 3: the plain K2 left the caller's allow_tf32 = True as it was")

    # ---- phase 4: the main path ------------------------------------------
    da = labeled(xt, field(MAIN_SHAPE, 0))
    da64 = labeled(xt, da.data.double())
    with fft_impl("torch"), psd_mirror_impl("plain"):
        ref = xt.power_spectrum(da64, **MAIN_KW)
    mirror.mirror_psd.launches = 0
    fft_fourstep.fft_last.launches = 0
    prologue.detrend_window.launches = 0
    with fft_impl("kernel"):
        ps_kernel = xt.power_spectrum(da, **MAIN_KW)
    torch.cuda.synchronize()
    launches = {"mirror_psd": mirror.mirror_psd.launches,
                "fft_fourstep": fft_fourstep.fft_last.launches,
                "detrend_window": prologue.detrend_window.launches}
    log(f"phase 4: main path {MAIN_SHAPE} under fft_impl='kernel': kernel "
        f"launches {launches}")
    check(all(v > 0 for v in launches.values()),
          f"a kernel of the main path was not launched: {launches}")
    check(launches["detrend_window"] == 3,
          f"K6: {launches['detrend_window']} launches in one PSD, not 3")
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
        rng.randn(*ENTRY_SHAPE).astype(np.float32), device=DEV))
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
    device_split(main_path("kernel"), "phase 5: main path, 'kernel'", card)
    with psd_mirror_impl("plain"):
        t_main_plain = wall_ms(main_path("torch"))
    log(f"phase 5: main path, fft_impl='torch' with psd_mirror_impl='plain' "
        f"(no hand kernel): {t_main_plain:.3f} ms [{card}]")
    del da

    F = field((8, 4096, 2049), 3, torch.complex64)
    check(torch.equal(mirror.mirror_psd(F, 4096, True, 1.0),
                      mirror.mirror_psd_plain(F, 4096, True, 1.0)),
          "K1 (8, 4096, 2049)->4096: differs from plain")
    k1_plain, k1_ms = ab_ms(lambda: mirror.mirror_psd_plain(F, 4096, True, 1.0),
                            lambda: mirror.mirror_psd(F, 4096, True, 1.0))
    k1_ev = event_ms(lambda: mirror.mirror_psd(F, 4096, True, 1.0))
    gbytes = (F.numel() * 8 + 8 * 4096 * 4096 * 4) / 1e9
    k1_bound = bound(gbytes * 1e9, 4.0 * 8 * 4096 * 4096)
    log(f"phase 5: K1 (8, 4096, 2049)->4096, equal to plain bit for bit: "
        f"kernel {k1_ms:.3f} ms ({gbytes / k1_ms * 1e3:.0f} GB/s of the "
        f"{gbytes:.2f} GB it must move), plain {k1_plain:.3f} ms; back to "
        f"back between CUDA events kernel {k1_ev:.3f} ms, "
        f"{k1_bound[0] / k1_ev:.1%} of the {k1_bound[1]} bound "
        f"{k1_bound[0]:.3f} ms [{card}]")
    del F

    k2_ms = k2_plain = k2_lib = k2_bytes = k2_flops = 0.0
    for rows, cplx in ((32768, False), (16392, True)):
        x = field((rows, 4096), 4, torch.complex64 if cplx else torch.float32)
        tp, tk = ab_ms(lambda: fft_fourstep.fft_last_plain(x),
                       lambda: fft_fourstep.fft_last(x))
        t_cufft = wall_ms(lambda: torch.fft.fft(x))
        k2_ms += tk
        k2_plain += tp
        k2_lib += t_cufft
        nbytes = x.numel() * x.element_size() + rows * 4096 * 8
        k2_bytes += nbytes
        k2_flops += fft_flops(rows, 4096)
        b_ms = bound(nbytes, fft_flops(rows, 4096))[0]
        log(f"phase 5: K2 ({rows}, 4096) {'complex' if cplx else 'real'}: "
            f"kernel {tk:.3f} ms ({nbytes / tk / 1e6:.0f} GB/s, "
            f"{b_ms / tk:.1%} of the bound {b_ms:.3f} ms), plain {tp:.3f} "
            f"ms, torch.fft.fft (cuFFT) {t_cufft:.3f} ms; back to back "
            f"between CUDA events kernel "
            f"{event_ms(lambda: fft_fourstep.fft_last(x)):.3f} ms, cuFFT "
            f"{event_ms(lambda: torch.fft.fft(x)):.3f} ms [{card}]")
        del x

    k3 = k3_phase(binning, card)
    k3["launches"] = isotropic_phase(xt, binning, mirror)
    isotropic_timings(xt, binning, card)

    # ---- phases 9-11: K4, the float64 precision path, the inverse --------
    k4 = k4_phase(dft64, card)
    k4["launches"] = hp_phase(xt, {"dft64": dft64.dft_last,
                                   "fft_fourstep": fft_fourstep.fft_last,
                                   "mirror_psd": mirror.mirror_psd,
                                   "binned_sum": binning.binned_sum}, card)
    inverse_phase(xt, fft_fourstep, card)

    # ---- phases 12-14: K5, the matmul route, the segmented estimators ----
    k5 = k5_phase(dot, card)
    k5_launches = matmul_phase(xt, {"dot": dot.dot, "dot_fold": dot.dot_fold,
                                     "dot_dma": dot.dot_dma,
                                     "mirror_psd": mirror.mirror_psd}, card)
    welch_k5a = segments_phase(xt, dot.dot, card)
    log(f"phase 14: K5a launches on the Welch flagship under 'matmul': "
        f"{welch_k5a}")
    pad_phase(xt, card)

    # ---- phases 16-24: the scipy-namesake families ------------------------
    trig_phase(xt, fft_fourstep.fft_last, dft64.dft_last, card)
    analytic_phase(xt, fft_fourstep.fft_last, card)
    convolve_phase(xt, fft_fourstep.fft_last, card)
    filter_phase(xt, fft_fourstep.fft_last, card)
    czt_phase(xt, fft_fourstep.fft_last, card)
    fht_phase(xt, dft64.dft_last, card)
    resample_phase(xt, fft_fourstep.fft_last, card)
    lombscargle_phase(xt, card)

    # ---- phase 25: the sharded path on a one-rank NCCL group --------------
    sharded_phase(xt, {"mirror_psd": mirror.mirror_psd,
                       "fft_fourstep": fft_fourstep.fft_last,
                       "binned_sum": binning.binned_sum,
                       "dft64": dft64.dft_last}, card)

    # ---- phase 26: the matmul engine's pair path --------------------------
    pair_phase(xt, {"mirror_psd": mirror.mirror_psd,
                    "fft_fourstep": fft_fourstep.fft_last,
                    "binned_sum": binning.binned_sum,
                    "dft64": dft64.dft_last, "dot": dot.dot,
                    "dot_fold": dot.dot_fold, "dot_dma": dot.dot_dma}, card)

    # ---- phase 27: integer, float16 and complex input ---------------------
    repair_phase(xt, {"mirror_psd": mirror.mirror_psd,
                      "fft_fourstep": fft_fourstep.fft_last,
                      "dft64": dft64.dft_last, "dot": dot.dot}, card)

    # ---- phase 28: fields far from zero mean ------------------------------
    far_phase(xt, {"mirror_psd": mirror.mirror_psd,
                   "fft_fourstep": fft_fourstep.fft_last,
                   "binned_sum": binning.binned_sum,
                   "dft64": dft64.dft_last, "dot": dot.dot,
                   "dot_fold": dot.dot_fold, "dot_dma": dot.dot_dma,
                   "detrend_window": prologue.detrend_window}, card)

    # ---- phase 29: K6, the detrend-and-window prologue --------------------
    k6 = k6_phase(xt, _build, card)
    k2_bound = bound(k2_bytes, k2_flops)
    dot_src = "xrft_tpu_torch/csrc/dot.cu"
    engine, packed = k5["engine"], k5["packed"]
    for name, e in (("engine", engine), ("packed", packed)):
        log(f"K5 {name}: K5a {e['ms']:.3f} ms (back to back "
            f"{e['event_ms']:.3f}), K5c {e['dma_ms']:.3f} ms (back to back "
            f"{e['dma_event_ms']:.3f}; {e['dma_producer']}), plain "
            f"{e['plain_ms']:.3f} ms, torch.matmul {e['library_ms']:.3f} ms "
            f"(back to back {e['library_event_ms']:.3f}), the "
            f"{e['bound_by']} bound {e['bound_ms']:.3f} ms")

    print(card, flush=True)
    print(json.dumps({"kernels": [
        {"name": "mirror_psd", "route": "cuda",
         "source": "xrft_tpu_torch/csrc/mirror.cu",
         "replaces": "xrft_tpu/ops/pallas_mirror.py:82",
         "launches": launches["mirror_psd"], "max_abs_err": k1_err,
         "ms": k1_ms, "plain_ms": k1_plain, "bound_ms": k1_bound[0],
         "bound_by": k1_bound[1], "library_ms": None},
        {"name": "fft_fourstep", "route": "cuda",
         "source": "xrft_tpu_torch/csrc/fft_fourstep.cu",
         "replaces": "xrft_tpu/ops/pallas_fft.py:284",
         "launches": launches["fft_fourstep"], "max_abs_err": k2_err,
         "ms": k2_ms, "plain_ms": k2_plain, "bound_ms": k2_bound[0],
         "bound_by": k2_bound[1], "library_ms": k2_lib},
        {"name": "binned_sum", "route": "cuda",
         "source": "xrft_tpu_torch/csrc/binned_sum.cu",
         "replaces": "xrft_tpu/ops/binning.py:77", **k3},
        {"name": "dft64", "route": "cuda",
         "source": "xrft_tpu_torch/csrc/dft64.cu",
         "replaces": "xrft_tpu/ops/df64_fft.py:129", **k4},
        {"name": "dot", "route": "cuda", "source": dot_src,
         "replaces": "xrft_tpu/ops/pallas_dot.py:72",
         "launches": k5_launches["dot"],
         **{k: engine[k] for k in ("max_abs_err", "ms", "plain_ms",
                                   "bound_ms", "bound_by", "library_ms")}},
        {"name": "dot_fold", "route": "cuda", "source": dot_src,
         "replaces": "xrft_tpu/ops/pallas_dot.py:112",
         "launches": k5_launches["dot_fold"],
         **k5["fold"]},
        {"name": "dot_dma", "route": "cuda", "source": dot_src,
         "replaces": "xrft_tpu/ops/pallas_dot.py:157",
         "launches": k5_launches["dot_dma"],
         "max_abs_err": engine["dma_max_abs_err"], "ms": engine["dma_ms"],
         "plain_ms": engine["plain_ms"], "bound_ms": engine["bound_ms"],
         "bound_by": engine["bound_by"],
         "library_ms": engine["library_ms"],
         "event_ms": engine["dma_event_ms"],
         "producer": engine["dma_producer"],
         "packed": {k: packed[v] for k, v in (
             ("max_abs_err", "dma_max_abs_err"), ("ms", "dma_ms"),
             ("event_ms", "dma_event_ms"), ("plain_ms", "plain_ms"),
             ("bound_ms", "bound_ms"), ("bound_by", "bound_by"),
             ("library_ms", "library_ms"),
             ("library_event_ms", "library_event_ms"),
             ("producer", "dma_producer"))}},
        {"name": "detrend_window", "route": "cuda",
         "source": "xrft_tpu_torch/csrc/prologue.cu", "replaces": None,
         "launches": launches["detrend_window"],
         "rel_err_vs_plain": max(r["rel_err_vs_plain"] for r in k6),
         "ms": k6[0]["ms"], "plain_ms": k6[0]["plain_ms"],
         "bound_ms": k6[0]["bound_ms"], "bound_by": "bytes",
         "library_ms": None, "shapes": k6},
    ]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    if sys.argv[1:2] == ["--k6"] and len(sys.argv) <= 3:
        k6_only(*sys.argv[2:])
    else:
        {("--prologue",): prologue_only}.get(tuple(sys.argv[1:]), main)()
