"""Process-wide configuration of xrft_tpu_torch.

Counterpart of ``xrft_tpu/config.py``, reduced to the knobs that mean
something on a CUDA device: which route each hand-written kernel's step
takes.  Everything else in the JAX package's config
steers TPU-only machinery (matmul engines, split complex, df64) that this
package does not carry.
"""

from __future__ import annotations

import dataclasses
from contextlib import contextmanager

FFT_IMPLS = ("torch", "kernel")
MIRROR_IMPLS = ("kernel", "plain")
BINNED_SUM_IMPLS = ("kernel", "plain")


@dataclasses.dataclass
class _Config:
    # FFT execution:
    #   "torch"  - torch.fft (cuFFT on a CUDA device, pocketfft on the CPU),
    #              as the JAX package's GPU branch resolves to XLA's FFT.
    #   "kernel" - the hand-written kernels, picked by dtype: float32 and
    #              complex64 data run the four-step DFT K2
    #              (ops/fft_fourstep.py), one launch per transformed axis, for
    #              axis lengths n >= 256 with a factor pair n1, n2 <= 256;
    #              float64 and complex128 data run the FP64 recursion with K4
    #              as its base case (ops/dft64.py), for lengths whose factors
    #              are <= 256.  Anything else raises.
    fft_impl: str = "torch"
    # Two-sided PSD epilogue of power_spectrum for real input:
    #   "kernel" - |F|^2, the scale, the y-fftshift and the Hermitian mirror
    #              in one pass (ops/mirror.py) whenever the two transform dims
    #              are the array's trailing two.
    #   "plain"  - the general Hermitian expansion in torch ops
    #              (spectra._hermitian_expand), for any geometry.
    psd_mirror_impl: str = "kernel"
    # Per-bin sums of isotropize (the radial binning):
    #   "kernel" - the hand-written sorted segmented reduction K3
    #              (ops/binning.binned_sum) on a CUDA tensor.
    #   "plain"  - the JAX package's non-TPU route in torch ops
    #              (ops/binning.binned_sum_plain): a one-hot matmul for
    #              small grids, a sorted prefix difference for large ones.
    # A CPU tensor takes the plain route under either value.
    binned_sum_impl: str = "kernel"


config = _Config()


def _check(value, allowed, what):
    if value not in allowed:
        raise ValueError(f"unknown {what} {value!r}; expected one of {allowed}")


@contextmanager
def fft_impl(impl: str):
    """Temporarily set ``config.fft_impl``."""
    _check(impl, FFT_IMPLS, "fft_impl")
    old = config.fft_impl
    config.fft_impl = impl
    try:
        yield
    finally:
        config.fft_impl = old


@contextmanager
def psd_mirror_impl(impl: str):
    """Temporarily set ``config.psd_mirror_impl``."""
    _check(impl, MIRROR_IMPLS, "psd_mirror_impl")
    old = config.psd_mirror_impl
    config.psd_mirror_impl = impl
    try:
        yield
    finally:
        config.psd_mirror_impl = old


@contextmanager
def binned_sum_impl(impl: str):
    """Temporarily set ``config.binned_sum_impl``."""
    _check(impl, BINNED_SUM_IMPLS, "binned_sum_impl")
    old = config.binned_sum_impl
    config.binned_sum_impl = impl
    try:
        yield
    finally:
        config.binned_sum_impl = old
