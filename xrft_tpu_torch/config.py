"""Process-wide configuration of xrft_tpu_torch.

Counterpart of ``xrft_tpu/config.py``, reduced to the two knobs that mean
something on a CUDA device.  Everything else in the JAX package's config
steers TPU-only machinery (matmul engines, split complex, df64) that this
package does not carry.
"""

from __future__ import annotations

import dataclasses
from contextlib import contextmanager

FFT_IMPLS = ("torch", "kernel")
MIRROR_IMPLS = ("kernel", "plain")


@dataclasses.dataclass
class _Config:
    # FFT execution:
    #   "torch"  - torch.fft (cuFFT on a CUDA device, pocketfft on the CPU),
    #              as the JAX package's GPU branch resolves to XLA's FFT.
    #   "kernel" - the hand-written four-step DFT (ops/fft_fourstep.py), one
    #              launch per transformed axis; float32 only, and only for
    #              axis lengths n >= 256 with a factor pair n1, n2 <= 256.
    fft_impl: str = "torch"
    # Two-sided PSD epilogue of power_spectrum for real input:
    #   "kernel" - |F|^2, the scale, the y-fftshift and the Hermitian mirror
    #              in one pass (ops/mirror.py) whenever the two transform dims
    #              are the array's trailing two.
    #   "plain"  - the general Hermitian expansion in torch ops
    #              (spectra._hermitian_expand), for any geometry.
    psd_mirror_impl: str = "kernel"


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
