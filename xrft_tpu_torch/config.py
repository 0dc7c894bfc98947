"""Process-wide configuration of xrft_tpu_torch.

Counterpart of ``xrft_tpu/config.py``, reduced to the knobs that mean
something on a CUDA device: which route each hand-written kernel's step
takes, and the direct/FFT crossover of ``choose_conv_method``.
:func:`engine_impl` maps the modules' per-call ``engine=`` onto
``fft_impl``, and :func:`set_fft_engine`/:func:`fft_engine` the JAX
package's process-wide engine names; :func:`complex_mode` keeps its name.
Everything else in the JAX package's config
steers TPU-only machinery (split complex, df64) that this package does not
carry.  :func:`full_fp32` is the one scoped switch of torch's own state:
float32 products and cuDNN convolutions at full float32 grade for the
duration of a call.
"""

from __future__ import annotations

import dataclasses
from contextlib import contextmanager

import torch

FFT_IMPLS = ("torch", "kernel", "matmul")
LEVEL0_IMPLS = ("unpacked", "packed")
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
    #   "matmul" - the matmul engines (ops/matmul_fft.py), the counterpart
    #              of the JAX package's fft_engine="matmul": DFT stages as
    #              dense products over radices <= direct_dft_max.  The
    #              stacked engine (ops/stacked_fft.py) takes every request
    #              it can plan, its real-input level-0 product on the
    #              hand-written kernel K5a (ops/dot.py) for float32 data on
    #              the card; the pair engine the rest (irfftn, Bluestein for
    #              a prime factor above direct_dft_max, shifts an odd radix
    #              cannot absorb), its unshifted float32 four-step levels on
    #              K2 (ops/fft_fourstep.py) wherever K2 takes the length.
    fft_impl: str = "torch"
    # Largest radix of the matmul engine's plans (xrft_tpu/config.py:30-36):
    # a length up to it is one dense DFT product, a longer one a four-step
    # chain of such products.  The radix plan, and so every product's shape,
    # depends on it.
    direct_dft_max: int = 128
    # Layout of the matmul engine's real-input level-0 product, the
    # counterpart of the JAX package's pallas_level0:
    #   "unpacked" - W(2k, j) @ X(j, cols) on the engine's own layout, the
    #                input read through its strides (no copy).
    #   "packed"   - G=4 column blocks stacked along j against a
    #                block-diagonal W(4*2k, 4*j), the TPU's fix for its
    #                128x128 matrix unit; it costs an input and an output
    #                relayout and four times the multiply-adds.
    # Both run K5a on the card and its plain version on the CPU.
    level0_impl: str = "unpacked"
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
    # choose_conv_method's crossover (xrft_tpu/config.py:143-153, 8192 on
    # the TPU): a kernel of at most this many elements takes
    # method="direct" (one cuDNN convolution at full float32 grade), a
    # larger one the padded FFT route.  chip_smoke.py's phase 19 measures
    # it on the 4096^2 field for square kernels from 3^2 to 127^2: on an
    # H100 the direct route won at 3^2 and 7^2 (about 1 ms against 5.4)
    # and lost from 15^2 on (15.1 ms; 219 at 63^2).
    direct_conv_max: int = 49
    # The pencil FFT's compute/communication overlap
    # (xrft_tpu/config.py:67-71): each (all_to_all -> local FFT) pair of
    # parallel/pencil.py is split along its largest resident axis into this
    # many chunks, each chunk's all_to_all issued asynchronously so that it
    # runs while the previous chunk's FFT does.  1 = no chunking.
    pencil_overlap_chunks: int = 1


config = _Config()

# the modules' per-call engine= (xrft_tpu's fft engines) as an fft_impl;
# "auto" resolves as the JAX package's does on a GPU (xrft_tpu/config.py:
# 165-172): to XLA's FFT, which is cuFFT here
_ENGINE_IMPLS = {"auto": "torch", "xla": "torch", "matmul": "matmul"}
ENGINE_NAMES = tuple(_ENGINE_IMPLS)


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
def level0_impl(impl: str):
    """Temporarily set ``config.level0_impl``."""
    _check(impl, LEVEL0_IMPLS, "level0_impl")
    old = config.level0_impl
    config.level0_impl = impl
    try:
        yield
    finally:
        config.level0_impl = old


@contextmanager
def engine_impl(engine):
    """Run the block under the ``config.fft_impl`` that a module's per-call
    ``engine=`` names, as ``xrft_tpu``'s ``resolve_fft_engine`` resolves it:
    None and "auto" keep the current ``fft_impl``, "xla" is "torch" (cuFFT)
    and "matmul" the matmul engine; anything else raises."""
    if engine in (None, "auto"):
        yield
        return
    if engine not in _ENGINE_IMPLS:
        raise ValueError(f"Unknown fft engine {engine!r}")
    with fft_impl(_ENGINE_IMPLS[engine]):
        yield


def set_fft_engine(engine: str) -> None:
    """``xrft_tpu.set_fft_engine``: "auto" and "xla" set ``fft_impl`` to
    "torch" (cuFFT; the JAX package's GPU resolution), "matmul" to the
    matmul engine; anything else raises with the JAX package's message."""
    if engine not in _ENGINE_IMPLS:
        raise ValueError(f"Unknown fft engine {engine!r}")
    config.fft_impl = _ENGINE_IMPLS[engine]


@contextmanager
def fft_engine(engine: str):
    """``xrft_tpu.fft_engine``: :func:`set_fft_engine` for the block; the
    previous ``fft_impl`` (any of :data:`FFT_IMPLS`, "kernel" included) is
    restored on the way out."""
    old = config.fft_impl
    set_fft_engine(engine)
    try:
        yield
    finally:
        config.fft_impl = old


@contextmanager
def complex_mode(mode: str):
    """``xrft_tpu.complex_mode``.  Complex data are native torch complex
    tensors on every device, so "auto" and "native" change nothing.  The
    split (re, im) representation is the JAX package's answer to a TPU that
    runs no complex arithmetic; its ``ComplexPair`` layer is not carried by
    this package, and "split" raises."""
    if mode not in ("auto", "native", "split"):
        raise ValueError(f"Unknown complex mode {mode!r}")
    if mode == "split":
        raise NotImplementedError(
            "complex_mode('split') needs the JAX package's ComplexPair layer, "
            "which xrft_tpu_torch does not carry: complex data are native "
            "torch complex tensors on every device")
    yield


@contextmanager
def full_fp32():
    """float32 matrix products and cuDNN convolutions at full float32 grade
    (no TF32) inside the block; the caller's settings are restored on the
    way out.

    torch keeps one generic precision and one per backend (cuBLAS, oneDNN),
    which ``torch.backends.cuda.matmul.allow_tf32`` also writes.  Setting
    the generic one sets both backends, so restoring only the generic value
    would leave oneDNN at a value the caller never chose, and torch raises
    on its next check of a caller who then flips ``allow_tf32``.  Both
    backends are therefore restored as they were.  A generic value that
    torch itself refuses to read (the caller mixed the two APIs) is left as
    "highest".  cuDNN's convolutions run TF32 by default
    (``torch.backends.cudnn.conv.fp32_precision`` reads "tf32"); the block
    sets that one precision to "ieee" and restores its value, which is also
    what the legacy ``torch.backends.cudnn.allow_tf32`` reads and writes."""
    cuda, cpu = torch.backends.cuda.matmul, torch.backends.mkldnn.matmul
    conv = torch.backends.cudnn.conv
    backends = cuda.fp32_precision, cpu.fp32_precision, conv.fp32_precision
    try:
        generic = torch.get_float32_matmul_precision()
    except RuntimeError:
        generic = None
    torch.set_float32_matmul_precision("highest")
    conv.fp32_precision = "ieee"
    try:
        yield
    finally:
        if generic is not None:
            torch.set_float32_matmul_precision(generic)
        cuda.fp32_precision, cpu.fp32_precision, conv.fp32_precision = \
            backends


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
