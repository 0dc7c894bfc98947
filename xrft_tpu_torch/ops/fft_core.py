"""N-D FFT primitives, dispatched on ``config.fft_impl``.

Counterpart of ``xrft_tpu/ops/fft_core.py:62-133``.  Both implementations
follow numpy's convention (unnormalised forward), so every scaling rule
downstream is implementation-independent:

  * ``"torch"``  - ``torch.fft`` (cuFFT on a CUDA device), the counterpart of
                   the JAX package's XLA FFT on a GPU.
  * ``"kernel"`` - the four-step kernel K2 (:mod:`.fft_fourstep`), one launch
                   per transformed axis: the axis is moved last and made
                   contiguous, transformed, and moved back.  float32 only;
                   an unsupported dtype or length raises ValueError.

``pre_shift_axes`` ifftshift the input and ``post_shift_axes`` fftshift the
output, as in the JAX package's engines.
"""

from __future__ import annotations

import torch

from ..config import FFT_IMPLS, config
from .fft_fourstep import fft_last

__all__ = ["fftn", "rfftn", "fftshift", "ifftshift"]


def _impl() -> str:
    impl = config.fft_impl
    if impl not in FFT_IMPLS:
        raise ValueError(f"unknown fft_impl {impl!r}; expected one of "
                         f"{FFT_IMPLS}")
    return impl


def _kernel_axis(x: torch.Tensor, axis: int) -> torch.Tensor:
    return fft_last(x.movedim(axis, -1).contiguous(), -1).movedim(-1, axis)


def _norm(axes, ndim):
    return [a % ndim for a in ([axes] if isinstance(axes, int) else axes)]


def fftn(x: torch.Tensor, axes, pre_shift_axes=(), post_shift_axes=()):
    """Complex N-D FFT over ``axes``."""
    axes = _norm(axes, x.ndim)
    if pre_shift_axes:
        x = ifftshift(x, pre_shift_axes)
    if _impl() == "torch":
        out = torch.fft.fftn(x, dim=axes)
    else:
        out = x
        for a in reversed(axes):
            out = _kernel_axis(out, a)
    if post_shift_axes:
        out = fftshift(out, post_shift_axes)
    return out


def rfftn(x: torch.Tensor, axes, pre_shift_axes=(), post_shift_axes=()):
    """Real N-D FFT; the half-spectrum axis is ``axes[-1]``, which keeps
    ``n//2 + 1`` columns."""
    axes = _norm(axes, x.ndim)
    if pre_shift_axes:
        x = ifftshift(x, pre_shift_axes)
    if _impl() == "torch":
        out = torch.fft.rfftn(x, dim=axes)
    else:
        last = axes[-1]
        out = _kernel_axis(x, last).narrow(last, 0, x.shape[last] // 2 + 1)
        for a in reversed(axes[:-1]):
            out = _kernel_axis(out, a)
    if post_shift_axes:
        out = fftshift(out, post_shift_axes)
    return out


def fftshift(x: torch.Tensor, axes):
    return torch.fft.fftshift(x, dim=_norm(axes, x.ndim))


def ifftshift(x: torch.Tensor, axes):
    return torch.fft.ifftshift(x, dim=_norm(axes, x.ndim))
