"""N-D FFT primitives, dispatched on ``config.fft_impl``.

Counterpart of ``xrft_tpu/ops/fft_core.py:62-133``.  Both implementations
follow numpy's convention (unnormalised forward, 1/n inverse), so every
scaling rule downstream is implementation-independent:

  * ``"torch"``  - ``torch.fft`` (cuFFT on a CUDA device), the counterpart of
                   the JAX package's XLA FFT on a GPU.
  * ``"kernel"`` - the hand-written kernels, by dtype: float32/complex64 data
                   run the four-step kernel K2 (:mod:`.fft_fourstep`), one
                   launch per transformed axis (the axis is moved last and
                   made contiguous, transformed, and moved back);
                   float64/complex128 data run the FP64 recursion with K4 as
                   its base case (:mod:`.dft64`).  The inverse is the sign +1
                   transform scaled by 1/n.  A dtype or length a kernel
                   cannot run raises; nothing is handed to torch.fft quietly.
  * ``"matmul"`` - the matmul engines (:mod:`.matmul_fft`), as the JAX
                   package's ``engine="matmul"``: the stacked engine
                   (:mod:`.stacked_fft`, its real-input level-0 product on
                   K5a, :mod:`.dot`) for every request it can plan, the pair
                   engine for the rest (``irfftn``, a prime factor above
                   ``direct_dft_max`` by Bluestein, a shift an odd radix
                   cannot absorb), with K2 on its four-step levels for
                   float32 data.  The shifts are absorbed into the engines'
                   weights where the factors allow.

Every transform takes its input's dtype as the JAX package's transforms
(``lax.fft``) do, whatever the route: a complex transform of integer, bool
or float16 data gives complex64 (complex128 for 64-bit integers), and
complex32 data are transformed in complex64; a real transform promotes
integer and bool data to float32 or float64 and raises for float16 and
complex data, with JAX's messages.  float32, float64, complex64 and
complex128 data reach the route as they are.

``pre_shift_axes`` ifftshift the input and ``post_shift_axes`` shift the
output (``post_kind`` "fftshift" or, for the inverses, "ifftshift"), as in
the JAX package's engines.
"""

from __future__ import annotations

import math

import torch

from .. import telemetry
from ..config import FFT_IMPLS, config
from ..dtypes import complex_dtype, promote
from .dft64 import fftn64
from .fft_fourstep import fft_last
from .matmul_fft import matmul_fft_nd

__all__ = ["fftn", "ifftn", "rfftn", "irfftn", "fftshift", "ifftshift"]

_FP64 = (torch.float64, torch.complex128)


def _impl() -> str:
    impl = config.fft_impl
    if impl not in FFT_IMPLS:
        raise ValueError(f"unknown fft_impl {impl!r}; expected one of "
                         f"{FFT_IMPLS}")
    return impl


def _kernel_fftn(x: torch.Tensor, axes, inverse=False) -> torch.Tensor:
    """The kernel route over ``axes``: the K4 recursion for float64 data,
    K2 one axis at a time otherwise; ``inverse`` takes sign +1 and 1/n."""
    if x.dtype in _FP64:
        return fftn64(x, axes, "ifft" if inverse else "fft")
    sign = 1 if inverse else -1
    out = x
    for a in reversed(axes):
        out = fft_last(out.movedim(a, -1).contiguous(), sign).movedim(-1, a)
    if inverse and axes:
        out = out * (1.0 / math.prod(x.shape[a] for a in axes))
    return out


def _input(x: torch.Tensor, real: bool) -> torch.Tensor:
    """``x`` in a dtype the transform takes: complex, float32 and float64
    data as they are (so real data keep the real-input modes of K2 and
    K5a); for a real transform (``real``), JAX's float promotion of the
    rest, which must give float32 or float64; for a complex one, integer
    and bool data in JAX's float (whose transform has JAX's complex dtype)
    and float16 and complex32 in complex64: no complex32 tensor reaches a
    route (cuFFT takes half precision only at powers of two, MKL, K2 and the
    matmul engines not at all)."""
    if x.dtype in (torch.float32, torch.float64, torch.complex64,
                   torch.complex128) and not (real and x.is_complex()):
        return x
    if not real:
        return x.to(complex_dtype(x.dtype)) if x.is_floating_point() \
            or x.is_complex() else promote(x)
    if x.is_complex():
        raise ValueError("only real valued inputs supported for rfft")
    x = promote(x)
    if x.dtype not in (torch.float32, torch.float64):
        raise ValueError("RFFT input must be float32 or float64, got "
                         f"{str(x.dtype).removeprefix('torch.')}")
    return x


def _norm(axes, ndim):
    return [a % ndim for a in ([axes] if isinstance(axes, int) else axes)]


def _post(out, post_shift_axes, post_kind):
    if not post_shift_axes:
        return out
    if post_kind == "fftshift":
        return fftshift(out, post_shift_axes)
    if post_kind == "ifftshift":
        return ifftshift(out, post_shift_axes)
    raise ValueError(f"unknown post_kind {post_kind!r}")


def fftn(x: torch.Tensor, axes, pre_shift_axes=(), post_shift_axes=()):
    """Complex N-D FFT over ``axes``.  ``x`` may come in a one-item list,
    taken out here, so that no caller's frame holds it (a traced call's
    frames keep their arguments until they return): real input, converted
    to complex below, then goes before cuFFT allocates (``transform.fft``
    hands over the hp path's float64 stack so)."""
    if isinstance(x, list):
        x = x.pop()
    x = _input(x, real=False)
    axes = _norm(axes, x.ndim)
    if _impl() == "matmul":
        return matmul_fft_nd(x, axes, "fft", pre_shift_axes,
                             post_shift_axes)
    if pre_shift_axes:
        x = ifftshift(x, pre_shift_axes)
    if _impl() == "torch":
        # torch.fft.fftn converts real input to complex itself; converted
        # here, the real data go first (see above)
        if not x.is_complex():
            x = x.to(complex_dtype(x.dtype))
        out = telemetry.cufft(torch.fft.fftn, x, dim=axes)
    else:
        out = _kernel_fftn(x, axes)
    del x                                   # before the shift allocates
    return _post(out, post_shift_axes, "fftshift")


def ifftn(x: torch.Tensor, axes, pre_shift_axes=(), post_shift_axes=(),
          post_kind="fftshift"):
    """Complex N-D inverse FFT over ``axes``, scaled by 1/prod(n)."""
    x = _input(x, real=False)
    axes = _norm(axes, x.ndim)
    if _impl() == "matmul":
        return matmul_fft_nd(x, axes, "ifft", pre_shift_axes,
                             post_shift_axes, post_kind)
    if pre_shift_axes:
        x = ifftshift(x, pre_shift_axes)
    if _impl() == "torch":
        out = telemetry.cufft(torch.fft.ifftn, x, dim=axes)
    else:
        out = _kernel_fftn(x, axes, inverse=True)
    return _post(out, post_shift_axes, post_kind)


def rfftn(x: torch.Tensor, axes, pre_shift_axes=(), post_shift_axes=()):
    """Real N-D FFT; the half-spectrum axis is ``axes[-1]``, which keeps
    ``n//2 + 1`` columns."""
    x = _input(x, real=True)
    axes = _norm(axes, x.ndim)
    if _impl() == "matmul":
        return matmul_fft_nd(x, axes, "rfft", pre_shift_axes,
                             post_shift_axes)
    if pre_shift_axes:
        x = ifftshift(x, pre_shift_axes)
    if _impl() == "torch":
        out = telemetry.cufft(torch.fft.rfftn, x, dim=axes)
    else:
        last = axes[-1]
        out = _kernel_fftn(x, [last]).narrow(last, 0, x.shape[last] // 2 + 1)
        out = _kernel_fftn(out, axes[:-1])
    return _post(out, post_shift_axes, "fftshift")


def irfftn(x: torch.Tensor, axes, pre_shift_axes=(), post_shift_axes=(),
           post_kind="fftshift"):
    """Inverse of :func:`rfftn`: the half-spectrum axis ``axes[-1]`` of
    length m gives ``n = 2*(m - 1)`` real outputs, as numpy's ``irfftn``.

    The kernel route inverts the other axes first, extends the last one to
    length n by Hermitian symmetry (``X[n - k] = conj(X[k])``), runs the
    sign +1 transform and keeps the real part, which drops any imaginary
    part at DC and Nyquist as numpy does.  ``"matmul"`` inverts the other
    axes (stacked where it can plan them), then runs the packed half-length
    inverse, which zeroes those imaginary parts first."""
    x = _input(x, real=False)
    axes = _norm(axes, x.ndim)
    if _impl() == "matmul":
        return matmul_fft_nd(x, axes, "irfft", pre_shift_axes,
                             post_shift_axes, post_kind)
    if pre_shift_axes:
        x = ifftshift(x, pre_shift_axes)
    if _impl() == "torch":
        out = telemetry.cufft(torch.fft.irfftn, x, dim=axes)
    else:
        last = axes[-1]
        m = x.shape[last]
        if m < 2:
            raise ValueError(f"irfftn needs a half-spectrum axis of length "
                             f">= 2, got {m}")
        half = _kernel_fftn(x, axes[:-1], inverse=True)
        mirror = half.narrow(last, 1, m - 2).flip(last).conj()
        full = torch.cat([half, mirror], dim=last)
        out = _kernel_fftn(full, [last], inverse=True).real
    return _post(out, post_shift_axes, post_kind)


def fftshift(x: torch.Tensor, axes):
    return torch.fft.fftshift(x, dim=_norm(axes, x.ndim))


def ifftshift(x: torch.Tensor, axes):
    return torch.fft.ifftshift(x, dim=_norm(axes, x.ndim))
