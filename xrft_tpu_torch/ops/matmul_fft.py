"""The matmul FFT engine (``config.fft_impl == "matmul"``): the stacked
engine first, the pair engine for the rest.

Counterpart of ``xrft_tpu/ops/matmul_fft.py``.  :func:`matmul_fft_nd` hands
every request the stacked engine (:mod:`.stacked_fft`) can plan to it, as
the JAX engine does, and runs the rest here, one axis at a time, on native
complex tensors (the JAX package's ``ComplexPair`` is TPU-only):

  * n <= ``direct_dft_max``    : one dense DFT product (two real products
                                 for real input, one complex product else).
  * n = n1 * n2 (n1 <= cap)    : the four-step recursion: the DFT over the
                                 largest divisor n1 <= ``direct_dft_max``,
                                 the twiddle, then the length-n2 transform,
                                 fused with the output transpose when n2 is
                                 a direct length.
  * no divisor <= cap          : Bluestein's chirp-z: two power-of-two
                                 transforms of length m >= 2n - 1 and the
                                 chirp spectrum precomputed on the host.

Where a level asks for no shift, its data are float32/complex64 and K2
(:mod:`.fft_fourstep`) takes the length (n >= 256 with a factor pair
<= 256), the level is one K2 call instead, as the JAX engine takes
``pallas_fft_last``: the kernel on the card, its plain version on the CPU.
Real input of even length takes the packed rfft (one complex transform of
half the length); ``irfft`` the packed half-length inverse, which zeroes the
imaginary parts of the DC and Nyquist columns as pocketfft does.  Input
ifftshifts and output shifts are absorbed into the host matrices where the
factor parity allows, explicit rolls otherwise.  float64 data stay
complex128 products throughout.

Every constant is built on the host in float64 with exact integer modular
angles, rounded once to the data's dtype and copied to its device once.
The products are ``torch.einsum`` at full float32 grade
(``config.full_fp32``), as the JAX package leaves them to ``jnp.einsum``.
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch

from ..config import config, full_fp32
from . import fft_fourstep

__all__ = ["fft_last", "matmul_fft_nd"]

_FP64 = (torch.float64, torch.complex128)


# --------------------------------------------------------------------------
# Host constants (exact modular angles, float64 trig):
# xrft_tpu/ops/matmul_fft.py:65-143,287-291
# --------------------------------------------------------------------------


@lru_cache(maxsize=None)
def _dft_matrix_np(n: int, sign: int, pre: bool = False,
                   post: str | None = None) -> np.ndarray:
    """Dense DFT matrix W[j,k] = exp(sign*2*pi*i*j*k/n), complex128.

    ``pre`` bakes an input ifftshift into the rows and ``post``
    ('fftshift' | 'ifftshift') an output shift into the columns."""
    j = np.arange(n, dtype=np.int64)
    jk = np.mod(np.outer(j, j), n)
    ang = (2.0 * np.pi * sign / n) * jk
    w = np.cos(ang) + 1j * np.sin(ang)
    if pre:
        # x' = ifftshift(x): sum_j x'[j] W[j,k] = sum_i x[i] W[pinv[i],k]
        # with pinv the fftshift permutation
        w = w[np.fft.fftshift(np.arange(n)), :]
    if post == "fftshift":
        w = w[:, np.fft.fftshift(np.arange(n))]
    elif post == "ifftshift":
        w = w[:, np.fft.ifftshift(np.arange(n))]
    return w


@lru_cache(maxsize=None)
def _twiddle_np(n1: int, n2: int, sign: int) -> np.ndarray:
    """Four-step twiddle T[k1,m2] = exp(sign*2*pi*i*k1*m2/(n1*n2))."""
    n = n1 * n2
    k1 = np.arange(n1, dtype=np.int64)
    m2 = np.arange(n2, dtype=np.int64)
    prod = np.mod(np.outer(k1, m2), n)
    ang = (2.0 * np.pi * sign / n) * prod
    return np.cos(ang) + 1j * np.sin(ang)


@lru_cache(maxsize=None)
def _chirp_np(n: int, sign: int) -> np.ndarray:
    """Bluestein chirp c[j] = exp(sign*pi*i*j^2/n) with exact (j^2 mod 2n)."""
    j = np.arange(n, dtype=np.int64)
    sq = np.mod(j * j, 2 * n)
    ang = (np.pi * sign / n) * sq
    return np.cos(ang) + 1j * np.sin(ang)


@lru_cache(maxsize=None)
def _bluestein_plan(n: int, sign: int):
    """(m, chirp, chirp_spectrum): m is the least power of two >= 2n - 1;
    the wrapped conjugate chirp's spectrum comes from numpy's float64 FFT."""
    m = 1
    while m < 2 * n - 1:
        m *= 2
    c = _chirp_np(n, sign)
    v = np.zeros(m, dtype=np.complex128)
    v[:n] = np.conj(c)
    v[m - n + 1:] = np.conj(c[1:][::-1])
    return m, c, np.fft.fft(v)


def _chirp_spectrum_np(n: int, sign: int) -> np.ndarray:
    return _bluestein_plan(n, sign)[2]


@lru_cache(maxsize=None)
def _largest_small_divisor(n: int, cap: int) -> int:
    """Largest divisor of n that is <= cap (1 if none beyond the trivial)."""
    best = 1
    d = 2
    while d * d <= n:
        if n % d == 0:
            if d <= cap and d > best:
                best = d
            q = n // d
            if q <= cap and q > best:
                best = q
        d += 1
    return best


@lru_cache(maxsize=None)
def _pack_twiddle_np(n: int) -> np.ndarray:
    """w^k = exp(-2*pi*i*k/n) for k = 0..n/2-1 (the rfft untangle)."""
    k = np.arange(n // 2, dtype=np.int64)
    ang = (-2.0 * np.pi / n) * k
    return np.cos(ang) + 1j * np.sin(ang)


@lru_cache(maxsize=256)
def _const(factory, args: tuple, part: str | None, rdtype: torch.dtype,
           device: torch.device) -> torch.Tensor:
    """``factory(*args)`` rounded once to ``rdtype``'s complex type (``part``
    None or "conj") or to ``rdtype`` ("re", "im"), on ``device``, copied there
    once."""
    w = factory(*args)
    if part == "re":
        w = w.real
    elif part == "im":
        w = w.imag
    elif part == "conj":
        w = np.conj(w)
    dt = rdtype if part in ("re", "im") else _complex_of(rdtype)
    return torch.as_tensor(np.ascontiguousarray(w), device=device).to(dt)


# --------------------------------------------------------------------------
# Device side
# --------------------------------------------------------------------------


def _rdtype(x: torch.Tensor) -> torch.dtype:
    return torch.float64 if x.dtype in _FP64 else torch.float32


def _complex_of(rdtype: torch.dtype) -> torch.dtype:
    return torch.complex128 if rdtype == torch.float64 else torch.complex64


def _apply_dft(x: torch.Tensor, wkey: tuple, contract_axis: int,
               out_swapped: bool = False) -> torch.Tensor:
    """Contract x along ``contract_axis`` (-1 or -2) with the DFT matrix
    ``_dft_matrix_np(*wkey)``: two real products for real input, one complex
    product otherwise.  ``out_swapped`` (contracting -1 of a (..., m, j)
    input) emits the last two axes swapped: (..., k, m)."""
    if out_swapped:
        eq = "...mj,jk->...km"
    else:
        eq = "...j,jk->...k" if contract_axis == -1 else "...jm,jk->...km"
    rdt, dev = _rdtype(x), x.device
    with full_fp32():
        if not x.is_complex():
            xr = x.to(rdt)
            return torch.complex(
                torch.einsum(eq, xr, _const(_dft_matrix_np, wkey, "re", rdt,
                                            dev)),
                torch.einsum(eq, xr, _const(_dft_matrix_np, wkey, "im", rdt,
                                            dev)))
        return torch.einsum(eq, x, _const(_dft_matrix_np, wkey, None, rdt,
                                          dev))


def _as_complex(x: torch.Tensor) -> torch.Tensor:
    if x.is_complex():
        return x
    return x.to(_complex_of(_rdtype(x)))


def _post_roll_amount(n: int, post: str) -> int:
    return n // 2 if post == "fftshift" else -(n // 2)


def _k2_takes(n: int, x: torch.Tensor) -> bool:
    """True when K2 runs a length-n transform of ``x``'s dtype."""
    try:
        fft_fourstep.check_supported(n, x.dtype)
    except ValueError:
        return False
    return True


def fft_last(x: torch.Tensor, sign: int = -1, pre_shift: bool = False,
             post_shift: str | bool | None = None) -> torch.Tensor:
    """Unnormalised DFT along the last axis of a real or complex tensor, any
    length, as a complex tensor of the data's grade.  ``sign=-1`` is the
    forward transform, ``+1`` the unnormalised inverse.  ``pre_shift``
    applies an input ifftshift, ``post_shift`` ('fftshift' | 'ifftshift',
    or True for 'fftshift') an output shift."""
    if post_shift is True:
        post_shift = "fftshift"
    if not x.is_complex() and x.dtype not in (torch.float32, torch.float64):
        x = x.to(torch.float32)
    return _fft_last_impl(x, x.shape[-1], sign, pre_shift, post_shift or None)


def _fft_last_impl(x, n, sign, pre=False, post=None) -> torch.Tensor:
    if n == 1:
        return _as_complex(x)
    if n <= config.direct_dft_max:
        return _apply_dft(x, (n, sign, pre, post), -1)
    if not pre and not post and _k2_takes(n, x):
        return fft_fourstep.fft_last(x.contiguous(), sign)
    return _split_last(x, n, sign, pre, post)


def _split_last(x, n, sign, pre=False, post=None) -> torch.Tensor:
    """The einsum recursion of one level: Bluestein when n has no divisor
    <= ``direct_dft_max``, else the DFT over the largest such divisor n1,
    the twiddle and the length-n/n1 transform.  Shifts are absorbed where
    the factor parity allows (input ifftshift: n1 even; output shift: n2
    even), explicit rolls otherwise."""
    n1 = _largest_small_divisor(n, config.direct_dft_max)
    if n1 == 1:
        if pre:
            x = torch.roll(x, -(n // 2), dims=-1)
        out = _bluestein_last(x, n, sign)
        if post:
            out = torch.roll(out, _post_roll_amount(n, post), dims=-1)
        return out
    n2 = n // n1
    pre1 = pre and n1 % 2 == 0
    post2 = post if (post and n2 % 2 == 0) else None
    if pre and not pre1:
        x = torch.roll(x, -(n // 2), dims=-1)
    shape = x.shape
    # DFT over the n1 axis (-2): B[k1, m2] = sum_j A[j, m2] W[j, k1]
    a = _apply_dft(x.reshape(shape[:-1] + (n1, n2)), (n1, sign, pre1, None),
                   -2)
    a = a * _const(_twiddle_np, (n1, n2, sign), None, _rdtype(a), a.device)
    if n2 <= config.direct_dft_max:
        # the tail DFT emits the (k2, k1) layout directly
        a = _apply_dft(a, (n2, sign, False, post2), -1, out_swapped=True)
    else:
        # X[k1 + n1*k2] = D[k1, k2]: swap so flattening gives k2*n1 + k1
        a = _fft_last_impl(a, n2, sign, False, post2).transpose(-1, -2)
    out = a.reshape(shape[:-1] + (n,))
    if post and not post2:
        out = torch.roll(out, _post_roll_amount(n, post), dims=-1)
    return out


def _bluestein_last(x, n, sign) -> torch.Tensor:
    """Bluestein's chirp-z along the last axis: chirp, zero-pad to m, the
    length-m forward transform, the chirp spectrum, the length-m inverse,
    1/m, crop and chirp."""
    m = _bluestein_plan(n, sign)[0]
    rdt, dev = _rdtype(x), x.device
    c = _const(_chirp_np, (n, sign), None, rdt, dev)
    u = torch.nn.functional.pad(c * x, (0, m - n))
    U = _fft_last_impl(u, m, -1)
    V = _const(_chirp_spectrum_np, (n, sign), None, rdt, dev)
    conv = _fft_last_impl(U * V, m, +1) * (1.0 / m)
    return c * conv[..., :n]


def _rfft_packed_last(x: torch.Tensor, n: int) -> torch.Tensor:
    """rfft of real x (last axis, even n) by the even/odd packing:

        z = x[0::2] + i x[1::2];  Z = FFT_{n/2}(z)
        E = (Z + conj(Z[-k]))/2,  O = -i (Z - conj(Z[-k]))/2
        X[k] = E[k] + w^k O[k] (k < n/2),  X[n/2] = E[0] - O[0]
    """
    rdt = _rdtype(x)
    m = n // 2
    z = torch.complex(x[..., 0::2].to(rdt), x[..., 1::2].to(rdt))
    Z = _fft_last_impl(z, m, -1)
    Zc = torch.roll(Z.flip(-1), 1, dims=-1).conj()   # conj(Z[(-k) % m])
    E = (Z + Zc) * 0.5
    Od = (Z - Zc) * 0.5                                # = i * O
    O = torch.complex(Od.imag, -Od.real)               # times -i
    head = E + _const(_pack_twiddle_np, (n,), None, rdt, x.device) * O
    return torch.cat([head, E[..., :1] - O[..., :1]], dim=-1)


def _irfft_packed_last(X: torch.Tensor, n: int,
                       post_roll: bool = False) -> torch.Tensor:
    """irfft of a one-sided spectrum X (last axis, m + 1 = n/2 + 1 columns)
    by the inverse even/odd packing, the dual of :func:`_rfft_packed_last`:

        E[k] = (X[k] + conj(X[m-k]))/2
        O[k] = (X[k] - conj(X[m-k]))/2 * w^{-k}   (w = exp(-2*pi*i/n))
        z    = IFFT_m(E + i O);  x[2j] = Re z[j], x[2j+1] = Im z[j]

    The imaginary parts of the DC and Nyquist columns are dropped first, as
    pocketfft's c2r (``np.fft.irfft``) ignores them.  ``post_roll`` emits the
    fftshift of the real output (an n/2 roll) as an m/2 roll of z, valid
    only when n % 4 == 0, which the caller checks."""
    from . import stacked_fft

    m = n // 2
    rdt = _rdtype(X)
    Xh = X[..., :m]
    Xr = X[..., 1:m + 1].flip(-1)
    mask = torch.ones(m, dtype=rdt, device=X.device)
    mask[0] = 0.0
    hr, hi = Xh.real, Xh.imag * mask
    rr, ri = Xr.real, Xr.imag * mask
    E = torch.complex((hr + rr) * 0.5, (hi - ri) * 0.5)
    Ow = torch.complex((hr - rr) * 0.5, (hi + ri) * 0.5)
    O = _const(_pack_twiddle_np, (n,), "conj", rdt, X.device) * Ow
    Z = torch.complex(E.real - O.imag, E.imag + O.real)
    last = Z.ndim - 1
    post_axes = {last} if post_roll else set()
    if stacked_fft.stacked_supported(Z, [last], "ifft", set(), post_axes):
        z = stacked_fft.fft_nd_stacked(Z, [last], "ifft", (),
                                       tuple(post_axes), "fftshift")
    else:
        z = _fft_last_impl(Z, m, +1) * (1.0 / m)
        if post_roll:
            z = torch.fft.fftshift(z, dim=-1)
    # interleave: x[2j] = Re z[j], x[2j+1] = Im z[j]
    return torch.view_as_real(z).reshape(z.shape[:-1] + (n,))


def _transform_axis(x, axis, sign, pre=False, post=None) -> torch.Tensor:
    if axis == x.ndim - 1:
        return fft_last(x, sign, pre, post)
    return fft_last(x.movedim(axis, -1), sign, pre, post).movedim(-1, axis)


def matmul_fft_nd(x: torch.Tensor, axes, kind: str, pre_shift_axes=(),
                  post_shift_axes=(), post_kind: str = "fftshift"
                  ) -> torch.Tensor:
    """N-D FFT of ``kind`` ('fft' | 'ifft' | 'rfft' | 'irfft') over ``axes``
    by the matmul engines, numpy's conventions: a complex tensor for the
    complex kinds and rfft, a real one for irfft.  For the real kinds the
    real axis is ``axes[-1]`` and the last axis of ``x``.  The stacked engine
    takes the request whenever it can plan it; the pair engine the rest."""
    from . import stacked_fft

    ndim = x.ndim
    axes = [a % ndim for a in axes]
    pre_shift_axes = {a % ndim for a in pre_shift_axes}
    post_shift_axes = {a % ndim for a in post_shift_axes}

    if axes and stacked_fft.stacked_supported(
            x, axes, kind, pre_shift_axes, post_shift_axes):
        return stacked_fft.fft_nd_stacked(
            x, axes, kind, pre_shift_axes, post_shift_axes, post_kind)

    def post_of(a):
        return post_kind if a in post_shift_axes else None

    if kind in ("fft", "ifft"):
        sign = -1 if kind == "fft" else +1
        out = x
        for a in axes:
            out = _transform_axis(out, a, sign, a in pre_shift_axes,
                                  post_of(a))
        if kind == "fft":
            return _as_complex(out)
        scale = 1.0
        for a in axes:
            scale *= x.shape[a]
        return out * (1.0 / scale)
    if kind == "rfft":
        if axes[-1] != ndim - 1:
            raise ValueError("rfft axis must be the last axis")
        n = x.shape[-1]
        pre_last = axes[-1] in pre_shift_axes
        if n % 2 == 0 and not x.is_complex():
            # even/odd packing: one complex FFT of length n/2 and an
            # elementwise untangle
            if x.dtype not in (torch.float32, torch.float64):
                x = x.to(torch.float32)
            if pre_last:
                x = torch.roll(x, -(n // 2), dims=-1)
            out = _rfft_packed_last(x, n)
        else:
            out = fft_last(x, -1, pre_last, None)[..., : n // 2 + 1]
        for a in axes[:-1]:
            out = _transform_axis(out, a, -1, a in pre_shift_axes,
                                  post_of(a))
        return out
    if kind == "irfft":
        if axes[-1] != ndim - 1:
            raise ValueError("irfft axis must be the last axis")
        if ndim - 1 in pre_shift_axes:
            raise ValueError(
                "input ifftshift on the one-sided real axis is undefined")
        mm = x.shape[-1]
        if mm < 2:
            raise ValueError(f"irfftn needs a half-spectrum axis of length "
                             f">= 2, got {mm}")
        n = 2 * (mm - 1)
        out = _as_complex(x)
        # the non-real axes first, on the half spectrum (stacked if it can
        # plan them), then the packed half-length inverse of the real axis,
        # whose output shift is an m/2 roll of z when n % 4 == 0
        scale = 1.0
        if axes[:-1]:
            pre_nr = {a for a in axes[:-1] if a in pre_shift_axes}
            post_nr = {a for a in axes[:-1] if a in post_shift_axes}
            if stacked_fft.stacked_supported(out, axes[:-1], "ifft",
                                             pre_nr, post_nr):
                out = stacked_fft.fft_nd_stacked(
                    out, axes[:-1], "ifft", tuple(pre_nr), tuple(post_nr),
                    post_kind)
            else:
                for a in axes[:-1]:
                    out = _transform_axis(out, a, +1, a in pre_nr,
                                          post_of(a))
                    scale *= x.shape[a]
        post_real = (ndim - 1) in post_shift_axes
        absorb_real = post_real and n % 4 == 0
        res = _irfft_packed_last(out, n, post_roll=absorb_real)
        if post_real and not absorb_real:
            res = (torch.fft.fftshift if post_kind == "fftshift"
                   else torch.fft.ifftshift)(res, dim=ndim - 1)
        return res * (1.0 / scale) if scale != 1.0 else res
    raise ValueError(f"unknown kind {kind!r}")
