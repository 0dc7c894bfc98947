"""The stacked matmul FFT engine (``config.fft_impl == "matmul"``).

Counterpart of ``xrft_tpu/ops/stacked_fft.py`` in its standard layout: every
DFT stage is ONE dense product over a host-built weight, with complex data
carried as a stacked real array (re/im as a length-2 axis ``c``) and the
weight ``W[c_in, j, c_out, k] = [[Re W, Im W], [-Im W, Re W]]``.  Lengths up
to ``config.direct_dft_max`` are one direct product; longer ones a four-step
chain over the radix plan of :func:`plan`, whose twiddle folds into the
next level's weight (batched over the previous digit).  Input ifftshifts
and output shifts are absorbed into the weights' rows and columns, the
one-sided rfft axis keeps only ``r // 2 + 1`` columns of its last digit, and
an inverse's 1/N folds into the last product.  One permute-and-reshape
restores natural order for all axes at the end.

The real-input level-0 product, ``W(2, k, j) x a`` over the first axis's
major digit, runs through :func:`_level0_dot`, the counterpart of
``_pallas_level0_dot``: K5a (:mod:`.dot`) on a float32 CUDA tensor, unpacked
or packed per ``config.level0_impl``, and its plain version on the CPU.
Every other product is ``torch.einsum`` at full float32 grade, as the JAX
package leaves them to ``lax.dot_general``.

Not carried: the raw layout (``raw=True``, ``pre_weights``,
``inter_axis_barrier``).  :func:`.matmul_fft.matmul_fft_nd` hands this
engine every request :func:`stacked_supported` accepts and runs the rest
(``irfft``, complex ``rfft``, a prime factor above ``direct_dft_max``, a
shift an odd outer radix cannot absorb) on the pair engine; called directly
with such a request, :func:`fft_nd_stacked` raises NotImplementedError
naming the reason.
"""

from __future__ import annotations

import math
from functools import lru_cache

import numpy as np
import torch

from ..config import LEVEL0_IMPLS, config, full_fp32
from . import dot as _dot
from .matmul_fft import _dft_matrix_np, _twiddle_np

__all__ = ["plan", "stacked_supported", "fft_nd_stacked"]

PACK_GROUPS = 4  # G of the packed level-0 layout (xrft_tpu's _pallas_level0_dot)


# --------------------------------------------------------------------------
# Radix planning (xrft_tpu/ops/stacked_fft.py:136-261)
# --------------------------------------------------------------------------


@lru_cache(maxsize=None)
def _largest_divisor(n: int, cap: int) -> int:
    best = 1
    d = 1
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
def _plan_naive(n: int, cap: int) -> tuple[int, ...] | None:
    """Greedy big-factor split, sorted ascending (big radix last)."""
    if n <= 1:
        return None
    if n <= cap:
        return (n,)
    radices = []
    rem = n
    while rem > cap:
        r = _largest_divisor(rem, cap)
        if r == 1:
            return None  # a prime factor > cap: Bluestein, not carried
        radices.append(r)
        rem //= r
    radices.append(rem)
    return tuple(sorted(radices))


@lru_cache(maxsize=None)
def plan(n: int, cap: int) -> tuple[int, ...] | None:
    """Radix plan [r0, ..., r_last]: r0 is contracted first (the major input
    digit, emitting the least-significant output digit), r_last is as large
    as possible.  A split with a digit under 16 is rebalanced to the
    same-depth factorisation with the largest smallest factor
    (1024 -> (32, 32))."""
    radices = _plan_naive(n, cap)
    if radices is None:
        return None
    if min(radices) < 16:
        bal = _balanced_factors(n, cap, len(radices))
        if bal is not None and min(bal) > min(radices):
            radices = bal
    return tuple(sorted(radices))


@lru_cache(maxsize=None)
def _balanced_factors(n: int, cap: int, levels: int) -> tuple | None:
    """Factor n into `levels` factors <= cap maximising the smallest."""
    if levels == 1:
        return (n,) if n <= cap else None
    target = round(n ** (1.0 / levels))
    best = None
    for d in sorted((d for d in range(2, cap + 1) if n % d == 0),
                    key=lambda d: abs(d - target)):
        rest = _balanced_factors(n // d, cap, levels - 1)
        if rest is None:
            continue
        cand = tuple(sorted((d,) + rest))
        if best is None or min(cand) > min(best):
            best = cand
            if min(best) >= target:
                break
    return best


def _shifts_absorbable(n: int, F: tuple[int, ...], pre: bool,
                       post: bool) -> bool:
    if len(F) == 1:
        return True  # full row/column permutations of the direct matrix
    if pre and F[0] % 2 != 0:
        return False
    if post and F[-1] % 2 != 0:
        return False
    return True


def _unsupported(shape, is_complex, axes, kind, pre_axes, post_axes):
    """Why this engine cannot run the request, or None."""
    if kind not in ("fft", "ifft", "rfft"):
        return f"the stacked engine has no {kind} (the pair engine runs it)"
    if kind == "rfft" and is_complex:
        return ("the stacked engine has no rfft of complex input (the pair "
                "engine runs it)")
    cap = config.direct_dft_max
    for a in axes:
        F = plan(shape[a], cap)
        if F is None:
            return (f"length {shape[a]} has a prime factor above "
                    f"direct_dft_max={cap} (the pair engine's Bluestein runs "
                    f"it)")
        if not _shifts_absorbable(shape[a], F, a in pre_axes, a in post_axes):
            return (f"length {shape[a]} plans as {F}, whose odd outer radix "
                    f"cannot absorb the requested shift (the pair engine "
                    f"runs it)")
    return None


def stacked_supported(x, axes, kind, pre_axes, post_axes) -> bool:
    """True when this engine can run the request."""
    axes = [a % x.ndim for a in axes]
    pre = {a % x.ndim for a in pre_axes}
    post = {a % x.ndim for a in post_axes}
    return _unsupported(tuple(x.shape), x.is_complex(), axes, kind, pre,
                        post) is None


# --------------------------------------------------------------------------
# Stacked weight factories (xrft_tpu/ops/stacked_fft.py:269-355)
# --------------------------------------------------------------------------


def _w_complex_np(r: int, sign: int, pre_roll: int = 0, post_roll: int = 0,
                  kcols: int | None = None, pre_perm: bool = False,
                  post_perm: str | None = None,
                  scale: float = 1.0) -> np.ndarray:
    """Dense complex DFT_r with absorbed shifts: ``pre_roll`` rolls the rows
    (an input ifftshift of a level-0 digit), ``post_roll`` the columns (an
    output shift of the last digit), ``pre_perm``/``post_perm`` are the full
    permutations of a direct plan; ``kcols`` keeps the leading columns (the
    one-sided rfft axis) and ``scale`` multiplies (an inverse's 1/N)."""
    w = _dft_matrix_np(r, sign).copy()
    if pre_perm:
        w = np.roll(w, r // 2, axis=0)
    elif pre_roll:
        w = np.roll(w, pre_roll, axis=0)
    if post_perm == "fftshift":
        w = np.roll(w, r // 2, axis=1)
    elif post_perm == "ifftshift":
        w = np.roll(w, -(r // 2), axis=1)
    elif post_roll:
        w = np.roll(w, post_roll, axis=1)
    if kcols is not None:
        w = w[:, :kcols]
    if scale != 1.0:
        w = w * scale
    return w


def _stack_lhs(wc: np.ndarray, real_in: bool, rdt) -> np.ndarray:
    """Weight for W-LHS products: (2, k, [ci,] j)."""
    wr = wc.real.astype(rdt).T  # (k, j)
    wi = wc.imag.astype(rdt).T
    if real_in:
        return np.stack([wr, wi], axis=0)  # (2, k, j)
    out = np.empty((2,) + wr.shape[:1] + (2,) + wr.shape[1:], rdt)
    out[0, :, 0, :] = wr
    out[0, :, 1, :] = -wi
    out[1, :, 0, :] = wi
    out[1, :, 1, :] = wr
    return out  # (co, k, ci, j)


def _batched_lhs(tw: np.ndarray, wc: np.ndarray, rdt) -> np.ndarray:
    """Final-level W-LHS with the folded twiddle: (kb, co, K, ci, m)."""
    wfull = tw[:, :, None] * wc[None, :, :]  # (kb, m, K)
    kb, m, K = wfull.shape
    out = np.empty((kb, 2, K, 2, m), rdt)
    wr = np.swapaxes(wfull.real, 1, 2).astype(rdt)  # (kb, K, m)
    wi = np.swapaxes(wfull.imag, 1, 2).astype(rdt)
    out[:, 0, :, 0, :] = wr
    out[:, 0, :, 1, :] = -wi
    out[:, 1, :, 0, :] = wi
    out[:, 1, :, 1, :] = wr
    return out


def _merged_rhs(wc: np.ndarray, rdt, tw: np.ndarray | None,
                real_in: bool) -> np.ndarray:
    """Final-product W-RHS with c-major-merged output columns: with twiddle
    (kb, ci, m, 2K); without, (ci, m, 2K), or (m, 2K) for real input."""
    if tw is not None:
        wfull = tw[:, :, None] * wc[None, :, :]  # (kb, m, K)
        kb, m, K = wfull.shape
        out = np.empty((kb, 2, m, 2 * K), rdt)
        out[:, 0, :, :K] = wfull.real
        out[:, 1, :, :K] = -wfull.imag
        out[:, 0, :, K:] = wfull.imag
        out[:, 1, :, K:] = wfull.real
        return out
    m, K = wc.shape
    if real_in:
        out = np.empty((m, 2 * K), rdt)
        out[:, :K] = wc.real
        out[:, K:] = wc.imag
        return out
    out = np.empty((2, m, 2 * K), rdt)
    out[0, :, :K] = wc.real
    out[1, :, :K] = -wc.imag
    out[0, :, K:] = wc.imag
    out[1, :, K:] = wc.real
    return out


def _build_weight(spec: tuple) -> np.ndarray:
    """The host weight a spec names: ("stack", wc, real_in, rdt),
    ("batched", tw, wc, rdt) or ("merged", wc, rdt, tw, real_in), with
    wc the arguments of :func:`_w_complex_np` and tw those of
    :func:`_twiddle_np` (or None)."""
    kind = spec[0]
    if kind == "stack":
        _, wc, real_in, rdt = spec
        return _stack_lhs(_w_complex_np(*wc), real_in, np.dtype(rdt))
    if kind == "batched":
        _, tw, wc, rdt = spec
        return _batched_lhs(_twiddle_np(*tw), _w_complex_np(*wc),
                            np.dtype(rdt))
    _, wc, rdt, tw, real_in = spec
    return _merged_rhs(_w_complex_np(*wc), np.dtype(rdt),
                       None if tw is None else _twiddle_np(*tw), real_in)


@lru_cache(maxsize=64)
def _weight(spec: tuple, device: torch.device) -> torch.Tensor:
    """A weight on ``device``, copied there once."""
    return torch.as_tensor(_build_weight(spec), device=device)


# --------------------------------------------------------------------------
# Products
# --------------------------------------------------------------------------

_LETTERS = "abcdefghijklmnopqrstuvwxyzABCDEFGHIJKLMNOPQRSTUVWXYZ"


def _dot_general(lhs, rhs, lc, rc, lb=(), rb=()):
    """``lax.dot_general``: contract lhs axes ``lc`` with rhs axes ``rc``,
    batch ``lb`` with ``rb``; the result's axes are the batch axes, then
    lhs's free axes, then rhs's, each in order."""
    ls = list(_LETTERS[:lhs.ndim])
    rs = [None] * rhs.ndim
    for i, j in zip(tuple(lc) + tuple(lb), tuple(rc) + tuple(rb)):
        rs[j] = ls[i]
    nxt = lhs.ndim
    for j in range(rhs.ndim):
        if rs[j] is None:
            rs[j] = _LETTERS[nxt]
            nxt += 1
    out = ([ls[i] for i in lb]
           + [ls[i] for i in range(lhs.ndim) if i not in lc and i not in lb]
           + [rs[j] for j in range(rhs.ndim) if j not in rc and j not in rb])
    with full_fp32():
        return torch.einsum(f"{''.join(ls)},{''.join(rs)}->{''.join(out)}",
                            lhs, rhs)


def _level0_dot(a: torch.Tensor, wl: torch.Tensor, jp: int) -> torch.Tensor:
    """The real-input level-0 product ``W(2, k, j) x a`` contracting axis
    ``jp``, as a ``(2, k, *rest)`` array (the counterpart of
    ``xrft_tpu/ops/stacked_fft.py::_pallas_level0_dot``).

    float32 data go through K5a (:func:`.dot.dot`): "unpacked" reads ``a``
    as (P, j, Q) through its strides; "packed" stacks G=4 column blocks
    along j (an input relayout), multiplies by the block-diagonal weight
    and restores the column order (an output relayout).  A column count
    that G does not divide runs unpacked.  float64 data, which K5a does not
    take, use the plain product, as the JAX package's ``lax.dot_general``."""
    impl = config.level0_impl
    if impl not in LEVEL0_IMPLS:
        raise ValueError(f"unknown level0_impl {impl!r}; expected one of "
                         f"{LEVEL0_IMPLS}")
    two, k, j = wl.shape
    rest = [s for q, s in enumerate(a.shape) if q != jp]
    if a.dtype != torch.float32:
        return _dot_general(wl, a, (2,), (jp,))
    P, Q = math.prod(a.shape[:jp]), math.prod(a.shape[jp + 1:])
    a3 = a.reshape(P, j, Q)
    w2 = wl.reshape(two * k, j)
    cols = P * Q
    G = PACK_GROUPS
    if impl == "packed" and cols % G == 0:
        cg = cols // G
        x2 = a3.movedim(1, 0).reshape(j, G, cg).transpose(0, 1) \
            .reshape(G * j, cg)
        o = _dot.dot(_dot.pack_block_diag(w2, G), x2)  # (G*2k, cg)
        o = o.reshape(G, two, k, cg).movedim(0, 2)
        return o.reshape(two, k, *rest)
    return _dot.dot(w2, a3).reshape(two, k, *rest)


def _twiddle_mul(a, tw, dims, ax, lvl, F):
    """Explicit twiddle pass of a 3+-level plan (see the JAX engine's
    ``_twiddle_mul``)."""
    cp = dims.index(_C)

    def adj(q):
        return q - (1 if cp < q else 0)

    bshape = [1] * (a.ndim - 1)
    bshape[adj(dims.index(_dig(ax, lvl)))] = tw.shape[0]
    for l2 in range(lvl + 1, len(F)):
        bshape[adj(dims.index(_in(ax, l2)))] = F[l2]
    t = tw.reshape((tw.shape[0],) + tuple(F[lvl + 1:]))
    twr = torch.as_tensor(t.real.reshape(bshape), dtype=a.dtype,
                          device=a.device)
    twi = torch.as_tensor(t.imag.reshape(bshape), dtype=a.dtype,
                          device=a.device)
    re, im = a.select(cp, 0), a.select(cp, 1)
    return torch.stack([re * twr - im * twi, re * twi + im * twr], dim=cp)


# --------------------------------------------------------------------------
# The engine (xrft_tpu/ops/stacked_fft.py:482-826, standard layout)
# --------------------------------------------------------------------------

_C = ("c",)   # the stacked complex plane axis (size 2)


def _orig(i):
    return ("orig", i)


def _dig(ax, lvl):
    return ("dig", ax, lvl)   # an emitted output digit


def _in(ax, lvl):
    return ("in", ax, lvl)    # a pre-split input digit (level 0 major)


def _ck(ax, lvl):
    return ("ck", ax, lvl)    # the merged (c, K) final axis


def fft_nd_stacked(x: torch.Tensor, axes, kind: str, pre_shift_axes=(),
                   post_shift_axes=(), post_kind: str = "fftshift"
                   ) -> torch.Tensor:
    """N-D ``fft``, ``ifft`` or ``rfft`` (real trailing axis, one-sided)
    over ``axes``, numpy's conventions, as a complex tensor on ``x``'s
    device; ``pre_shift_axes`` ifftshift the input and ``post_shift_axes``
    shift the output (``post_kind``).  Raises NotImplementedError for a
    request the engine cannot plan (:func:`.matmul_fft.matmul_fft_nd` gives
    those to the pair engine)."""
    ndim = x.ndim
    axes = [ax % ndim for ax in axes]
    pre_set = {ax % ndim for ax in pre_shift_axes}
    post_set = {ax % ndim for ax in post_shift_axes}
    in_shape = tuple(x.shape)
    reason = _unsupported(in_shape, x.is_complex(), axes, kind, pre_set,
                          post_set)
    if reason is not None:
        raise NotImplementedError(reason)
    if x.is_complex():
        a = torch.stack([x.real, x.imag], dim=0)     # c leading
        has_c = True
    else:
        if x.dtype not in (torch.float32, torch.float64):
            x = x.to(torch.float32)
        a = x
        has_c = False
    rdt = str(a.dtype).removeprefix("torch.")
    dev = a.device
    cap = config.direct_dft_max
    sign = -1 if kind in ("fft", "rfft") else +1

    # inverse normalisation: 1/N folds into the very last product's weight
    scale = 1.0
    if kind == "ifft":
        for ax in axes:
            scale /= in_shape[ax]

    # rfft: the real (trailing) axis first, pruned; the others after
    if kind == "rfft":
        if axes[-1] != ndim - 1 or axes[-1] in post_set:
            raise ValueError("rfft needs the real axis last, unshifted")
        order = [axes[-1]] + list(axes[:-1])
        prune_axis = axes[-1]
    else:
        order = list(axes)
        prune_axis = None
    axplan = {ax: plan(in_shape[ax], cap) for ax in order}

    dims: list = ([_C] if has_c else []) + [_orig(i) for i in range(ndim)]
    # split every transform axis into its digits in one reshape (row-major,
    # level-0 digit major)
    new_dims, new_shape = [], []
    for q, tok in enumerate(dims):
        if tok != _C and tok[1] in order:
            for lvl, r in enumerate(axplan[tok[1]]):
                new_dims.append(_in(tok[1], lvl))
                new_shape.append(r)
        else:
            new_dims.append(tok)
            new_shape.append(a.shape[q])
    dims = new_dims
    a = a.reshape(new_shape)

    total_dots = sum(len(axplan[ax]) for ax in order)
    dot_i = 0
    for ax in order:
        F = axplan[ax]
        L = len(F)
        pre, post = ax in pre_set, ax in post_set
        prev_dig = None    # the digit batching the axis's final product
        pending_tw = None  # the twiddle deferred into that product
        for lvl, r in enumerate(F):
            dot_i += 1
            final_overall = dot_i == total_dots
            p = dims.index(_in(ax, lvl))
            if lvl < L - 1:
                s = math.prod(F[lvl + 1:])
                pre_roll = (r // 2) if (pre and lvl == 0) else 0
                wc = (r, sign, pre_roll)
                if has_c:
                    wj = _weight(("stack", wc, False, rdt), dev)
                    cp = dims.index(_C)
                    a = _dot_general(wj, a, (2, 3), (cp, p))
                    rest = [d for q, d in enumerate(dims) if q not in (cp, p)]
                else:
                    wj = _weight(("stack", wc, True, rdt), dev)
                    a = _level0_dot(a, wj, p)
                    rest = [d for q, d in enumerate(dims) if q != p]
                    has_c = True
                dims = [_C, _dig(ax, lvl)] + rest
                if lvl == L - 2:
                    pending_tw = (r, s, sign)
                    prev_dig = _dig(ax, lvl)
                else:
                    a = _twiddle_mul(a, _twiddle_np(r, s, sign), dims, ax,
                                     lvl, F)
                continue
            # the axis's final level: contract the last digit, the twiddle
            # folded in by batching over the previous digit
            kcols = r // 2 + 1 if ax == prune_axis else None
            post_perm, post_roll = None, 0
            if post:
                if L == 1:
                    post_perm = post_kind
                else:
                    post_roll = (r // 2) if post_kind == "fftshift" \
                        else -(r // 2)
            wc = (r, sign, 0, post_roll, kcols, pre and L == 1, post_perm,
                  scale if final_overall else 1.0)
            if final_overall:
                wm = _weight(("merged", wc, rdt, pending_tw, not has_c), dev)
                if pending_tw is not None:
                    bq, cp = dims.index(prev_dig), dims.index(_C)
                    a = _dot_general(a, wm, (cp, p), (1, 2), (bq,), (0,))
                    rest = [d for q, d in enumerate(dims)
                            if q not in (bq, cp, p)]
                    dims = [prev_dig] + rest + [_ck(ax, lvl)]
                elif has_c:
                    cp = dims.index(_C)
                    a = _dot_general(a, wm, (cp, p), (0, 1))
                    rest = [d for q, d in enumerate(dims) if q not in (cp, p)]
                    dims = rest + [_ck(ax, lvl)]
                else:
                    a = _dot_general(a, wm, (p,), (0,))
                    rest = [d for q, d in enumerate(dims) if q != p]
                    dims = rest + [_ck(ax, lvl)]
                    has_c = True
            elif pending_tw is not None:
                wj = _weight(("batched", pending_tw, wc, rdt), dev)
                bq, cp = dims.index(prev_dig), dims.index(_C)
                a = _dot_general(wj, a, (3, 4), (cp, p), (0,), (bq,))
                rest = [d for q, d in enumerate(dims) if q not in (bq, cp, p)]
                dims = [prev_dig, _C, _dig(ax, lvl)] + rest
            else:
                wj = _weight(("stack", wc, not has_c, rdt), dev)
                if has_c:
                    cp = dims.index(_C)
                    a = _dot_general(wj, a, (2, 3), (cp, p))
                    rest = [d for q, d in enumerate(dims) if q not in (cp, p)]
                else:
                    a = _dot_general(wj, a, (2,), (p,))
                    rest = [d for q, d in enumerate(dims) if q != p]
                    has_c = True
                dims = [_C, _dig(ax, lvl)] + rest

    # epilogue: ONE permute-and-reshape puts every axis's digits in
    # most-significant-first order, the merged (c, K) slot leading the last
    # transformed axis's group, so the refill splits the c plane out
    last_ax = order[-1]
    ck_pos = dims.index(_ck(last_ax, len(axplan[last_ax]) - 1))
    perm, new_sizes, out_pos = [], [], {}
    c_axis = None
    for i in range(ndim):
        if i in order:
            F = axplan[i]
            if i == last_ax:
                c_axis = len(new_sizes)
                new_sizes.append(2)
                digs = [ck_pos] + [dims.index(_dig(i, lvl))
                                   for lvl in reversed(range(len(F) - 1))]
            else:
                digs = [dims.index(_dig(i, lvl))
                        for lvl in reversed(range(len(F)))]
            perm.extend(digs)
            size = math.prod(a.shape[q] for q in digs)
            if i == last_ax:
                size //= 2
            out_pos[i] = len(new_sizes)
            new_sizes.append(size)
        else:
            q = dims.index(_orig(i))
            perm.append(q)
            out_pos[i] = len(new_sizes)
            new_sizes.append(a.shape[q])
    a = a.permute(perm).reshape(new_sizes)
    if prune_axis is not None:
        a = a.narrow(out_pos[prune_axis], 0, in_shape[prune_axis] // 2 + 1)
    return torch.complex(a.select(c_axis, 0), a.select(c_axis, 1))
