"""Host plans of the shared-memory Stockham FFT that kernels K2 and K4 run
(``csrc/stockham.cuh``), and a numpy replay of exactly those plans.

A plan of length ``n`` is the list of radices of ``n``, largest first: as
many 16s as the power of two allows, then one 8, 4 or 2 for the rest of
it, then the odd primes 3, 5, 7, 11 and 13, each a butterfly in
registers; a prime factor above 13 (251 in n = 251 or 1004) is one direct
stage of that prime over shared memory.  Stage ``s`` of radix ``R`` runs
after stages whose radices multiply to ``ns`` (its stride) and is, for
every group ``j`` in ``[0, n/R)`` with ``k = j mod ns``::

    v[r]  = src[j + r*n/R] * W_(ns*R)^(r*k)          r in [0, R)
    v     = DFT_R(v)
    dst[(j - k)*R + k + r*ns] = v[r]

with ``W_L^e = exp(sign*2*pi*i*e/L)``; after the last stage the output is
in natural frequency order.  The kernels compute nothing trigonometric:
every twiddle and every root of a butterfly is an entry of one host table
per (plan, sign), built here in float64 with the exponent reduced mod L in
integers (as ``dft64._table_np`` and ``fft_fourstep._tables_np`` build
theirs); K2 rounds it to complex64.

The plan reaches a kernel as a small int32 array (:func:`build`)::

    [n, sign, passes, inter, table_len, <pass 1>, <pass 2 if passes == 2>]
    <pass> = [length, stages, (radix, ns, tw, rt) * stages]

``tw`` is the table offset of a stage's twiddles, laid out ``[r-1][k]``
(``(R-1)*ns`` entries; -1 when ``ns == 1``, where every twiddle is 1) and
``rt`` that of its roots ``W_R^m``, ``m`` in ``[0, R)``.  Two passes are
K2's four-step form for rows too long for shared memory, ``n = n1*n2``:
pass 1 transforms the n1-point columns, multiplies by the twiddle
``T[k1, j2] = W_n^(k1*j2)`` stored at ``inter`` in ``[k1][j2]`` order, and
pass 2 transforms the n2-point rows; the output index is
``k1 + n1*k2``.  :func:`replay` runs those arrays in numpy, index for index
and butterfly for butterfly, in the table's precision; the CPU tests pin
the kernels' indices and tables through it.
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np

__all__ = ["REGISTER_RADICES", "MAX_STAGES", "radices", "build", "replay"]

REGISTER_RADICES = (16, 8, 4, 2, 3, 5, 7, 11, 13)
MAX_STAGES = 24    # stockham::kMaxStages
_HEADER = 5


def radices(n: int) -> tuple[int, ...]:
    """The stages' radices of a length-n FFT, largest first."""
    if n < 1:
        raise ValueError(f"an FFT length must be >= 1, got {n}")
    out, m = [], n
    while m % 16 == 0:
        out.append(16)
        m //= 16
    for r in (8, 4, 2):
        if m % r == 0:
            out.append(r)
            m //= r
            break
    for p in (3, 5, 7, 11, 13):
        while m % p == 0:
            out.append(p)
            m //= p
    p = 17
    while m > 1:
        if p * p > m:
            p = m
        while m % p == 0:
            out.append(p)
            m //= p
        p += 2
    if len(out) > MAX_STAGES:
        raise ValueError(f"n = {n} needs {len(out)} stages, more than the "
                         f"kernels' {MAX_STAGES}")
    return tuple(sorted(out, reverse=True))


def _roots(length: int, exps, sign: int) -> np.ndarray:
    """W_length^e for the integer exponents ``exps``, reduced mod length
    before the float64 angle is formed."""
    e = np.mod(np.asarray(exps, dtype=np.int64), length)
    ang = (2.0 * np.pi * sign / length) * e
    return np.cos(ang) + 1j * np.sin(ang)


def _pass(n: int, sign: int, parts: list) -> list:
    """The int32 words of one pass; appends its table blocks to ``parts``."""
    words = [n, len(radices(n))]
    offset = sum(p.size for p in parts)
    ns = 1
    for r in radices(n):
        tw = -1
        if ns > 1:
            rr = np.arange(1, r, dtype=np.int64)[:, None]
            kk = np.arange(ns, dtype=np.int64)[None, :]
            parts.append(_roots(ns * r, rr * kk, sign).ravel())
            tw, offset = offset, offset + (r - 1) * ns
        parts.append(_roots(r, np.arange(r), sign))
        words += [r, ns, tw, offset]
        offset += r
        ns *= r
    return words


@lru_cache(maxsize=128)
def build(n: int, sign: int, split: tuple[int, int] | None = None):
    """(int32 plan, complex128 table) of the unnormalised length-n DFT with
    ``sign``; ``split = (n1, n2)`` makes it K2's two-pass form.  Cached:
    treat both arrays as read-only."""
    if sign not in (-1, 1):
        raise ValueError(f"sign must be -1 or +1, got {sign}")
    parts: list = []
    if split is None:
        passes, inter = 1, -1
        body = _pass(n, sign, parts)
    else:
        n1, n2 = split
        if n1 * n2 != n:
            raise ValueError(f"split {split} does not multiply to {n}")
        passes = 2
        body = _pass(n1, sign, parts) + _pass(n2, sign, parts)
        inter = sum(p.size for p in parts)
        k1 = np.arange(n1, dtype=np.int64)[:, None]
        j2 = np.arange(n2, dtype=np.int64)[None, :]
        parts.append(_roots(n, k1 * j2, sign).ravel())
    table = np.concatenate(parts) if parts else np.zeros(0, np.complex128)
    plan = np.array([n, sign, passes, inter, table.size] + body,
                    dtype=np.int32)
    plan.flags.writeable = False
    table.flags.writeable = False
    return plan, table


# -- numpy replay -------------------------------------------------------------


def _mul_i(t, sign):
    """t * (sign * i), exactly, as the kernels multiply by W_4^1."""
    return -sign * t.imag + 1j * (sign * t.real)


def _bitrev(q: int, bits: int) -> int:
    return int(format(q, f"0{bits}b")[::-1], 2) if bits else 0


def _butterfly_pow2(v, roots, sign):
    """Radix-2 decimation in frequency over the R values, outputs read in
    bit-reversed order: the kernels' register butterfly for R = 2^b."""
    R = len(v)
    a = list(v)
    half = R // 2
    while half >= 1:
        span = 2 * half
        for base in range(0, R, span):
            for i in range(half):
                u, w = a[base + i], a[base + i + half]
                a[base + i] = u + w
                t = u - w
                e = i * (R // span)
                if 4 * e == R:
                    t = _mul_i(t, sign)
                elif e:
                    t = t * roots[e]
                a[base + i + half] = t
        half //= 2
    bits = R.bit_length() - 1
    return [a[_bitrev(q, bits)] for q in range(R)]


def _butterfly_odd(v, roots):
    """The kernels' odd-prime butterfly: symmetric sums and differences of
    the pairs (m, R - m) against the real and imaginary parts of the
    roots."""
    R = len(v)
    h = (R - 1) // 2
    s = [None] + [v[m] + v[R - m] for m in range(1, h + 1)]
    d = [None] + [v[m] - v[R - m] for m in range(1, h + 1)]
    out = [None] * R
    total = v[0]
    for m in range(1, h + 1):
        total = total + s[m]
    out[0] = total
    for k in range(1, h + 1):
        a, b = v[0], 0
        for m in range(1, h + 1):
            w = roots[(m * k) % R]
            a = a + s[m] * w.real
            b = b + d[m] * w.imag
        ib = 1j * b
        out[k], out[R - k] = a + ib, a - ib
    return out


def _run_pass(words, table, x, sign):
    """One pass over the sequences x (N, length); returns (N, length)."""
    length, nstages = int(words[0]), int(words[1])
    src = x
    for s in range(nstages):
        R, ns, tw, rt = (int(w) for w in words[2 + 4 * s: 6 + 4 * s])
        m = length // R
        j = np.arange(m)
        k = j % ns
        v = [src[:, j + r * m] for r in range(R)]
        if ns > 1:
            v = [v[0]] + [v[r] * table[tw + (r - 1) * ns + k]
                          for r in range(1, R)]
        roots = table[rt: rt + R]
        if R & (R - 1) == 0 and R <= 16:
            v = _butterfly_pow2(v, roots, sign)
        elif R in REGISTER_RADICES:
            v = _butterfly_odd(v, roots)
        else:                       # the direct stage: X[q] = sum_r v[r] W^rq
            rq = np.outer(np.arange(R), np.arange(R)) % R
            stacked = np.stack(v, axis=-1)                    # (N, m, r)
            v = list(np.moveaxis(stacked @ roots[rq], -1, 0))
        dst = np.empty_like(src)
        d = (j - k) * R + k
        for r in range(R):
            dst[:, d + r * ns] = v[r]
        src = dst
    return src


def replay(plan: np.ndarray, table: np.ndarray, x: np.ndarray) -> np.ndarray:
    """Run ``plan`` on the rows of ``x`` (..., n) in numpy, in the precision
    of ``table`` (complex128, or complex64 for K2's rounded table)."""
    n, sign, passes, inter = (int(w) for w in plan[:4])
    if x.shape[-1] != n:
        raise ValueError(f"plan of length {n} on rows of {x.shape[-1]}")
    shape = x.shape
    rows = x.reshape(-1, n).astype(table.dtype)
    body = plan[_HEADER:]
    if passes == 1:
        return _run_pass(body, table, rows, sign).reshape(shape)
    n1 = int(body[0])
    second = body[2 + 4 * int(body[1]):]
    n2 = int(second[0])
    cols = rows.reshape(-1, n1, n2).transpose(0, 2, 1).reshape(-1, n1)
    b = _run_pass(body, table, cols, sign).reshape(-1, n2, n1)
    b = b * table[inter: inter + n].reshape(n1, n2).T         # (r, j2, k1)
    b = b.transpose(0, 2, 1).reshape(-1, n2)                  # (r*k1, j2)
    out = _run_pass(second, table, b, sign).reshape(-1, n1, n2)
    return out.transpose(0, 2, 1).reshape(shape)              # k1 + n1*k2
