"""Real trigonometric transforms: DCT/DST types I-IV (scipy.fft namesakes).

Counterpart of ``xrft_tpu/trig.py``, with ``scipy.fft.dct/idct/dst/idst``'s
semantics: types 1-4, ``norm`` in {None/'backward', 'ortho', 'forward'},
same-length real output, and scipy's inverse pairings (1<->1, 2<->3, 4<->4).

Every type but IV goes through :mod:`.ops.fft_core` (cuFFT, K2/K4 or the
matmul engine, by ``config.fft_impl``):

* **DCT-I / DST-I**: the even / odd extension (a host index gather) and one
  FFT of length ``2N-2`` / ``2N+2``; its real / imaginary part is the
  transform.
* **DCT-II**: Makhoul's permutation — the FFT of
  ``x[0::2] ++ reversed(x[1::2])`` and a half-sample twiddle.
* **DCT-III**: the transpose of the DCT-II pipeline (the DFT matrix is
  symmetric): twiddle the input, FFT, inverse-permute the real part.
* **DST-II / DST-III**: the sign-flip and reversal reductions onto DCT-II /
  DCT-III.
* **DCT-IV / DST-IV**: one product with the dense ``N x N`` half-shifted
  trig matrix (``torch.matmul`` at full float32 grade, ``config.full_fp32``).

Permutations, twiddles and norm factors are host numpy, turned into tensors
of the data's real dtype on its device.  Integer and bool data compute in
float64 (as in scipy), float16 data in float32 from the first operation on,
so no constant is ever rounded to float16.  Like :func:`scipy.fft.dct` the
transforms are index-based: dims/coords pass through and no spacing is
checked.
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch

from .config import engine_impl, full_fp32
from .dtypes import promote
from .ops import fft_core
from .spectra import _norm_1d_dim, _norm_dim_list
from .utils import along

__all__ = ["dct", "idct", "dst", "idst", "dctn", "idctn", "dstn", "idstn"]

_NORMS = (None, "backward", "ortho", "forward")


def _take(x: torch.Tensor, idx: np.ndarray, ax: int) -> torch.Tensor:
    return x.index_select(ax, torch.as_tensor(idx, device=x.device))


def _validate(kind, type, norm, n):
    if type not in (1, 2, 3, 4):
        raise ValueError(f"{kind} type must be 1, 2, 3 or 4 (got {type})")
    if norm not in _NORMS:
        raise ValueError(f"invalid norm value {norm!r}; should be "
                         "'backward', 'ortho' or 'forward'")
    if kind == "dct" and type == 1 and n < 2:
        raise ValueError("DCT-I requires the input size to be at least 2")


def _makhoul_perm(n):
    """DCT-II input permutation [x0, x2, ..., | ..., x3, x1]."""
    return np.concatenate([np.arange(0, n, 2), np.arange(1, n, 2)[::-1]])


def _twiddle(like, ax, n):
    th = np.pi * np.arange(n) / (2.0 * n)
    return along(np.cos(th), like, ax), along(np.sin(th), like, ax)


def _dct2_raw(x, ax, n):
    """Unnormalized DCT-II: y[k] = 2 sum x[n] cos(pi k (2n+1) / 2N)."""
    V = fft_core.fftn(_take(x, _makhoul_perm(n), ax), [ax])
    c, s = _twiddle(x, ax, n)
    return 2.0 * (V.real * c + V.imag * s)      # 2 Re(exp(-i th) V)


def _dct2_transpose_raw(x, ax, n):
    """The transpose of :func:`_dct2_raw` as a linear map:
    u = 2 P^T Re(FFT(exp(-i th) * x))."""
    c, s = _twiddle(x, ax, n)
    u = fft_core.fftn(torch.complex(x * c, -(x * s)), [ax]).real
    return 2.0 * _take(u, np.argsort(_makhoul_perm(n)), ax)


def _scale_along(x, ax, vec):
    return x * along(vec, x, ax)


@lru_cache(maxsize=8)
def _trig4_matrix(kind, n, dtype, device):
    """DCT-IV / DST-IV matrix (backward scaling),
    2 cos/sin(pi (2k+1)(2n+1) / 4N), built in float64 on the host and kept
    on ``device`` in ``dtype`` for the next call."""
    k = np.arange(n)[:, None]
    m = np.arange(n)[None, :]
    arg = np.pi * (2 * k + 1) * (2 * m + 1) / (4.0 * n)
    M = 2.0 * (np.cos(arg) if kind == "dct" else np.sin(arg))
    return torch.as_tensor(M, dtype=dtype, device=device)


def _type4(kind, x, ax, n):
    M = _trig4_matrix(kind, n, x.dtype, x.device)
    with full_fp32():
        y = torch.matmul(x.movedim(ax, -1), M.T)
    return y.movedim(-1, ax)


def _dct_raw(x, ax, n, type):
    """Backward-norm DCT of the given type along ``ax``."""
    if type == 1:
        ext = np.concatenate([np.arange(n), np.arange(n - 2, 0, -1)])
        return fft_core.fftn(_take(x, ext, ax), [ax]).real.narrow(ax, 0, n)
    if type == 2:
        return _dct2_raw(x, ax, n)
    if type == 3:
        g = np.ones(n)
        g[0] = 0.5
        return _dct2_transpose_raw(_scale_along(x, ax, g), ax, n)
    return _type4("dct", x, ax, n)


def _dst_raw(x, ax, n, type):
    """Backward-norm DST of the given type along ``ax``."""
    if type == 1:
        # odd extension [0, x, 0, -rev(x)], length 2N+2; -Im(FFT)[1:N+1]
        z = torch.zeros_like(x.narrow(ax, 0, 1))
        v = torch.cat([z, x, z, -x.flip(ax)], dim=ax)
        return -fft_core.fftn(v, [ax]).imag.narrow(ax, 1, n)
    if type == 2:
        y = _dct2_raw(_scale_along(x, ax, (-1.0) ** np.arange(n)), ax, n)
        return y.flip(ax)
    if type == 3:
        g = np.ones(n)
        g[-1] = 0.5
        y = _dct2_transpose_raw(_scale_along(x, ax, g).flip(ax), ax, n)
        return _scale_along(y, ax, (-1.0) ** np.arange(n))
    return _type4("dst", x, ax, n)


def _norm_factors(kind, type, norm, n):
    """(input_scale_vec | None, output_scale_vec | None) turning the
    backward transform into the requested norm — scipy.fft's conventions
    (orthogonalize=True for 'ortho', scipy's default)."""
    if norm in (None, "backward"):
        return None, None
    # the "logical length" entering the 1/(2M) forward factor
    M = {1: n - 1 if kind == "dct" else n + 1, 2: n, 3: n, 4: n}[type]
    if norm == "forward":
        return None, np.full(n, 1.0 / (2.0 * M))
    # ortho: symmetric sqrt factors plus endpoint sqrt(2) orthogonalization
    out = np.full(n, np.sqrt(1.0 / (2.0 * M)))
    inp = None
    rt2 = np.sqrt(2.0)
    if kind == "dct":
        if type == 1:
            inp = np.ones(n)
            inp[0] = rt2
            inp[-1] = rt2
            out[0] /= rt2
            out[-1] /= rt2
        elif type == 2:
            out[0] /= rt2
        elif type == 3:
            inp = np.ones(n)
            inp[0] = rt2
    else:
        if type == 2:
            out[-1] /= rt2
        elif type == 3:
            inp = np.ones(n)
            inp[-1] = rt2
    return inp, out


def _trig(kind, da, dim, type, norm, engine, caller):
    dim = _norm_1d_dim(da, dim, caller)
    if da.data.is_complex():
        raise ValueError(f"{caller}: input must be real "
                         "(like scipy.fft, which transforms the real and "
                         "imaginary parts independently; split them "
                         "explicitly if that is what you want)")
    ax = da.dims.index(dim)
    n = da.sizes[dim]
    _validate(kind, type, norm, n)
    # integer and bool data in float64, as scipy; float16 in float32
    x = promote(da.data, "float64")
    inp, out = _norm_factors(kind, type, norm, n)
    if inp is not None:
        x = _scale_along(x, ax, inp)
    with engine_impl(engine):
        raw = (_dct_raw if kind == "dct" else _dst_raw)(x, ax, n, type)
    if out is not None:
        raw = _scale_along(raw, ax, out)
    res = da.copy(data=raw)
    res.name = f"{da.name}_{kind}" if da.name else None
    return res


def dct(da, dim=None, type=2, norm=None, engine=None):
    """Discrete cosine transform along ``dim`` (default: last dim) —
    ``scipy.fft.dct``.  ``type`` in {1, 2, 3, 4}; ``norm`` in
    {None/'backward', 'ortho', 'forward'}.  Real input only; the output is
    real, same length, with the input's dims/coords/attrs unchanged."""
    return _trig("dct", da, dim, type, norm, engine, "dct")


_INV_TYPE = {1: 1, 2: 3, 3: 2, 4: 4}


def _inv_norm(norm):
    return {"ortho": "ortho", "forward": "backward"}.get(norm, "forward")


def idct(da, dim=None, type=2, norm=None, engine=None):
    """Inverse DCT — ``scipy.fft.idct``: the type-``{1: 1, 2: 3, 3: 2,
    4: 4}[type]`` transform with the norm direction swapped, so
    ``idct(dct(x, type=t), type=t)`` round-trips for every type and norm."""
    _validate("dct", type, norm, da.sizes[_norm_1d_dim(da, dim, "idct")])
    res = _trig("dct", da, dim, _INV_TYPE[type], _inv_norm(norm), engine,
                "idct")
    res.name = f"{da.name}_idct" if da.name else None
    return res


def dst(da, dim=None, type=2, norm=None, engine=None):
    """Discrete sine transform along ``dim`` — ``scipy.fft.dst`` (types
    1-4, the norm and coordinate semantics of :func:`dct`)."""
    return _trig("dst", da, dim, type, norm, engine, "dst")


def idst(da, dim=None, type=2, norm=None, engine=None):
    """Inverse DST — ``scipy.fft.idst`` (see :func:`idct`)."""
    _validate("dst", type, norm, da.sizes[_norm_1d_dim(da, dim, "idst")])
    res = _trig("dst", da, dim, _INV_TYPE[type], _inv_norm(norm), engine,
                "idst")
    res.name = f"{da.name}_idst" if da.name else None
    return res


def _norm_nd_dims(da, dim, caller):
    dims = _norm_dim_list(da, dim)
    if not dims:
        raise ValueError(f"{caller}: dim must name at least one dimension")
    bad = [d for d in dims if d not in da.dims]
    if bad:
        raise ValueError(f"{caller}: dims {bad} not found in {da.dims}")
    if len(set(dims)) != len(dims):
        raise ValueError(f"{caller}: duplicate dims in {dims}")
    return dims


def _trign(one, da, dim, type, norm, engine, caller):
    res = da
    for d in _norm_nd_dims(da, dim, caller):
        res = one(res, dim=d, type=type, norm=norm, engine=engine)
    res.name = f"{da.name}_{caller}" if da.name else None
    return res


def dctn(da, dim=None, type=2, norm=None, engine=None):
    """N-D discrete cosine transform over ``dim`` (a name, a list, or None
    for all dims) — ``scipy.fft.dctn``: :func:`dct` along each named dim."""
    return _trign(dct, da, dim, type, norm, engine, "dctn")


def idctn(da, dim=None, type=2, norm=None, engine=None):
    """Inverse N-D DCT — ``scipy.fft.idctn`` (``idct`` along each dim)."""
    return _trign(idct, da, dim, type, norm, engine, "idctn")


def dstn(da, dim=None, type=2, norm=None, engine=None):
    """N-D discrete sine transform — ``scipy.fft.dstn`` (``dst`` along
    each dim)."""
    return _trign(dst, da, dim, type, norm, engine, "dstn")


def idstn(da, dim=None, type=2, norm=None, engine=None):
    """Inverse N-D DST — ``scipy.fft.idstn`` (``idst`` along each dim)."""
    return _trign(idst, da, dim, type, norm, engine, "idstn")
