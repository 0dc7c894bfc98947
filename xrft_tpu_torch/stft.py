"""Short-time Fourier transform and its overlap-add inverse.

Counterpart of ``xrft_tpu/stft.py`` (scipy.signal.stft / istft semantics):
a hann analysis window, 50% overlap, ``boundary='zeros'`` half-window padding
and tail padding so that the signal is covered, 'spectrum' (1/sum(w)) or
'psd' scaling, one-sided for real input, and the NOLA-normalised weighted
overlap-add inverse ``x[n] = sum_k w[n-kH] y_k[n-kH] / sum_k w^2[n-kH]``.

The forward runs the Welch segmenting (one strided view and one copy) and a
batched transform.  The inverse's overlap-add is one
``torch.nn.functional.fold`` on the data's device, whose every output sums
its segments in one thread (no atomics, repeatable).  The STFT records what
its inverse needs in ``attrs``, so ``istft(stft(x))`` needs no arguments.
"""

from __future__ import annotations

import warnings

import numpy as np
import torch

from . import coords as ce
from .labeled import Coord, LabeledArray
from .ops.window import window_factor
from .spectra import _is_real_input, _norm_1d_dim, _stft_plan
from .transform import _dim_coord, fft, ifft

__all__ = ["stft", "istft"]


def stft(da, dim=None, seglen=256, segment_overlap=None, window="hann",
         real_dim="auto", boundary="zeros", padded=True,
         scaling="spectrum", **kwargs) -> LabeledArray:
    """Short-time Fourier transform, scipy.signal.stft semantics
    (``xrft_tpu.stft``).

    ``segment_overlap=None`` is ``seglen // 2``; ``boundary='zeros'`` pads
    ``seglen // 2`` zeros at both ends and ``padded=True`` zero-extends the
    tail to whole segments, which together make the transform invertible.
    ``scaling='spectrum'`` divides by ``sum(w)``, 'psd' by
    ``sqrt(fs * sum(w^2))``.  Returns a complex LabeledArray over
    ``(<dim>_segment, freq_<dim>)`` with segment-centre coordinates and the
    inversion parameters in ``attrs``.
    """
    dim = _norm_1d_dim(da, dim, "stft")
    if real_dim == "auto":
        real_dim = dim if _is_real_input(da) else None

    coord = _dim_coord(da, dim)
    ce.get_coordinate_spacing(coord, kwargs.pop("spacing_tol", 1e-3))
    dx = float(ce.diff_coord(coord)[0])
    n_orig = da.sizes[dim]

    seglen = int(seglen)
    if seglen > n_orig and boundary is None and not padded:
        warnings.warn(
            f"seglen = {seglen} is greater than input length = {n_orig}, "
            f"using seglen = {n_orig}"
        )
        seglen = n_orig
    ov = segment_overlap
    if ov is None:
        ov = seglen // 2
    if isinstance(ov, float):
        if not 0.0 <= ov < 1.0:
            raise ValueError(
                f"fractional segment_overlap must be in [0, 1), got {ov}"
            )
        ov = int(round(ov * seglen))
    hop = seglen - ov

    pad_pre = seglen // 2 if boundary == "zeros" else 0
    if boundary not in (None, "zeros"):
        raise ValueError(f"boundary must be None or 'zeros', got "
                         f"{boundary!r}")
    n_ext = n_orig + 2 * pad_pre
    if padded:
        nseg = max(int(np.ceil(max(n_ext - seglen, 0) / hop)) + 1, 1)
        n_full = (nseg - 1) * hop + seglen
    else:
        n_full = n_ext
    pad_post = n_full - n_orig - pad_pre
    if pad_pre or pad_post > 0:
        from .padding import pad as _pad
        from .spectra import _zero_pad_to

        if pad_pre:
            da = _pad(da, {dim: (pad_pre, max(pad_post, 0))},
                      mode="constant")
            da.coords[dim].attrs.pop("pad_width", None)
        else:
            da = _zero_pad_to(da, dim, n_orig + pad_post)

    da, dim, seglen, ov = _stft_plan(da, dim, seglen, ov, 2, "stft")
    hop = seglen - ov

    ft = fft(da, dim=[dim], real_dim=real_dim, true_phase=False,
             true_amplitude=False, shift=False, chunks_to_segments=True,
             segment_overlap={dim: ov} if ov else None, window=window,
             **kwargs)

    w = window_factor(window, seglen)
    if scaling == "spectrum":
        s = 1.0 / w.sum()
    elif scaling == "psd":
        s = 1.0 / np.sqrt((1.0 / dx) * (w**2).sum())
    else:
        raise ValueError(f"scaling must be 'spectrum' or 'psd', got "
                         f"{scaling!r}")
    # the scale is rounded to float32 whatever the data, as in xrft_tpu
    out = ft.copy(data=ft.data * float(np.float32(s)))

    segdim = dim + "_segment"
    nseg_out = out.sizes[segdim]
    vals = np.asarray(coord.values)
    t0 = float(vals.ravel()[0]) if vals.dtype.kind in "fiu" else 0.0
    offset0 = 0.0 if pad_pre else seglen / 2.0
    centers = t0 + (np.arange(nseg_out) * hop + offset0) * dx
    out = out.assign_coords(
        {segdim: Coord(segdim, centers, attrs={"spacing": hop * dx},
                       name=segdim)})
    out.attrs.update({
        "stft_dim": dim, "stft_seglen": seglen, "stft_hop": hop,
        "stft_window": window if window is not True else "hann",
        "stft_boundary": pad_pre, "stft_scaling": scaling,
        "stft_n_orig": n_orig, "stft_dx": dx, "stft_t0": t0,
    })
    out.name = f"{da.name}_stft" if da.name else None
    return out


def _overlap_add(segs: torch.Tensor, hop: int, n_full: int) -> torch.Tensor:
    """(..., nseg, seglen) -> (..., n_full): the segments summed at ``hop``
    spacing by one ``fold`` (complex data as two real folds)."""
    if segs.is_complex():
        return torch.complex(_overlap_add(segs.real, hop, n_full),
                             _overlap_add(segs.imag, hop, n_full))
    *batch, nseg, seglen = segs.shape
    cols = segs.reshape(-1, nseg, seglen).transpose(1, 2)   # (B, seglen, L)
    out = torch.nn.functional.fold(cols, output_size=(1, n_full),
                                   kernel_size=(1, seglen), stride=(1, hop))
    return out.reshape(*batch, n_full)


def istft(Zxx: LabeledArray, dim=None, seglen=None, segment_overlap=None,
          window=None, boundary=None, scaling=None,
          input_onesided=None) -> LabeledArray:
    """Inverse STFT, scipy.signal.istft's NOLA-normalised weighted
    overlap-add (``xrft_tpu.istft``).  The parameters default to what
    :func:`stft` recorded in ``attrs``; raises where the window and hop fail
    the NOLA condition, as scipy does."""
    at = Zxx.attrs
    d = dim or at.get("stft_dim")
    if d is None:
        segdims = [x[: -len("_segment")] for x in Zxx.dims
                   if x.endswith("_segment")]
        if len(segdims) != 1:
            raise ValueError(
                "istft needs dim=: could not infer a unique segment dim "
                f"from {Zxx.dims}"
            )
        d = segdims[0]
    segdim, fdim = d + "_segment", f"freq_{d}"
    if segdim not in Zxx.dims or fdim not in Zxx.dims:
        raise ValueError(
            f"istft expects dims ({segdim!r}, {fdim!r}); got {Zxx.dims}"
        )
    nf = Zxx.sizes[fdim]
    if input_onesided is None:
        input_onesided = (at["stft_seglen"] != nf
                          if "stft_seglen" in at else True)
    seglen = int(seglen or at.get("stft_seglen")
                 or (2 * (nf - 1) if input_onesided else nf))
    one_sided = seglen != nf
    if segment_overlap is None:
        hop = int(at.get("stft_hop") or seglen // 2)
    else:
        ov = segment_overlap
        if isinstance(ov, float):
            ov = int(round(ov * seglen))
        hop = seglen - ov
    window = window or at.get("stft_window", "hann")
    scaling = scaling or at.get("stft_scaling", "spectrum")
    pad_pre = int(at.get("stft_boundary", 0)) if boundary is None \
        else (seglen // 2 if boundary == "zeros" else 0)
    n_orig = at.get("stft_n_orig")
    dx = at.get("stft_dx")
    if dx is None:
        # a foreign STFT: the sample spacing from the frequency grid
        if fdim in Zxx.coords:
            df = ce.get_coordinate_spacing(Zxx.coords[fdim], 1e-3)
            dx = 1.0 / (seglen * float(df))
        else:
            dx = 1.0
    dx = float(dx)
    t0 = float(at.get("stft_t0", 0.0))

    w = window_factor(window, seglen)
    nseg = Zxx.sizes[segdim]
    n_full = (nseg - 1) * hop + seglen

    # the NOLA check and normalisation sum_k w^2[n - kH], host constants
    norm = np.zeros(n_full)
    for k in range(nseg):
        norm[k * hop:k * hop + seglen] += w**2
    lo = pad_pre
    hi = n_full - max(n_full - (n_orig if n_orig is not None else n_full)
                      - pad_pre, 0)
    if np.min(norm[lo:hi]) <= 1e-10:
        raise ValueError(
            "NOLA condition failed: this window/hop pair is not "
            "invertible (scipy.signal.check_NOLA)"
        )
    norm = np.where(norm > 1e-10, norm, 1.0)

    if scaling == "spectrum":
        s = w.sum()
    elif scaling == "psd":
        s = np.sqrt((1.0 / dx) * (w**2).sum())
    else:
        raise ValueError(f"scaling must be 'spectrum' or 'psd', got "
                         f"{scaling!r}")
    Z = Zxx.copy(data=Zxx.data * float(np.float32(s)))
    Z.attrs = {}

    # per-segment inverse transform; true_phase with lag 0 is the plain
    # inverse DFT (no output ifftshift)
    if one_sided and seglen % 2 == 1:
        # an odd seglen: the real inverse is even-length only, so extend the
        # half spectrum to the full circle and take the complex inverse
        ax = Z.get_axis_num(fdim)
        tail = Z.data.narrow(ax, 1, nf - 1).flip(ax).conj()
        full = torch.cat([Z.data, tail], dim=ax)
        fullc = Coord((fdim,), np.fft.fftfreq(seglen, dx),
                      {"spacing": 1.0 / (seglen * dx)}, fdim)
        zc = {k: c.copy() for k, c in Z.coords.items()
              if fdim not in c.dims}
        zc[fdim] = fullc
        Zf = LabeledArray(full, dims=Z.dims, coords=zc, name=Z.name)
        back = ifft(Zf, dim=[fdim], real_dim=None, true_phase=True,
                    true_amplitude=False, shift=False, lag=[0.0])
        back = back.copy(data=back.data.real)
    else:
        back = ifft(Z, dim=[fdim], real_dim=fdim if one_sided else None,
                    true_phase=True, true_amplitude=False, shift=False,
                    lag=[0.0])

    # the synthesis window, the overlap-add and the normalisation, with the
    # float32 constants of xrft_tpu
    dev = back.data.device
    order = [x for x in back.dims if x not in (segdim, d)] + [segdim, d]
    segs = back.transpose(*order).data * torch.as_tensor(
        w.astype(np.float32), device=dev)
    x_full = _overlap_add(segs, hop, n_full) * torch.as_tensor(
        (1.0 / norm).astype(np.float32), device=dev)

    start = pad_pre
    stop = pad_pre + (n_orig if n_orig is not None else n_full - pad_pre)
    stop = min(stop, n_full)
    x_data = x_full[..., start:stop]

    out_dims = [x for x in back.dims if x not in (segdim, d)] + [d]
    coords = {k: c.copy() for k, c in Zxx.coords.items()
              if segdim not in c.dims and fdim not in c.dims}
    coords[d] = Coord((d,), t0 + np.arange(stop - start) * dx,
                      {"spacing": dx}, d)
    name = Zxx.name
    if name and name.endswith("_stft"):
        name = name[: -len("_stft")] or None
    return LabeledArray(x_data, dims=out_dims, coords=coords, name=name)
