"""Forward Fourier transform with coordinate-aware phase and amplitude.

Counterpart of ``xrft_tpu/transform.py:224-399`` (xrft's
``xrft/xrft.py:307-476``).  Every decision driven by coordinates (spacing,
lag, frequency grids, axis flips, shifts, phase factors) is computed on the
host; the bulk data goes through torch ops on its own device (flip,
ifftshift, detrend, window, FFT, fftshift, phase multiply, amplitude scale).
"""

from __future__ import annotations

import warnings

import numpy as np
import torch

from . import coords as ce
from .labeled import Coord, LabeledArray
from .ops import fft_core

__all__ = ["fft", "ifft"]

_real_flag_warning = (
    "`real` flag will be deprecated in future version of xrft_tpu.fft and "
    "replaced by `real_dim` flag."
)


def _not_ported(what: str, slice_: str):
    return NotImplementedError(
        f"{what} is not ported to xrft_tpu_torch yet; it comes with the "
        f"{slice_} slice (ROADMAP.md, Queue 1)"
    )


def _move_to_end(lst, el):
    return [i for i in lst if i != el] + [el]


def _dim_coord(da: LabeledArray, d: str) -> Coord:
    """The 1-D coordinate for dim d, or the implicit integer grid that
    xarray exposes for a dim without coordinates."""
    if d in da.coords:
        return da.coords[d]
    return Coord((d,), np.arange(da.sizes[d]), None, d)


def _norm_dim(da, dim):
    if dim is None:
        return list(da.dims)
    if isinstance(dim, str):
        return [dim]
    return list(dim)


def _check_bad_transform_coords(da: LabeledArray, dim):
    """Reject non-dimension coordinates that share a transform dim
    (``xrft/xrft.py:411-420``)."""
    for d in dim:
        bad = [c for c in da.coords if c != d and d in da.coords[c].dims]
        if bad:
            raise ValueError(
                f"The input array contains coordinate variable(s) ({bad}) "
                f"whose dims include the transform dimension(s) `{d}`. "
                f"Please drop these coordinates (`.drop_vars({bad})`) before "
                f"invoking xrft_tpu."
            )


def fft(
    da: LabeledArray,
    spacing_tol: float = 1e-3,
    dim=None,
    real_dim: str | None = None,
    shift: bool = True,
    detrend: str | None = None,
    window: str | None = None,
    true_phase: bool = True,
    true_amplitude: bool = True,
    chunks_to_segments: bool = False,
    segment_overlap=None,
    prefix: str = "freq_",
    real: str | None = None,
    engine: str | None = None,
    _shift_nonreal: bool = False,
) -> LabeledArray:
    """Discrete Fourier transform of `da` along `dim`, with the semantics of
    ``xrft_tpu.fft``:

    - ``dim=None`` transforms all dims; ``real_dim`` takes an rfft along that
      dim (moved last; ``shift`` forced False).
    - ``detrend`` in {None, 'constant', 'linear'} removes the mean or the
      linear least-squares fit over the transform dims first.
    - ``window`` applies a separable scipy-named window over the transform
      dims.
    - ``true_phase=True`` flips decreasing coordinates, ifftshifts the input
      (the grid is centered on its lag) and multiplies the output by
      ``exp(-2i*pi*f*lag)``; each frequency coordinate records its
      ``direct_lag`` attr.
    - ``true_amplitude=True`` multiplies by the product of grid spacings.

    ``chunks_to_segments``, ``segment_overlap`` and ``engine`` are not
    ported yet and raise NotImplementedError.
    """
    if chunks_to_segments or segment_overlap is not None:
        raise _not_ported("chunks_to_segments/segment_overlap",
                          "segments and short-time")
    if engine is not None:
        raise _not_ported(f"engine={engine!r}",
                          "float64 precision path" if engine == "hp"
                          else "sharded path")
    dim = _norm_dim(da, dim)

    if real is not None:
        real_dim = real
        warnings.warn(_real_flag_warning, FutureWarning)

    if real_dim is not None:
        if real_dim not in da.dims:
            raise ValueError(
                "The dimension along which real FT is taken must be one of "
                "the existing dimensions."
            )
        dim = _move_to_end(dim, real_dim)

    ce.check_valid_fft_coords(da, dim)

    rawdims = da.dims

    nonreal_shift = False
    if real_dim is not None:
        da = da.transpose(*_move_to_end(list(da.dims), real_dim))
        # xrft forces shift=False for real transforms (xrft/xrft.py:400-404);
        # _shift_nonreal lets the one-sided PSD route shift the other axes
        nonreal_shift = shift and _shift_nonreal
        shift = False

    axis_num = [da.get_axis_num(d) for d in dim]
    N = [da.shape[n] for n in axis_num]

    _check_bad_transform_coords(da, dim)

    delta_x = [
        ce.get_coordinate_spacing(_dim_coord(da, d), spacing_tol) for d in dim
    ]
    lag_x = [ce.lag_coord(_dim_coord(da, d)) for d in dim]

    if detrend is not None:
        from .detrend import detrend as _detrend

        orig_dims = da.dims
        da = _detrend(da, dim, detrend_type=detrend)
        if tuple(da.dims) != tuple(orig_dims):
            da = da.transpose(*orig_dims)

    if window is not None:
        from .ops.window import apply_window

        _, da = apply_window(da, dim, window_type=window)

    data = da.data
    if true_phase:
        # decreasing coordinates are flipped ascending
        reversed_axes = [
            da.get_axis_num(d)
            for d in dim
            if d in da.coords and da.coords[d].values[-1] < da.coords[d].values[0]
        ]
        if reversed_axes:
            data = torch.flip(data, reversed_axes)

    if nonreal_shift:
        post_axes = [a for a, d in zip(axis_num, dim) if d != real_dim]
    else:
        post_axes = axis_num if shift else ()
    core = fft_core.fftn if real_dim is None else fft_core.rfftn
    f = core(data, axis_num, pre_shift_axes=axis_num if true_phase else (),
             post_shift_axes=post_axes)

    k = ce.freq_grids(N, delta_x, real_dim is not None, shift)
    if nonreal_shift:
        k = [np.fft.fftshift(kk) if d != real_dim else kk
             for kk, d in zip(k, dim)]

    # transform dims renamed freq_<d> with frequency coords; all other dims
    # and coords carried through
    swap = {d: ce.freq_dim_name(d, prefix) for d in dim}
    out_dims = [swap.get(d, d) for d in da.dims]
    out_coords = {cname: c.copy() for cname, c in da.coords.items()
                  if cname not in dim}
    for d, kk in zip(dim, k):
        out_coords[swap[d]] = Coord((swap[d],), kk, {"spacing": kk[1] - kk[0]},
                                    swap[d])

    daft = LabeledArray(f, dims=out_dims, coords=out_coords, name=da.name)

    if true_phase:
        for d, lag in zip(dim, lag_x):
            fd = swap[d]
            theta = -2.0 * np.pi * out_coords[fd].values * lag
            phase = torch.as_tensor(np.cos(theta) + 1j * np.sin(theta),
                                    dtype=f.dtype, device=f.device)
            pl = LabeledArray(phase, dims=(fd,), coords={fd: out_coords[fd]})
            daft = (daft * pl).assign_coords(
                {fd: out_coords[fd].copy(
                    attrs={**out_coords[fd].attrs, "direct_lag": lag}
                )}
            )

    if true_amplitude:
        daft = daft * float(np.prod(delta_x))

    daft.name = da.name
    return daft.transpose(*[swap.get(d, d) for d in rawdims])


def ifft(*args, **kwargs):
    """Not ported yet (``xrft_tpu.ifft``)."""
    raise _not_ported("ifft", "ifft")
