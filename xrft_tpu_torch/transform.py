"""Forward and inverse Fourier transforms with coordinate-aware phase and
amplitude.

Counterpart of ``xrft_tpu/transform.py:224-639`` (xrft's
``xrft/xrft.py:237-266,307-646``).  Every decision driven by coordinates
(spacing, lag, frequency grids, sort order, axis flips, shifts, phase
factors) is computed on the host; the bulk data goes through torch ops on
its own device (flip, roll, ifftshift, detrend, window, FFT, fftshift, phase
multiply, amplitude scale).  ``engine="hp"`` routes to :mod:`.highprec`.
"""

from __future__ import annotations

import warnings

import numpy as np
import torch

from . import coords as ce
from . import telemetry
from .config import ENGINE_NAMES, engine_impl
from .dtypes import complex_dtype
from .labeled import Coord, LabeledArray
from .ops import fft_core, shards

__all__ = ["fft", "ifft", "dft", "idft"]

_real_flag_warning = (
    "`real` flag will be deprecated in future version of xrft_tpu.fft and "
    "replaced by `real_dim` flag."
)


def _check_engine(engine):
    """``engine`` is None, an engine name of ``config.engine_impl``, "hp"
    (handled by the caller) or a callable (the pencil engine of
    :mod:`.parallel`); anything else raises the JAX package's message."""
    if engine is None or callable(engine) or engine in ENGINE_NAMES:
        return
    raise ValueError(f"Unknown fft engine {engine!r}")


def _run_core(data, axes, kind, engine, pre_shift_axes=(),
              post_shift_axes=(), post_kind="fftshift"):
    """The core N-D transform (``xrft_tpu/transform.py:30-52``).  An engine
    name runs :mod:`.ops.fft_core` under the ``fft_impl`` it names
    (``config.engine_impl``), which absorbs or applies the shifts itself.  A
    callable ``engine(data, axes, kind)`` is the pencil engine of
    :mod:`.parallel`; it gets explicit shifts here, local on resident axes
    and one exchange on a sharded one (:mod:`.ops.shards`)."""
    if callable(engine):
        if pre_shift_axes:
            data = shards.ifftshift(data, list(pre_shift_axes))
        out = engine(data, axes, kind)
        if post_shift_axes:
            post = shards.fftshift if post_kind == "fftshift" \
                else shards.ifftshift
            out = post(out, list(post_shift_axes))
        return out
    if shards.is_sharded(data):
        raise ValueError(
            "sharded data need the pencil engine: call the sharded_* "
            "functions of xrft_tpu_torch.parallel")
    fn = {"fft": fft_core.fftn, "ifft": fft_core.ifftn,
          "rfft": fft_core.rfftn, "irfft": fft_core.irfftn}[kind]
    kw = {"post_kind": post_kind} if kind in ("ifft", "irfft") else {}
    with engine_impl(engine):
        return fn(data, axes, pre_shift_axes=pre_shift_axes,
                  post_shift_axes=post_shift_axes, **kw)


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


def _stack_segments(da: LabeledArray, dim, suffix="_segment",
                    overlap=None, plan=None) -> LabeledArray:
    """Cut each transform dim into (<dim>_segment, <dim>) by the array's
    declared chunk lengths, Welch segmenting (``xrft_tpu/transform.py:111-
    134``).  ``overlap`` per dim, in samples (int) or as a fraction of the
    segment length (float in [0, 1)), follows scipy.signal.welch's
    ``noverlap``: trailing samples that fill no segment are dropped.
    ``plan`` takes a precomputed :func:`_segment_plan`.  Without overlap
    the segments are a reshape; with it, one strided view per dim and one
    copy."""
    with telemetry.span("segmenting"):
        newdims, newshape, newcoords, plans = plan if plan is not None \
            else _segment_plan(da, dim, suffix, overlap)
        if all(hop == seglen for _, _, seglen, hop, _ in plans):
            data = da.data.reshape(newshape)
        else:
            data = da.data
            for ax, nseg, seglen, hop, _n in sorted(plans, reverse=True):
                data = _slice_stack_axis(data, ax, nseg, seglen, hop)
            data = data.contiguous()
        return LabeledArray(data, dims=newdims, coords=newcoords,
                            attrs=da.attrs)


def _slice_stack_axis(data: torch.Tensor, ax, nseg, seglen, hop):
    """(..., n, ...) -> (..., nseg, seglen, ...) windows at ``hop`` along
    axis ``ax``, as a strided view (``xrft_tpu/transform.py:137-149``)."""
    out = data.unfold(ax, seglen, hop).movedim(-1, ax + 1)
    if out.shape[ax] != nseg:
        raise ValueError(f"{out.shape[ax]} segments along axis {ax}, "
                         f"planned {nseg}")
    return out


def _segment_plan(da: LabeledArray, dim, suffix="_segment", overlap=None):
    """(newdims, newshape, newcoords, plans) for :func:`_stack_segments`;
    ``plans`` lists (axis, nseg, seglen, hop, n) per transform dim
    (``xrft_tpu/transform.py:152-221``)."""
    chunks = da.attrs.get("_chunks")
    if chunks is None:
        raise ValueError(
            "chunks_to_segments=True requires declared chunks: call "
            "da.chunk({dim: seglen}) first."
        )
    ov = dict(overlap) if isinstance(overlap, dict) else \
        ({d: overlap for d in dim} if overlap else {})
    bad = set(ov) - set(dim)
    if bad:
        raise ValueError(
            f"segment_overlap given for non-transform dims {sorted(bad)}"
        )
    newdims, newshape, newcoords, plans = [], [], {}, []
    for ax, d in enumerate(da.dims):
        n = da.sizes[d]
        if d in dim:
            # an undeclared transform dim is one full-length segment, as an
            # unchunked dask dim is one chunk
            chunklen = chunks.get(d, n)
            o = ov.get(d, 0) or 0
            if isinstance(o, float):
                if not 0.0 <= o < 1.0:
                    raise ValueError(
                        f"fractional segment_overlap for dim {d!r} must be "
                        f"in [0, 1), got {o}"
                    )
                o = int(round(o * chunklen))
            if not 0 <= o < chunklen:
                raise ValueError(
                    f"segment_overlap for dim {d!r} must be in "
                    f"[0, seglen={chunklen}), got {o}"
                )
            hop = chunklen - o
            if o == 0:
                if n % chunklen != 0:
                    raise ValueError("Chunk lengths need to be the same.")
                nseg = n // chunklen
            else:
                if n < chunklen:
                    raise ValueError(
                        f"declared chunk length {chunklen} exceeds dim "
                        f"{d!r} size {n}"
                    )
                nseg = (n - chunklen) // hop + 1
                dropped = n - ((nseg - 1) * hop + chunklen)
                if dropped:
                    warnings.warn(
                        f"segment_overlap drops the last {dropped} samples "
                        f"of dim {d!r} (scipy.signal.welch convention)"
                    )
            newdims += [d + suffix, d]
            newshape += [nseg, chunklen]
            newcoords[d + suffix] = np.arange(nseg)
            newcoords[d] = _dim_coord(da, d).values[:chunklen]
            plans.append((ax, nseg, chunklen, hop, n))
        else:
            newdims.append(d)
            newshape.append(n)
            if d in da.coords:
                newcoords[d] = da.coords[d].values
    return newdims, newshape, newcoords, plans


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
    - ``chunks_to_segments=True`` cuts declared chunks into
      ``<dim>_segment`` dims (Welch segmenting); ``segment_overlap`` (int
      samples, float fraction of the segment length, or a per-dim dict)
      makes them overlap, as scipy.signal.welch's ``noverlap``.
    - ``engine="hp"`` runs every stage in float64/complex128
      (:func:`~xrft_tpu_torch.highprec.fft_hp`); "auto", "xla" and "matmul"
      run the transform under the ``fft_impl`` they name
      (``config.engine_impl``); a callable is the pencil engine of the
      sharded path (:mod:`~xrft_tpu_torch.parallel`).
    """
    dim = _norm_dim(da, dim)

    if segment_overlap is not None and not chunks_to_segments:
        raise ValueError("segment_overlap requires chunks_to_segments=True")

    if real is not None:
        real_dim = real
        warnings.warn(_real_flag_warning, FutureWarning)

    if engine == "hp":
        from .highprec import fft_hp

        return fft_hp(da, spacing_tol, dim, real_dim, shift, detrend, window,
                      true_phase, true_amplitude, prefix,
                      chunks_to_segments=chunks_to_segments,
                      segment_overlap=segment_overlap)
    _check_engine(engine)

    with telemetry.span("coords"):
        if real_dim is not None:
            if real_dim not in da.dims:
                raise ValueError(
                    "The dimension along which real FT is taken must be one "
                    "of the existing dimensions."
                )
            dim = _move_to_end(dim, real_dim)
        ce.check_valid_fft_coords(da, dim)

    if chunks_to_segments:
        da = _stack_segments(da, dim, overlap=segment_overlap)

    rawdims = da.dims  # segment dims included

    nonreal_shift = False
    if real_dim is not None:
        da = da.transpose(*_move_to_end(list(da.dims), real_dim))
        # xrft forces shift=False for real transforms (xrft/xrft.py:400-404);
        # _shift_nonreal lets the one-sided PSD route shift the other axes
        nonreal_shift = shift and _shift_nonreal
        shift = False

    axis_num = [da.get_axis_num(d) for d in dim]
    N = [da.shape[n] for n in axis_num]

    with telemetry.span("coords"):
        _check_bad_transform_coords(da, dim)
        delta_x = [ce.get_coordinate_spacing(_dim_coord(da, d), spacing_tol)
                   for d in dim]
        lag_x = [ce.lag_coord(_dim_coord(da, d)) for d in dim]

    if detrend is not None:
        from .detrend import detrend as _detrend

        orig_dims = da.dims
        with telemetry.span("prologue"):
            da = _detrend(da, dim, detrend_type=detrend)
        if tuple(da.dims) != tuple(orig_dims):
            da = da.transpose(*orig_dims)

    if window is not None:
        from .ops.window import apply_window

        with telemetry.span("prologue"):
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
            data = shards.flip(data, reversed_axes)

    if nonreal_shift:
        post_axes = [a for a, d in zip(axis_num, dim) if d != real_dim]
    else:
        post_axes = axis_num if shift else ()
    with telemetry.span("fft"):
        f = _run_core(data, axis_num, "fft" if real_dim is None else "rfft",
                      engine, pre_shift_axes=axis_num if true_phase else (),
                      post_shift_axes=post_axes)

    with telemetry.span("coords"):
        k = ce.freq_grids(N, delta_x, real_dim is not None, shift)
        if nonreal_shift:
            k = [np.fft.fftshift(kk) if d != real_dim else kk
                 for kk, d in zip(k, dim)]

        # transform dims renamed freq_<d> with frequency coords; all other
        # dims and coords carried through
        swap = {d: ce.freq_dim_name(d, prefix) for d in dim}
        out_dims = [swap.get(d, d) for d in da.dims]
        out_coords = {cname: c.copy() for cname, c in da.coords.items()
                      if cname not in dim}
        for d, kk in zip(dim, k):
            out_coords[swap[d]] = Coord((swap[d],), kk,
                                        {"spacing": kk[1] - kk[0]}, swap[d])

        daft = LabeledArray(f, dims=out_dims, coords=out_coords,
                            name=da.name)

    with telemetry.span("epilogue"):
        if true_phase:
            for d, lag in zip(dim, lag_x):
                fd = swap[d]
                theta = -2.0 * np.pi * out_coords[fd].values * lag
                phase = telemetry.to_device(
                    np.cos(theta) + 1j * np.sin(theta), dtype=f.dtype,
                    device=f.device)
                pl = LabeledArray(phase, dims=(fd,),
                                  coords={fd: out_coords[fd]})
                daft = (daft * pl).assign_coords(
                    {fd: out_coords[fd].copy(
                        attrs={**out_coords[fd].attrs, "direct_lag": lag}
                    )}
                )

        if true_amplitude:
            daft = daft * float(np.prod(delta_x))

    daft.name = da.name
    return daft.transpose(*[swap.get(d, d) for d in rawdims])



_LAG_NONE_WARNING = (
    "Default ifft's behaviour (lag=None) changed! Default value of lag was "
    "zero (centered output coordinates) and is now set to transformed "
    "coordinate's attribute: 'direct_lag'."
)


def _direct_lags(daft: LabeledArray, dim) -> list:
    """Each dim's ``direct_lag`` attr, 0.0 where there is none."""
    return [daft.coords[d].attrs.get("direct_lag", 0.0)
            if d in daft.coords else 0.0 for d in dim]


def _explicit_lags(daft: LabeledArray, dim, lag, warn=False) -> list:
    """A user's ``lag`` (a number or one entry per dim, None taking the
    dim's ``direct_lag``) as one lag per dim; ``warn`` says that no phase
    will be applied to honour it."""
    if isinstance(lag, (float, int)):
        lag = [lag]
    if len(dim) != len(lag):
        raise ValueError("dim and lag must have the same length.")
    if warn:
        warnings.warn(
            "Setting lag with true_phase=False does not guarantee accurate "
            "ifft.",
            Warning,
        )
    return [dl if l is None else l
            for dl, l in zip(_direct_lags(daft, dim), lag)]


def ifft(
    daft: LabeledArray,
    spacing_tol: float = 1e-3,
    dim=None,
    real_dim: str | None = None,
    shift: bool = True,
    true_phase: bool = True,
    true_amplitude: bool = True,
    chunks_to_segments: bool = False,
    prefix: str = "freq_",
    lag=None,
    real: str | None = None,
    engine: str | None = None,
) -> LabeledArray:
    """Inverse discrete Fourier transform of `daft` along `dim`, with the
    semantics of ``xrft_tpu.ifft``: ``lag`` sets each output coordinate's
    offset (``None`` reads each dim's ``direct_lag`` attr, with a
    FutureWarning); with ``true_phase`` the input is pre-multiplied by
    ``exp(+2i*pi*f*lag)``; frequency coordinates are sorted and must be
    centered on zero; output coordinates are the inverse grids plus the lag;
    ``true_amplitude`` divides by the product of output spacings.
    ``real_dim`` takes an irfft along that dim.  ``chunks_to_segments``
    cuts declared chunks into segments after the phase factor, as
    ``xrft_tpu.ifft``.  ``engine="hp"`` runs in complex128
    (:func:`~xrft_tpu_torch.highprec.ifft_hp`); the other engines are those
    of :func:`fft`.
    """
    dim = _norm_dim(daft, dim)

    if real is not None:
        real_dim = real
        warnings.warn(_real_flag_warning, FutureWarning)

    if engine == "hp":
        from .highprec import ifft_hp

        return ifft_hp(daft, spacing_tol, dim, real_dim, shift, true_phase,
                       true_amplitude, prefix, lag, chunks_to_segments)
    _check_engine(engine)

    dim = _ifft_dims(daft, dim, real_dim)
    if lag is None:
        lag = _direct_lags(daft, dim)
        warnings.warn(_LAG_NONE_WARNING, FutureWarning)
    else:
        lag = _explicit_lags(daft, dim, lag, warn=not true_phase)
    return _ifft_resolved(daft, spacing_tol, dim, real_dim, shift,
                          true_phase, true_amplitude, prefix, lag,
                          chunks_to_segments, engine)


def _ifft_dims(daft: LabeledArray, dim, real_dim) -> list:
    """``dim`` with ``real_dim`` moved last, after the checks of
    ``xrft_tpu/transform.py:441-449``."""
    with telemetry.span("coords"):
        if real_dim is not None:
            if real_dim not in daft.dims:
                raise ValueError(
                    "The dimension along which real IFT is taken must be "
                    "one of the existing dimensions."
                )
            dim = _move_to_end(dim, real_dim)
        ce.check_valid_fft_coords(daft, dim)
    return dim


def _ifft_resolved(daft: LabeledArray, spacing_tol, dim, real_dim, shift,
                   true_phase, true_amplitude, prefix, lag,
                   chunks_to_segments=False, engine=None) -> LabeledArray:
    """The body of :func:`ifft` once ``dim`` is ordered and ``lag`` holds one
    number per dim (``xrft_tpu/transform.py:480-615``)."""
    if true_phase:
        # the phase factors in numpy.result_type(dtype, complex64), as
        # xrft_tpu builds them
        cdtype = complex_dtype(daft.dtype, "numpy")
        for d, l in zip(dim, lag):
            if float(l) == 0.0:
                continue  # exp(0) = 1: skip the identity multiply pass
            with telemetry.span("prologue"):
                c = _dim_coord(daft, d)
                theta = 2.0 * np.pi * c.values * float(l)
                phase = telemetry.to_device(
                    np.cos(theta) + 1j * np.sin(theta), dtype=cdtype,
                    device=daft.device)
                pl = LabeledArray(phase, dims=(d,),
                                  coords={d: c} if d in daft.coords else None)
                daft = daft * pl

    if chunks_to_segments:
        daft = _stack_segments(daft, dim)

    rawdims = daft.dims

    if real_dim is not None:
        daft = daft.transpose(*_move_to_end(list(daft.dims), real_dim))

    axis_num = [daft.get_axis_num(d) for d in dim]
    N = [daft.shape[n] for n in axis_num]

    with telemetry.span("coords"):
        # Sort by coordinates.  A frequency order that is a cyclic roll of
        # ascending order (natural fftfreq order is the common case) moves
        # no data here: the coordinates are reordered on the host and the
        # data roll composes with the input ifftshift below, into nothing
        # at all for natural order.  Other permutations, and the one-sided
        # real axis, are sorted on the device.
        sort_rolls: dict[str, int] = {}
        device_sort = []
        for d in dim:
            if d not in daft.coords:
                continue
            v = daft.coords[d].values
            n_d = v.shape[0]
            order = np.argsort(v, kind="stable")
            if np.array_equal(order, np.arange(n_d)):
                continue
            k0 = int(order[0])
            if d != real_dim and \
                    np.array_equal(order, (np.arange(n_d) + k0) % n_d):
                sort_rolls[d] = k0
                for cname, c in list(daft.coords.items()):
                    if d in c.dims:
                        daft = daft.assign_coords({cname: c.copy(
                            values=np.take(c.values, order,
                                           axis=c.dims.index(d)))})
            else:
                device_sort.append(d)
        if device_sort:
            daft = daft.sortby(device_sort)

        delta_x = [
            ce.get_coordinate_spacing(_dim_coord(daft, d), spacing_tol)
            for d in dim
        ]
        for d in dim:
            c = _dim_coord(daft, d)
            l = ce.lag_coord(c) if d != real_dim else c.values[0]
            if np.abs(l) > spacing_tol:
                raise ValueError(
                    "Inverse Fourier Transform can not be computed because "
                    f"coordinate {d} is not centered on zero frequency"
                )

    with telemetry.span("fft"):
        # input shift per non-real axis: the ifftshift (a roll by -(n//2))
        # composed with any deferred sort roll (a roll by -k0); a total of 0
        # moves nothing, otherwise one roll replaces the sort
        axis_shift = []
        data = daft.data
        for d in dim:
            if d == real_dim:
                continue
            ax = daft.get_axis_num(d)
            if d in sort_rolls:
                n_d = daft.shape[ax]
                amt = (-(sort_rolls[d] + n_d // 2)) % n_d
                if amt == (-(n_d // 2)) % n_d:
                    axis_shift.append(ax)
                elif amt:
                    data = shards.roll(
                        data, {ax: amt if amt <= n_d // 2 else amt - n_d})
            else:
                axis_shift.append(ax)

        # output shift: fftshift o ifftshift is the identity, so three cases
        if true_phase and shift:
            post_axes, post_kind = axis_num, "fftshift"
        elif (not true_phase) and (not shift):
            post_axes, post_kind = axis_num, "ifftshift"
        else:
            post_axes, post_kind = (), "fftshift"

        f = _run_core(data, axis_num, "ifft" if real_dim is None else "irfft",
                      engine, pre_shift_axes=axis_shift,
                      post_shift_axes=post_axes, post_kind=post_kind)

    with telemetry.span("coords"):
        k = ce.ifreq_grids(N, delta_x, real_dim is not None, shift)

        swap = {d: ce.freq_dim_name(d, prefix) for d in dim}
        out_dims = [swap.get(d, d) for d in daft.dims]
        out_coords = {cname: c.copy() for cname, c in daft.coords.items()
                      if cname not in dim}
        out_spacing = []
        for d, kk, l in zip(dim, k, lag):
            spacing = kk[1] - kk[0]
            out_spacing.append(spacing)
            out_coords[swap[d]] = Coord((swap[d],), kk + l,
                                        {"spacing": spacing}, swap[d])

        out = LabeledArray(f, dims=out_dims, coords=out_coords,
                           name=daft.name)

    if true_amplitude:
        with telemetry.span("epilogue"):
            out = out / float(np.prod(out_spacing))

    out.name = daft.name
    return out.transpose(*[swap.get(d, d) for d in rawdims])


def dft(da, dim=None, true_phase=False, true_amplitude=False, **kwargs):
    """Deprecated alias of :func:`fft` with the legacy phase and amplitude
    defaults (``xrft_tpu.dft``)."""
    warnings.warn(
        "This function has been renamed and will disappear in the future. "
        "Please use `fft` instead",
        FutureWarning,
    )
    return fft(da, dim=dim, true_phase=true_phase,
               true_amplitude=true_amplitude, **kwargs)


def idft(daft, dim=None, true_phase=False, true_amplitude=False, **kwargs):
    """Deprecated alias of :func:`ifft` with the legacy phase and amplitude
    defaults (``xrft_tpu.idft``)."""
    warnings.warn(
        "This function has been renamed and will disappear in the future. "
        "Please use `ifft` instead",
        FutureWarning,
    )
    return ifft(daft, dim=dim, true_phase=true_phase,
                true_amplitude=true_amplitude, **kwargs)
