"""Power and cross spectra, cross phase, and their scaling rules.

Counterpart of ``xrft_tpu/spectra.py:29-83,109-411,473-675`` (xrft's
``xrft/xrft.py:649-874``).  For real input with two or more transform dims,
the last dim is computed one-sided (rfft) and the two-sided grid is rebuilt
by Hermitian symmetry (conjugated for a cross spectrum).  When the two
transform dims of a power spectrum are the array's trailing two and
``config.psd_mirror_impl == "kernel"``, |F|^2, the scale, the fftshift and
the mirror are one pass of kernel K1 (:mod:`.ops.mirror`); every other
geometry, every cross spectrum, and ``"plain"`` take the general expansion
:func:`_hermitian_expand`.  ``engine="hp"`` routes both spectra to
:mod:`.highprec`.

Sharded data (the pencil engine of :mod:`.parallel`) take the same routes on
each rank's block: K1 runs on the local block when the pencil chain's
planned final layout leaves the two transform axes resident (or sharded
over mesh axes of one rank), and the general expansion otherwise, with its mirror gathers made explicit
(:mod:`.ops.shards`).
"""

from __future__ import annotations

import warnings

import numpy as np
import torch

from . import coords as ce
from . import telemetry
from .config import MIRROR_IMPLS, config
from .labeled import Coord, LabeledArray
from .ops import mirror, shards
from .ops.window import correction_factor, warn_if_true
from .transform import _dim_coord, _real_flag_warning, _stack_segments, fft

__all__ = ["power_spectrum", "cross_spectrum", "cross_phase", "coherence",
           "spectrogram", "welch", "csd", "periodogram"]


def _abs2(x: torch.Tensor) -> torch.Tensor:
    return x.real ** 2 + x.imag ** 2


def _window_correction_factor(da, dim, scaling, window) -> float:
    """density -> mean(window^2); spectrum -> mean(window)^2
    (``xrft/xrft.py:649-660``), in float64 on the host from the window's
    1-D factors (``ops/window.correction_factor``)."""
    warn_if_true(window)
    corr = correction_factor(da, _norm_dim_list(da, dim), window, scaling)
    if scaling in ("density", "spectrum"):
        return corr
    raise ValueError(f"Unknown {scaling} scaling flag")


def _psd_scaling_factor(ps, dims, scaling):
    """density -> prod(freq spacing); spectrum -> prod(freq spacing)^2
    (``xrft/xrft.py:663-670``)."""
    fs = np.prod([float(ps.coords[d].attrs["spacing"]) for d in dims])
    if scaling == "density":
        return fs
    elif scaling == "spectrum":
        return fs**2
    raise ValueError(f"Unknown {scaling} scaling flag")


def _doubling_vector(n):
    """One-sided doubling over the ``n//2 + 1`` rfft bins: 2 everywhere
    except DC (and Nyquist when ``n`` even) (``xrft/xrft.py:673-682``)."""
    f = np.full(n // 2 + 1, 2.0)
    f[0] = 1.0
    if n % 2 == 0:
        f[-1] = 1.0
    return f


def _psd_real_dim_scaling(da, ps, real_dim, updated_dims):
    """One-sided spectrum doubling on the real freq axis, as a broadcast
    LabeledArray in the PSD's dtype on its device.  Under
    ``chunks_to_segments`` ``da`` arrives stacked, so the Nyquist parity is
    the segment length's (the JAX package's deliberate divergence from
    xrft, ``xrft_tpu/spectra.py:69-82``)."""
    real = next(d for d in updated_dims if d.endswith(real_dim))
    f = telemetry.to_device(_doubling_vector(da.sizes[real_dim]),
                            dtype=ps.dtype, device=ps.device)
    return LabeledArray(f, dims=(real,), coords={real: ps.coords[real]})


def _maybe_stack_segments(das, dim, kwargs):
    """Cut ``chunks_to_segments`` once up front, so that downstream the
    segment dims are batch dims and every size-derived factor (density df,
    one-sided doubling, window correction) is per segment
    (``xrft_tpu/spectra.py:85-106``).  Returns (the stacked arrays, the
    dim list pinned before the segment dims exist, kwargs without the
    segment keywords)."""
    if not kwargs.get("chunks_to_segments"):
        if kwargs.get("segment_overlap") is not None:
            raise ValueError(
                "segment_overlap requires chunks_to_segments=True"
            )
        return das, dim, kwargs
    dim = _norm_dim_list(das[0], dim)
    overlap = kwargs.get("segment_overlap")
    das = tuple(_stack_segments(da, dim, overlap=overlap) for da in das)
    kwargs = {k: v for k, v in kwargs.items()
              if k not in ("chunks_to_segments", "segment_overlap")}
    return das, dim, kwargs


def _pop_density(kwargs, fname, scaling):
    if "density" in kwargs:
        density = kwargs.pop("density")
        warnings.warn(
            f"density flag will be deprecated in future version of "
            f"xrft_tpu.{fname} and replaced by scaling flag. "
            'density=True should be replaced by scaling="density" and '
            "density=False will not be maintained.\nscaling flag is ignored !",
            FutureWarning,
        )
        scaling = "density" if density else "false_density"
    return kwargs, scaling


def _norm_dim_list(da, dim):
    if dim is None:
        return list(da.dims)
    if isinstance(dim, str):
        return [dim]
    return list(dim)


def _is_hp(engine) -> bool:
    """``engine`` asks for the float64 path: "hp", or the pencil engine
    built for it (``parallel.api``)."""
    return engine == "hp" or getattr(engine, "precision", None) == "hp"


def _half_spectrum_dim(da, dim, real_dim, engine=None):
    """The transform dim to compute one-sided for a two-sided power spectrum
    of real data (Hermitian symmetry halves the work on every other
    transform axis), or None.  Under the pencil engine the half dim must be
    unsharded and trailing (``xrft_tpu/spectra.py:147-153``)."""
    if real_dim is not None or da.dtype.is_complex:
        return None
    dims = _norm_dim_list(da, dim)
    if len(dims) < 2:
        return None
    half = dims[-1]
    if callable(engine):
        dim_shards = getattr(engine, "dim_shards", None)
        if dim_shards is None or dim_shards.get(half) or da.dims[-1] != half:
            return None
    return half


def _planned_sharding(da, dims, half_dim, engine) -> dict:
    """{array axis: mesh axis} of the one-sided transform's output that are
    split across ranks: the pencil chain's planned final layout under the
    pencil engine (``xrft_tpu/spectra.py:203-225``) less the mesh axes of
    one rank, whose block is the whole axis; nothing otherwise."""
    if not callable(engine):
        return {}
    from .parallel.mesh import axis_links
    from .parallel.pencil import plan_forward_layout

    mesh = engine.mesh
    sizes = shards.mesh_shape(mesh)
    axis_sharding = {i: engine.dim_shards[d] for i, d in enumerate(da.dims)
                     if engine.dim_shards.get(d)}
    chain = [da.get_axis_num(d) for d in dims if d != half_dim]
    _, final = plan_forward_layout(
        da.shape, chain, axis_sharding, sizes,
        banned=(len(da.dims) - 1,), axis_links=axis_links(mesh))
    return {a: m for a, m in final.items() if sizes[m] > 1}


def _hermitian_expand(half, daft, da, dims, half_dim, kwargs, shift,
                      conj_mirror=False):
    """Expand a one-sided array (PSD or cross spectrum) over the half axis
    to the full two-sided grid via Hermitian symmetry, with the shift
    conventions already applied on the non-half axes:

        X[k_o, k] == conj(X[-k_o mod n_o, n - k])

    (``conj_mirror``; the conjugation is a no-op for real PSDs).

    Output position o on the (possibly shifted) half axis reads unshifted
    frequency k = (o - h) mod n; k <= n//2 is one-sided column k, otherwise
    column n - k with every other transform axis negated, which on its
    (possibly shifted) grid is the permutation o -> (2h - o) mod n.  Index
    maps are host constants; the data moves by ``index_select``.  Any
    geometry (``xrft_tpu/spectra.py:168-272``).

    Sharded data: the half axis is resident (the one-sided route requires
    it), so its gathers are local; a mirrored axis that the chain left
    sharded is gathered explicitly, one exchange (:func:`shards.take`), as
    ``xrft_tpu/spectra.py:249-251`` declares its gather's sharding."""
    n = da.sizes[half_dim]
    fd = {d: ce.freq_dim_name(d, kwargs.get("prefix", "freq_")) for d in dims}
    ax_half = daft.get_axis_num(fd[half_dim])

    h = n // 2 if shift else 0
    ks = (np.arange(n) - h) % n
    mirrored = ks > n // 2
    src = np.where(mirrored, n - ks, ks)

    full = shards.take(half, ax_half, src)
    pos = np.nonzero(mirrored)[0]
    if pos.size:
        piece = shards.take(full, ax_half, pos)
        for d in dims:
            if d == half_dim:
                continue
            na = daft.sizes[fd[d]]
            ha = na // 2 if shift else 0
            piece = shards.take(piece, daft.get_axis_num(fd[d]),
                                (2 * ha - np.arange(na)) % na)
        piece = shards.local(piece)
        if conj_mirror:
            # materialised, so the copy never meets a lazy conj view
            piece = torch.conj_physical(piece)
        # the piece has the block layout of full: one local copy
        shards.local(full).index_copy_(
            ax_half, telemetry.to_device(pos, device=piece.device), piece)

    return LabeledArray(full, dims=daft.dims,
                        coords=_two_sided_coords(daft, da, dims, half_dim,
                                                 kwargs, shift, n),
                        name=da.name)


def _two_sided_coords(daft, da, dims, half_dim, kwargs, shift, n_full):
    """Coordinates of the full two-sided grid rebuilt from a one-sided
    `daft` (shared by the kernel and plain mirror routes)."""
    with telemetry.span("coords"):
        fd = {d: ce.freq_dim_name(d, kwargs.get("prefix", "freq_"))
              for d in dims}
        delta = [
            ce.get_coordinate_spacing(_dim_coord(da, d),
                                      kwargs.get("spacing_tol", 1e-3))
            for d in dims
        ]
        sizes = [n_full if d == half_dim else da.sizes[d] for d in dims]
        grids = ce.freq_grids(sizes, delta, False, shift)
        out_coords = {c: v.copy() for c, v in daft.coords.items()
                      if c not in fd.values()}
        for d, g in zip(dims, grids):
            out_coords[fd[d]] = Coord((fd[d],), g, {"spacing": g[1] - g[0]},
                                      fd[d])
        return out_coords


def _mirror_kernel_applicable(da, dims, half_dim) -> bool:
    """True when kernel K1 expands this request: ``psd_mirror_impl`` is
    "kernel", exactly two transform dims, the half dim trailing and the
    other one immediately left of it, real data (``xrft_tpu/spectra.py:
    294-320`` without the TPU's size limits): the transform takes integer
    data to float32 or float64, so K1 gets complex64 or complex128."""
    impl = config.psd_mirror_impl
    if impl not in MIRROR_IMPLS:
        raise ValueError(f"unknown psd_mirror_impl {impl!r}; expected one "
                         f"of {MIRROR_IMPLS}")
    if impl == "plain" or len(dims) != 2:
        return False
    od = da.dims
    other = [d for d in dims if d != half_dim][0]
    return (len(od) >= 2 and od[-1] == half_dim and od[-2] == other
            and not da.dtype.is_complex)


def _power_spectrum_via_rfft(da, dim, half_dim, kwargs, prescale=None):
    """|F|^2 on the full grid from the one-sided transform of real input,
    mirrored by Hermitian symmetry:

        |F[k_o, k]|^2 == |F[-k_o mod n_o, n - k]|^2

    The density/window scalars (``prescale``) and true_amplitude's
    prod(dx)^2 fold into the |.|^2 pass."""
    dims = _norm_dim_list(da, dim)
    shift = kwargs.pop("shift", True)
    n_full = da.sizes[half_dim]
    kwargs["true_amplitude"] = False
    amp2 = _amp2(da, dims, kwargs)
    scale = amp2 if prescale is None else amp2 * prescale

    planned = _planned_sharding(da, dims, half_dim, kwargs.get("engine"))
    if _mirror_kernel_applicable(da, dims, half_dim) and \
            not {len(da.dims) - 2, len(da.dims) - 1} & set(planned):
        # K1 takes the unshifted half spectrum and does the y-fftshift
        # itself; sharded data run it on each rank's block, whose two
        # transform axes are resident
        daft = fft(da, dim=dims, real_dim=half_dim, shift=False, **kwargs)
        with telemetry.span("epilogue"):
            full = shards.like(daft.data, mirror.mirror_psd(
                shards.local(daft.data).contiguous(), n_full, shift, scale))
        return LabeledArray(
            full, dims=daft.dims,
            coords=_two_sided_coords(daft, da, dims, half_dim, kwargs,
                                     shift, n_full),
            name=da.name)

    daft = fft(da, dim=dims, real_dim=half_dim, shift=shift,
               _shift_nonreal=True, **kwargs)
    with telemetry.span("epilogue"):
        ps_half = _abs2(daft.data) * scale
        return _hermitian_expand(ps_half, daft, da, dims, half_dim, kwargs,
                                 shift)


def _amp2(da, dims, kwargs) -> float:
    """true_amplitude's prod(dx)^2, folded into the |.|^2 pass."""
    with telemetry.span("coords"):
        return float(np.prod([
            ce.get_coordinate_spacing(_dim_coord(da, d),
                                      kwargs.get("spacing_tol", 1e-3))
            for d in dims])) ** 2


def _density_prescale(da, dim, scaling, window_correction, kwargs):
    """Scalar folded into the |.|^2 pass of the one-sided route: the
    window-correction divisor and the density (prod df) / spectrum (prod df
    squared) factor; None for ``false_density``
    (``xrft/xrft.py:649-670,745-748``)."""
    if scaling == "false_density":
        return None
    pre = 1.0
    if window_correction:
        pre = 1.0 / _window_correction_factor(da, dim, scaling,
                                              kwargs.get("window"))
    fs = 1.0
    with telemetry.span("coords"):
        for d in _norm_dim_list(da, dim):
            delta = ce.get_coordinate_spacing(
                _dim_coord(da, d), kwargs.get("spacing_tol", 1e-3))
            fs *= 1.0 / (da.sizes[d] * delta)
    return pre * (fs if scaling == "density" else fs**2)


def _cross_spectrum_via_rfft(da1, da2, dim, half_dim, kwargs, prescale,
                             true_phase):
    """F1 * conj(F2) on the full grid from the one-sided transforms of two
    real inputs, mirrored with conjugation:

        C[k_o, k] == conj(C[-k_o mod n_o, n - k])

    which holds with the true_phase factors too (conj(e^{-it}) = e^{+it})
    (``xrft_tpu/spectra.py:473-512``, its generic route)."""
    dims = _norm_dim_list(da1, dim)
    shift = kwargs.pop("shift", True)
    kwargs["true_amplitude"] = False
    amp2 = _amp2(da1, dims, kwargs)
    daft1, daft2 = (fft(da, dim=dims, real_dim=half_dim, shift=shift,
                        _shift_nonreal=True, true_phase=true_phase, **kwargs)
                    for da in (da1, da2))
    with telemetry.span("epilogue"):
        cs_half = daft1.data * daft2.data.conj()
        cs_half = cs_half * (amp2 if prescale is None else amp2 * prescale)
        out = _hermitian_expand(cs_half, daft1, da1, dims, half_dim, kwargs,
                                shift, conj_mirror=True)
    out.name = None
    return out


def power_spectrum(
    da: LabeledArray,
    dim=None,
    real_dim=None,
    scaling="density",
    window_correction=False,
    **kwargs,
) -> LabeledArray:
    """Power spectrum of `da`: |F(da)|^2 with amplitude-true scaling, as
    ``xrft_tpu.power_spectrum``.

    scaling: 'density' normalizes to power spectral density, 'spectrum' to
    power spectrum (peak amplitudes).  window_correction=True divides by the
    window's energy (density) or squared mean (spectrum), matching
    scipy.signal.welch/periodogram conventions.  Other keywords go to
    :func:`~xrft_tpu_torch.transform.fft`.
    """
    kwargs, scaling = _pop_density(kwargs, "power_spectrum", scaling)

    if "real" in kwargs:
        real_dim = kwargs.get("real")
        warnings.warn(_real_flag_warning, FutureWarning)

    if _is_hp(kwargs.get("engine")):
        from .highprec import power_spectrum_hp

        if kwargs.get("engine") == "hp":
            kwargs.pop("engine")
        kwargs.pop("real", None)
        return power_spectrum_hp(da, dim=dim, real_dim=real_dim,
                                 scaling=scaling,
                                 window_correction=window_correction,
                                 **kwargs)

    # true_phase does not matter for |F|^2; forced off to skip phase work
    kwargs.update({"true_amplitude": True, "true_phase": False})

    (da,), dim, kwargs = _maybe_stack_segments((da,), dim, kwargs)

    half = _half_spectrum_dim(da, dim, real_dim, kwargs.get("engine"))
    if half is not None:
        prescale = _density_prescale(da, dim, scaling, window_correction,
                                     kwargs)
        return _power_spectrum_via_rfft(da, dim, half, kwargs, prescale)

    daft = fft(da, dim=dim, real_dim=real_dim, **kwargs)
    updated_dims = [d for d in daft.dims
                    if d not in da.dims and "segment" not in d]
    with telemetry.span("epilogue"):
        ps = daft.copy(data=_abs2(daft.data))
        ps.attrs = {}

        if real_dim is not None:
            ps = ps * _psd_real_dim_scaling(da, ps, real_dim, updated_dims)

        if scaling != "false_density":
            if window_correction:
                ps = ps / _window_correction_factor(
                    da, dim, scaling, kwargs.get("window")
                )
            ps = ps * _psd_scaling_factor(ps, updated_dims, scaling)

    return ps


def cross_spectrum(
    da1: LabeledArray,
    da2: LabeledArray,
    dim=None,
    real_dim=None,
    scaling="density",
    window_correction=False,
    true_phase=True,
    **kwargs,
) -> LabeledArray:
    """Cross spectrum F(da1) * conj(F(da2)) with the scaling rules of
    :func:`power_spectrum`; true_phase defaults True here, as in
    ``xrft_tpu.cross_spectrum``.  Two real inputs take the one-sided
    transform and the conjugated Hermitian expansion; the result has no
    name."""
    if "real" in kwargs:
        real_dim = kwargs.get("real")
        warnings.warn(_real_flag_warning, FutureWarning)

    kwargs, scaling = _pop_density(kwargs, "cross_spectrum", scaling)
    kwargs.update({"true_amplitude": True})

    if _is_hp(kwargs.get("engine")):
        from .highprec import cross_spectrum_hp

        if kwargs.get("engine") == "hp":
            kwargs.pop("engine")
        kwargs.pop("real", None)
        return cross_spectrum_hp(da1, da2, dim=dim, real_dim=real_dim,
                                 scaling=scaling,
                                 window_correction=window_correction,
                                 true_phase=true_phase, **kwargs)

    if tuple(da1.dims) != tuple(da2.dims):
        raise ValueError("The two datasets have different dimensions")

    (da1, da2), dim, kwargs = _maybe_stack_segments((da1, da2), dim, kwargs)

    engine = kwargs.get("engine")
    half = _half_spectrum_dim(da1, dim, real_dim, engine)
    if half is not None and \
            _half_spectrum_dim(da2, dim, real_dim, engine) == half:
        prescale = _density_prescale(da1, dim, scaling, window_correction,
                                     kwargs)
        return _cross_spectrum_via_rfft(da1, da2, dim, half, kwargs,
                                        prescale, true_phase)

    daft1 = fft(da1, dim=dim, real_dim=real_dim, true_phase=true_phase,
                **kwargs)
    daft2 = fft(da2, dim=dim, real_dim=real_dim, true_phase=true_phase,
                **kwargs)

    updated_dims = [d for d in daft1.dims
                    if d not in da1.dims and "segment" not in d]
    with telemetry.span("epilogue"):
        cs = daft1 * daft2.conj()

        if real_dim is not None:
            cs = cs * _psd_real_dim_scaling(da1, cs, real_dim, updated_dims)

        if scaling != "false_density":
            if window_correction:
                cs = cs / _window_correction_factor(
                    da1, dim, scaling, kwargs.get("window")
                )
            cs = cs * _psd_scaling_factor(cs, updated_dims, scaling)

    return cs


def cross_phase(da1, da2, dim=None, true_phase=True, **kwargs) -> LabeledArray:
    """Phase of the cross spectrum, in [-pi, pi] (``xrft_tpu.cross_phase``)."""
    cs = cross_spectrum(da1, da2, dim=dim, true_phase=true_phase, **kwargs)
    cp = cs.copy(data=torch.angle(cs.data))
    if da1.name and da2.name:
        cp.name = f"{da1.name}_{da2.name}_phase"
    return cp


def coherence(da1, da2, dim=None, real_dim=None, window="hann",
              true_phase=False, **kwargs) -> LabeledArray:
    """Magnitude-squared coherence ``|<Pxy>|^2 / (<Pxx><Pyy>)``, the
    Welch-averaged scipy.signal.coherence estimate (``xrft_tpu.coherence``):
    the three estimates share the window and segment settings and are
    averaged over every ``<dim>_segment`` axis before the ratio.  Without
    segments the estimate is identically 1, with a warning."""
    est = dict(dim=dim, real_dim=real_dim, window=window, **kwargs)
    pxx = power_spectrum(da1, **est)
    pyy = power_spectrum(da2, **est)
    pxy = cross_spectrum(da1, da2, true_phase=true_phase, **est)
    return _coherence_from_estimates(pxx, pyy, pxy, da1.name, da2.name)


def spectrogram(da, dim=None, seglen=None, segment_overlap=None,
                window="hann", detrend="constant", scaling="density",
                window_correction=True, real_dim="auto",
                **kwargs) -> LabeledArray:
    """Short-time power spectral density over sliding segments, the
    scipy.signal.spectrogram estimate (``xrft_tpu.spectrogram``): a
    per-segment one-sided PSD along ``dim`` (two-sided for complex data)
    whose ``<dim>_segment`` coordinate holds the segment centres
    ``x0 + (k*hop + seglen/2) * dx`` in the coordinate's own type.
    ``seglen`` is nperseg (default: a declared chunk length),
    ``segment_overlap`` noverlap (samples or a fraction; None is
    ``seglen // 8``); trailing samples that fill no segment are dropped
    with a warning."""
    da, dim, seglen, ov = _stft_plan(da, dim, seglen, segment_overlap, 8,
                                     "spectrogram")
    if real_dim == "auto":
        real_dim = dim if _is_real_input(da) else None
    hop = seglen - ov

    coord = _dim_coord(da, dim)
    ce.get_coordinate_spacing(coord, kwargs.get("spacing_tol", 1e-3))
    # signed spacing of the stored coordinate: segments follow storage order
    dx = float(ce.diff_coord(coord)[0])

    ps = power_spectrum(
        da, dim=[dim], real_dim=real_dim, scaling=scaling,
        window_correction=window_correction, window=window,
        detrend=detrend, chunks_to_segments=True,
        segment_overlap={dim: ov} if ov else None, **kwargs)

    segdim = dim + "_segment"
    nseg = ps.sizes[segdim]
    centers = _segment_centers(coord, nseg, hop, seglen, dx)
    out = ps.assign_coords(
        {segdim: Coord(segdim, centers, attrs={"spacing": hop * dx},
                       name=segdim)})
    out.name = f"{da.name}_spectrogram" if da.name else None
    return out


def _segment_centers(coord, nseg, hop, seglen, dx):
    """Segment-centre values in the coordinate's own type: floats for
    numeric coordinates, datetime64 or cftime for time-like ones (``dx`` is
    in seconds for those) (``xrft_tpu/spectra.py:761-779``)."""
    vals = np.asarray(coord.values)
    offsets = (np.arange(nseg) * hop + seglen / 2.0) * dx
    if np.issubdtype(vals.dtype, np.datetime64):
        t0 = vals.ravel()[0].astype("datetime64[ns]")
        return t0 + np.round(offsets * 1e9).astype("timedelta64[ns]")
    if ce._is_cftime(vals):
        import datetime

        t0 = vals.flat[0]
        return np.array(
            [t0 + datetime.timedelta(seconds=float(o)) for o in offsets],
            dtype=object)
    return float(vals.ravel()[0]) + offsets


def _is_real_input(da) -> bool:
    """scipy's real-input test: any non-complex dtype, float or integer."""
    return not da.dtype.is_complex and da.dtype != torch.bool


def _norm_1d_dim(da, dim, caller) -> str:
    """The single sliding-segment dim (None: the last dim)."""
    if dim is None:
        return da.dims[-1]
    if isinstance(dim, str):
        return dim
    dim = list(dim)
    if len(dim) != 1:
        raise ValueError(
            f"{caller} is a 1-D sliding-segment estimate; got "
            f"dim={dim!r} (transform other dims with power_spectrum)"
        )
    return dim[0]


def _stft_plan(da, dim, seglen, segment_overlap, default_div, caller):
    """The sliding-segment prologue of spectrogram, welch, csd and stft
    (``xrft_tpu/spectra.py:804-854``): the dim, the segment length
    (``seglen`` or a declared chunk, clamped to the input length with a
    warning), the overlap (None: ``seglen // default_div``) and, at zero
    overlap, the scipy tail drop.  Returns (da, dim, seglen, overlap)."""
    dim = _norm_1d_dim(da, dim, caller)

    if seglen is not None:
        da = da.chunk({dim: int(seglen)})
    chunks = da.chunks or {}
    if dim not in chunks:
        raise ValueError(
            f"{caller} needs a segment length: pass seglen= or declare "
            "one with da.chunk({dim: seglen}) first"
        )
    seglen = int(chunks[dim])
    if seglen > da.sizes[dim]:
        warnings.warn(
            f"seglen = {seglen} is greater than input length = "
            f"{da.sizes[dim]}, using seglen = {da.sizes[dim]}"
        )
        seglen = da.sizes[dim]
        da = da.chunk({dim: seglen})

    ov = segment_overlap
    if ov is None:
        ov = seglen // default_div
    if isinstance(ov, float):
        if not 0.0 <= ov < 1.0:
            raise ValueError(
                f"fractional segment_overlap must be in [0, 1), got {ov}"
            )
        ov = int(round(ov * seglen))

    n = da.sizes[dim]
    if ov == 0 and n % seglen:
        keep = (n // seglen) * seglen
        warnings.warn(
            f"{caller} drops the last {n - keep} samples of dim "
            f"{dim!r} (scipy convention)"
        )
        da = da.isel({dim: slice(0, keep)}).chunk({dim: seglen})
    return da, dim, seglen, ov


def welch(da, dim=None, seglen=None, segment_overlap=None, window="hann",
          detrend="constant", scaling="density", window_correction=True,
          real_dim="auto", **kwargs) -> LabeledArray:
    """Welch PSD estimate, the scipy.signal.welch convenience
    (``xrft_tpu.welch``): ``power_spectrum(..., chunks_to_segments=True)``
    averaged over ``<dim>_segment``.  scipy's defaults: ``seglen // 2``
    overlap, hann, constant detrend, window correction, one-sided for real
    input; a partial last segment is dropped and a too-long ``seglen``
    clamped, each with a warning.  Composes with ``engine="hp"`` and extra
    batch dims."""
    return _welch_impl(power_spectrum, da, dim, seglen, segment_overlap,
                       window, detrend, scaling, window_correction, real_dim,
                       kwargs)


def _welch_impl(power_fn, da, dim, seglen, segment_overlap, window, detrend,
                scaling, window_correction, real_dim, kwargs) -> LabeledArray:
    """The Welch estimate shared by :func:`welch` and
    ``parallel.sharded_welch`` (``xrft_tpu/spectra.py:857-885``):
    ``power_fn`` is the power spectrum to average."""
    da, dim, seglen, ov = _stft_plan(da, dim, seglen, segment_overlap, 2,
                                     "welch")
    if real_dim == "auto":
        real_dim = dim if _is_real_input(da) else None
    ps = power_fn(
        da, dim=[dim], real_dim=real_dim, scaling=scaling,
        window_correction=window_correction, window=window,
        detrend=detrend, chunks_to_segments=True,
        segment_overlap={dim: ov} if ov else None, **kwargs)
    # a plain mean; on the hp path a float64 one, which needs none of the
    # JAX package's double-word compensation (xrft_tpu/spectra.py:857-885)
    out = ps.mean(dim + "_segment")
    out.name = f"{da.name}_welch" if da.name else None
    return out


def _zero_pad_to(da, dim, target) -> LabeledArray:
    """``da`` zero-padded along ``dim`` to ``target`` samples, the
    coordinate extrapolated (scipy.signal.csd pads the shorter input)."""
    from .padding import pad as _pad

    out = _pad(da, {dim: (0, target - da.sizes[dim])}, mode="constant")
    # the pad is part of the estimate, not a step unpad should undo
    out.coords[dim].attrs.pop("pad_width", None)
    return out


def csd(da1, da2, dim=None, seglen=None, segment_overlap=None,
        window="hann", detrend="constant", scaling="density",
        window_correction=True, real_dim="auto", true_phase=False,
        **kwargs) -> LabeledArray:
    """Cross power spectral density, the scipy.signal.csd convenience
    (``xrft_tpu.csd``): the Welch-averaged cross spectrum with scipy's
    defaults, one-sided iff both inputs are real, the shorter input
    zero-padded to the longer.  It follows scipy's conjugation,
    ``conj(F(x)) F(y)``, so it is the conjugate of the averaged
    :func:`cross_spectrum`."""
    return _csd_impl(cross_spectrum, da1, da2, dim, seglen, segment_overlap,
                     window, detrend, scaling, window_correction, real_dim,
                     true_phase, kwargs)


def _csd_impl(cross_fn, da1, da2, dim, seglen, segment_overlap, window,
              detrend, scaling, window_correction, real_dim, true_phase,
              kwargs) -> LabeledArray:
    """The csd estimate shared by :func:`csd` and ``parallel.sharded_csd``:
    ``cross_fn`` is the cross spectrum to average."""
    if tuple(da1.dims) != tuple(da2.dims):
        raise ValueError("da1 and da2 must have the same dimensions!")
    dim = _norm_1d_dim(da1, dim, "csd")
    n1, n2 = da1.sizes[dim], da2.sizes[dim]
    if n1 < n2:
        da1 = _zero_pad_to(da1, dim, n2)
    elif n2 < n1:
        da2 = _zero_pad_to(da2, dim, n1)
    da1, dim, seglen, ov = _stft_plan(da1, dim, seglen, segment_overlap, 2,
                                      "csd")
    if da2.sizes[dim] != da1.sizes[dim]:  # da1's zero-overlap tail drop
        da2 = da2.isel({dim: slice(0, da1.sizes[dim])})
    da2 = da2.chunk({dim: seglen})
    if real_dim == "auto":
        real_dim = dim if (_is_real_input(da1)
                           and _is_real_input(da2)) else None
    cs = cross_fn(
        da1, da2, dim=[dim], real_dim=real_dim, scaling=scaling,
        window_correction=window_correction, window=window,
        detrend=detrend, chunks_to_segments=True, true_phase=true_phase,
        segment_overlap={dim: ov} if ov else None, **kwargs)
    out = cs.mean(dim + "_segment")
    out = out.copy(data=out.data.conj())
    out.name = (f"{da1.name}_{da2.name}_csd"
                if da1.name and da2.name else None)
    return out


def periodogram(da, dim=None, window=None, detrend="constant",
                scaling="density", window_correction=True,
                real_dim="auto", **kwargs) -> LabeledArray:
    """Single-segment PSD, the scipy.signal.periodogram convenience
    (``xrft_tpu.periodogram``): no window, constant detrend (False or None
    disables it), density, one-sided for real input; the window correction
    applies only when a window is asked for."""
    dim = _norm_1d_dim(da, dim, "periodogram")
    if real_dim == "auto":
        real_dim = dim if _is_real_input(da) else None
    if detrend is False:
        detrend = None
    ps = power_spectrum(
        da, dim=[dim], real_dim=real_dim, scaling=scaling,
        window=window, detrend=detrend,
        window_correction=window_correction and window is not None,
        **kwargs)
    ps.name = f"{da.name}_periodogram" if da.name else None
    return ps


def _coherence_from_estimates(pxx, pyy, pxy, name1=None,
                              name2=None) -> LabeledArray:
    """Average the three Welch estimates over their segment dims, then the
    magnitude-squared ratio (``xrft_tpu/spectra.py:1026-1050``)."""
    segdims = [d for d in pxy.dims if d.endswith("_segment")]
    if not segdims:
        warnings.warn(
            "coherence without segment averaging is identically 1; pass "
            "chunks_to_segments=True (and optionally segment_overlap=...) "
            "to average over Welch segments"
        )
    for d in segdims:
        pxy, pxx, pyy = pxy.mean(d), pxx.mean(d), pyy.mean(d)
    coh = pxx.copy(data=_abs2(pxy.data) / (pxx.data * pyy.data))
    coh.name = f"{name1}_{name2}_coherence" if name1 and name2 else None
    return coh
