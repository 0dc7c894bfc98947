"""High-level distributed spectral analysis.

Counterpart of ``xrft_tpu/parallel/api.py``.  ``sharded_fft`` /
``sharded_power_spectrum`` and friends run the full coordinate-aware
pipelines of :mod:`..transform` / :mod:`..spectra` with the input sharded
over a DeviceMesh and the core transform routed through the pencil
decomposition (:mod:`.pencil`).  Batch (non-transform) dims parallelize
with no collective; sharded transform dims use ``all_to_all`` pencil
transposes.  Everything outside the core transform (detrend moments,
window and phase multiplies, scalings, the Hermitian mirror, the radial
binning) runs on each rank's block, its few reductions and gathers explicit
(:mod:`..ops.shards`).

``engine=`` in the keywords names the local FFTs' route for the call
(None/"auto"/"xla"/"matmul", as ``config.engine_impl``), or "hp" for the
float64 path: complex128 through the same chain.
"""

from __future__ import annotations

from .. import spectra, transform
from ..config import engine_impl
from ..labeled import LabeledArray
from ..ops import shards
from .mesh import shard_labeled
from .pencil import pencil_fftn

__all__ = ["sharded_fft", "sharded_power_spectrum",
           "sharded_cross_spectrum", "sharded_cross_phase",
           "sharded_coherence", "sharded_welch", "sharded_csd",
           "sharded_isotropic_power_spectrum",
           "sharded_isotropic_cross_spectrum", "sharded"]


def _make_engine(mesh, dims: tuple, dim_shards: dict, engine=None):
    """A callable core-transform engine bound to a fixed dim order.
    ``engine`` is the caller's per-call engine: a name runs the local FFTs
    under its ``fft_impl``; "hp" moves complex128 through the chain."""
    precision = "hp" if engine == "hp" else None
    name = None if engine == "hp" else engine

    def engine_fn(data, axes, kind, post_shift_axes=(),
                  post_kind="fftshift"):
        axis_sharding = {
            i: dim_shards.get(d) for i, d in enumerate(dims) if d in dim_shards
        }
        with engine_impl(name):
            return pencil_fftn(data, axes, mesh, axis_sharding, kind,
                               precision=precision,
                               post_shift_axes=post_shift_axes,
                               post_kind=post_kind)

    # advertised so spectra's one-sided route can check that the half
    # (rfft) axis is unsharded and reconstruct the forward chain's output
    # layout (pencil.plan_forward_layout) for the mirror; precision routes
    # the spectra to their float64 path
    engine_fn.dim_shards = dict(dim_shards)
    engine_fn.mesh = mesh
    engine_fn.dims = tuple(dims)
    engine_fn.precision = precision
    return engine_fn


def _prepare(da: LabeledArray, mesh, dim_shards, kwargs):
    """Shard `da` per ``dim_shards`` (returns the updated
    ``(da, dim_shards, kwargs)`` triple).

    ``chunks_to_segments=True`` composes with sharded transforms by
    stacking the Welch segments on host metadata FIRST (reference segment
    semantics): each chunked transform dim ``d`` splits into
    ``(d_segment, d)``, the shard spec of a chunked dim moves to its
    segment axis (batch parallelism, no collective), and unchunked sharded
    transform dims keep the pencil path on the full axis."""
    kwargs = dict(kwargs)
    if kwargs.pop("chunks_to_segments", False):
        from ..spectra import _norm_dim_list
        from ..transform import _segment_plan, _stack_segments

        dims = _norm_dim_list(da, kwargs.get("dim"))
        overlap = kwargs.pop("segment_overlap", None)
        plan = _segment_plan(da, dims, overlap=overlap)
        seg_dims = plan[0]
        da = _stack_segments(da, dims, plan=plan)
        # pin the transform dims: downstream must not re-stack or treat
        # the new segment axes as transform dims
        kwargs["dim"] = dims
        sizes = shards.mesh_shape(mesh)
        new_shards = {}
        for d, ax in dim_shards.items():
            seg = d + "_segment"
            nseg = da.sizes.get(seg, 1)
            if d in dims and seg in seg_dims and nseg % sizes[ax] == 0 \
                    and nseg > 1:
                new_shards[seg] = ax
            else:
                # unchunked (single-segment) or indivisible segment count:
                # keep the pencil path on the within-segment axis
                new_shards[d] = ax
        dim_shards = new_shards
    real_dim = kwargs.get("real_dim")
    if real_dim is not None:
        if dim_shards.get(real_dim):
            raise ValueError("the real transform dim must be unsharded")
        # pre-arrange so the transform layer performs no further transposes
        # and array axis positions match da.dims throughout
        order = [d for d in da.dims if d != real_dim] + [real_dim]
        da = da.transpose(*order)
    da = shard_labeled(da, mesh, dim_shards)
    return da, dim_shards, kwargs


def sharded_fft(da: LabeledArray, mesh, dim_shards: dict,
                **fft_kwargs) -> LabeledArray:
    """:func:`xrft_tpu_torch.fft` over a device mesh.

    ``dim_shards``: {dim name: mesh axis}.  Transform dims may be sharded
    (pencil path); batch dims shard freely.
    """
    engine = fft_kwargs.pop("engine", None)
    da, dim_shards, fft_kwargs = _prepare(da, mesh, dim_shards, fft_kwargs)
    return transform.fft(
        da, engine=_make_engine(mesh, da.dims, dim_shards, engine),
        **fft_kwargs)


def sharded_power_spectrum(da: LabeledArray, mesh, dim_shards: dict,
                           **ps_kwargs) -> LabeledArray:
    """:func:`xrft_tpu_torch.power_spectrum` over a device mesh."""
    engine = ps_kwargs.pop("engine", None)
    da, dim_shards, ps_kwargs = _prepare(da, mesh, dim_shards, ps_kwargs)
    return spectra.power_spectrum(
        da, engine=_make_engine(mesh, da.dims, dim_shards, engine),
        **ps_kwargs)


def sharded_cross_spectrum(da1: LabeledArray, da2: LabeledArray, mesh,
                           dim_shards: dict, **cs_kwargs) -> LabeledArray:
    """:func:`xrft_tpu_torch.cross_spectrum` over a device mesh (both
    inputs share the same layout)."""
    engine = cs_kwargs.pop("engine", None)
    da2, _, _ = _prepare(da2, mesh, dim_shards, cs_kwargs)
    da1, shards1, cs_kwargs = _prepare(da1, mesh, dim_shards, cs_kwargs)
    return spectra.cross_spectrum(
        da1, da2, engine=_make_engine(mesh, da1.dims, shards1, engine),
        **cs_kwargs)


def sharded_coherence(da1: LabeledArray, da2: LabeledArray, mesh,
                      dim_shards: dict, **kwargs) -> LabeledArray:
    """:func:`xrft_tpu_torch.coherence` over a device mesh: the three Welch
    estimates run through the sharded estimators (same layout); the segment
    mean and the magnitude-squared ratio run on each rank's block."""
    kwargs.setdefault("window", "hann")
    true_phase = kwargs.pop("true_phase", False)
    pxx = sharded_power_spectrum(da1, mesh, dim_shards, **kwargs)
    pyy = sharded_power_spectrum(da2, mesh, dim_shards, **kwargs)
    pxy = sharded_cross_spectrum(da1, da2, mesh, dim_shards,
                                 true_phase=true_phase, **kwargs)
    return spectra._coherence_from_estimates(pxx, pyy, pxy,
                                             da1.name, da2.name)


def sharded_welch(da: LabeledArray, mesh, dim_shards: dict, dim=None,
                  seglen=None, segment_overlap=None, window="hann",
                  detrend="constant", scaling="density",
                  window_correction=True, real_dim="auto",
                  **kwargs) -> LabeledArray:
    """:func:`xrft_tpu_torch.welch` over a device mesh: the per-segment PSD
    runs through the sharded estimator (the segment axis is batch
    parallelism), the segment mean sums across the ranks that hold
    segments.  Same scipy defaults as the local namesake (one shared implementation)."""
    def power_fn(d, **kw):
        return sharded_power_spectrum(d, mesh, dim_shards, **kw)

    return spectra._welch_impl(power_fn, da, dim, seglen, segment_overlap,
                               window, detrend, scaling,
                               window_correction, real_dim, kwargs)


def sharded_csd(da1: LabeledArray, da2: LabeledArray, mesh,
                dim_shards: dict, dim=None, seglen=None,
                segment_overlap=None, window="hann", detrend="constant",
                scaling="density", window_correction=True,
                real_dim="auto", true_phase=False,
                **kwargs) -> LabeledArray:
    """:func:`xrft_tpu_torch.csd` over a device mesh (scipy's
    conj(F(x))·F(y) convention and zero-padding of a shorter input, like
    the local namesake; one shared implementation)."""
    def cross_fn(d1, d2, **kw):
        return sharded_cross_spectrum(d1, d2, mesh, dim_shards, **kw)

    return spectra._csd_impl(cross_fn, da1, da2, dim, seglen,
                             segment_overlap, window, detrend, scaling,
                             window_correction, real_dim, true_phase,
                             kwargs)


def sharded_isotropic_power_spectrum(da: LabeledArray, mesh,
                                     dim_shards: dict,
                                     **iso_kwargs) -> LabeledArray:
    """:func:`xrft_tpu_torch.isotropic_power_spectrum` over a device mesh.

    The PSD runs through the pencil engine; the radial binning runs on each
    rank's block (K3 on the card when the spectral dims are resident, the
    plain route and one all_reduce when one is sharded)."""
    from ..isotropic import isotropic_power_spectrum

    engine = iso_kwargs.pop("engine", None)
    da, dim_shards, iso_kwargs = _prepare(da, mesh, dim_shards, iso_kwargs)
    return isotropic_power_spectrum(
        da, engine=_make_engine(mesh, da.dims, dim_shards, engine),
        **iso_kwargs)


def sharded_isotropic_cross_spectrum(da1: LabeledArray, da2: LabeledArray,
                                     mesh, dim_shards: dict,
                                     **kwargs) -> LabeledArray:
    """:func:`xrft_tpu_torch.isotropic_cross_spectrum` over a device mesh
    (the two-input analogue of :func:`sharded_isotropic_power_spectrum`)."""
    from ..isotropic import isotropic_cross_spectrum

    engine = kwargs.pop("engine", None)
    da2, _, _ = _prepare(da2, mesh, dim_shards, kwargs)
    da1, shards1, kwargs = _prepare(da1, mesh, dim_shards, kwargs)
    return isotropic_cross_spectrum(
        da1, da2, engine=_make_engine(mesh, da1.dims, shards1, engine),
        **kwargs)


def sharded_cross_phase(da1: LabeledArray, da2: LabeledArray, mesh,
                        dim_shards: dict, **kwargs) -> LabeledArray:
    """:func:`xrft_tpu_torch.cross_phase` over a device mesh: the cross
    spectrum runs through the pencil engine; ``angle`` is elementwise on
    each rank's block."""
    kwargs.setdefault("true_phase", True)
    cs = sharded_cross_spectrum(da1, da2, mesh, dim_shards, **kwargs)
    cp = cs.copy(data=shards.like(cs.data, shards.local(cs.data).angle()))
    if da1.name and da2.name:
        cp.name = f"{da1.name}_{da2.name}_phase"
    return cp


# ---------------------------------------------------------------------------
# Generic mesh wrapper for every remaining public estimator: functions whose
# transform axis has no pencil decomposition run on each rank's block with
# batch (non-transform) dims sharded, and REJECT a sharded transform dim
# with a prescriptive error instead of silently gathering.
# ---------------------------------------------------------------------------

# estimators with a first-class transform-dim (pencil) route
_PENCIL_ROUTED = {
    "fft": "sharded_fft", "power_spectrum": "sharded_power_spectrum",
    "cross_spectrum": "sharded_cross_spectrum",
    "cross_phase": "sharded_cross_phase", "coherence": "sharded_coherence",
    "welch": "sharded_welch", "csd": "sharded_csd",
    "isotropic_power_spectrum": "sharded_isotropic_power_spectrum",
    "isotropic_cross_spectrum": "sharded_isotropic_cross_spectrum",
}
# of those, the two-input ones (second input is args[0])
_PENCIL_TWO_INPUT = {"cross_spectrum", "cross_phase", "coherence", "csd",
                     "isotropic_cross_spectrum"}
# single-input estimators transforming one dim (default: the last)
_ONE_DIM = {
    "spectrogram", "stft", "hilbert", "envelope", "dct", "idct", "dst",
    "idst", "czt", "zoom_fft", "resample", "resample_poly", "decimate",
    "lombscargle", "fht", "ifht", "periodogram",
}
# single-input estimators transforming a dim list (None -> all dims,
# except hilbert2: the last two)
_MULTI_DIM = {"hilbert2", "dctn", "idctn", "dstn", "idstn"}
# two-input estimators transforming `dims` (default: all shared dims)
_TWO_INPUT = {"convolve", "fftconvolve", "oaconvolve", "correlate"}


def _reject_sharded_transform(name, tdims, dim_shards):
    bad = sorted(set(tdims) & set(dim_shards))
    if bad:
        raise ValueError(
            f"sharded {name}: transform dim(s) {bad} are sharded, but "
            f"{name} has no distributed-transform (pencil) route — shard "
            "batch dims only, or use sharded_fft/sharded_power_spectrum "
            "(and friends) for distributed Fourier transforms."
        )


def _local_labeled(da: LabeledArray) -> LabeledArray:
    """This rank's block of a sharded ``da`` as a plain LabeledArray, its
    coordinates cut to the block."""
    data = da.data
    keys = {da.dims[a]: slice(*shards.local_range(data, a))
            for a in shards.axis_map(data)}
    out = da.copy(data=shards.local(data))
    for cname, c in da.coords.items():
        if any(d in keys for d in c.dims):
            out.coords[cname] = c.copy(values=c.values[
                tuple(keys.get(d, slice(None)) for d in c.dims)])
    return out


def _run_blocks(func, da, mesh, dim_shards, args, kwargs, db=None):
    """``func`` on each rank's block of ``da`` (and of ``db``), the result
    rebuilt as a DTensor sharded over the same batch dims, with their
    global coordinates: the counterpart of running the function under GSPMD
    with batch dims sharded, with no collective."""
    da = shard_labeled(da, mesh, dim_shards)
    blocks = [_local_labeled(da)]
    if db is not None:
        db = shard_labeled(db, mesh, {k: v for k, v in dim_shards.items()
                                      if k in db.dims})
        blocks.append(_local_labeled(db))
    out = func(*blocks, *args, **kwargs)
    missing = [d for d in dim_shards if d not in out.dims]
    if missing:
        raise ValueError(f"sharded {func.__name__}: the result has no dim "
                         f"{missing} to keep sharded")
    sizes = da.sizes
    axis_sharding = {out.dims.index(d): m for d, m in dim_shards.items()}
    shape = [sizes[d] if d in dim_shards else n
             for d, n in zip(out.dims, out.shape)]
    res = out.copy(data=shards.wrap(mesh, out.data, axis_sharding, shape))
    for cname, c in out.coords.items():
        if any(d in dim_shards for d in c.dims) and cname in da.coords:
            res.coords[cname] = da.coords[cname].copy()
    return res


def sharded(fn, da, *args, mesh, dim_shards: dict,
            **kwargs) -> LabeledArray:
    """Run any public xrft_tpu_torch estimator over a device mesh.

    ``fn`` is the estimator (or its name).  Estimators with a pencil route
    are dispatched to their ``sharded_*`` counterpart (transform dims may
    then be sharded); every other estimator runs on each rank's block with
    the input sharded over **batch dims only**: sharding a transform dim
    raises a prescriptive error rather than silently paying a gather.
    """
    name = fn if isinstance(fn, str) else getattr(fn, "__name__", str(fn))
    if name in _PENCIL_ROUTED:
        route = globals()[_PENCIL_ROUTED[name]]
        if name in _PENCIL_TWO_INPUT:
            return route(da, args[0], mesh, dim_shards, *args[1:], **kwargs)
        return route(da, *args, mesh=mesh, dim_shards=dim_shards, **kwargs)

    import xrft_tpu_torch as _x

    func = getattr(_x, name, None)
    if func is None:
        raise ValueError(f"sharded: unknown estimator {name!r}")

    if name in _ONE_DIM:
        from ..spectra import _norm_1d_dim

        d = _norm_1d_dim(da, kwargs.get("dim"), name)
        _reject_sharded_transform(name, [d], dim_shards)
        return _run_blocks(func, da, mesh, dim_shards, args, kwargs)

    if name in _MULTI_DIM:
        d = kwargs.get("dim")
        if d is None:
            tdims = list(da.dims[-2:]) if name == "hilbert2" else \
                list(da.dims)
        else:
            tdims = [d] if isinstance(d, str) else list(d)
        _reject_sharded_transform(name, tdims, dim_shards)
        return _run_blocks(func, da, mesh, dim_shards, args, kwargs)

    if name in _TWO_INPUT:
        from ..convolve import _norm_dims

        db = args[0]
        tdims = _norm_dims(da, db, kwargs.get("dims"), name)
        _reject_sharded_transform(name, tdims, dim_shards)
        return _run_blocks(func, da, mesh, dim_shards, args[1:], kwargs,
                           db=db)

    if name == "istft":
        d = kwargs.get("dim") or da.attrs.get("stft_dim")
        if d is None:
            segdims = [x[: -len("_segment")] for x in da.dims
                       if x.endswith("_segment")]
            d = segdims[0] if len(segdims) == 1 else None
        tdims = [d + "_segment", f"freq_{d}"] if d else list(da.dims)
        _reject_sharded_transform(name, tdims, dim_shards)
        return _run_blocks(func, da, mesh, dim_shards, args, kwargs)

    raise ValueError(
        f"sharded: {name!r} has no mesh route — it is either host/static "
        "metadata work (pad/unpad/detrend compose inside the sharded "
        "estimators) or not a per-array estimator; call it directly on "
        "sharded inputs if every touched dim is a batch dim."
    )
