"""Power spectrum and its scaling rules.

Counterpart of ``xrft_tpu/spectra.py:29-83,109-166,168-291,323-411,515-586``
(xrft's ``xrft/xrft.py:649-750``).  For real input with two or more
transform dims, the last dim is computed one-sided (rfft) and the two-sided
grid is rebuilt by Hermitian symmetry.  When the two transform dims are the
array's trailing two and ``config.psd_mirror_impl == "kernel"``, |F|^2, the
scale, the fftshift and the mirror are one pass of kernel K1
(:mod:`.ops.mirror`); every other geometry, and ``"plain"``, takes the
general expansion :func:`_hermitian_expand`.
"""

from __future__ import annotations

import warnings

import numpy as np
import torch

from . import coords as ce
from .config import MIRROR_IMPLS, config
from .labeled import Coord, LabeledArray
from .ops import mirror
from .transform import _dim_coord, _not_ported, _real_flag_warning, fft

__all__ = ["power_spectrum"]


def _abs2(x: torch.Tensor) -> torch.Tensor:
    return x.real ** 2 + x.imag ** 2


def _window_correction_factor(da, dim, scaling, window) -> float:
    """density -> mean(window^2); spectrum -> mean(window)^2
    (``xrft/xrft.py:649-660``), in float64 on the host."""
    if window is None:
        raise ValueError(
            "window_correction can only be applied when windowing is "
            "turned on."
        )
    from .ops.window import build_window

    w = build_window(da, dim, window, dtype=torch.float64,
                     device="cpu").data
    if scaling == "density":
        return float((w ** 2).mean())
    elif scaling == "spectrum":
        return float(w.mean()) ** 2
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
    LabeledArray in the PSD's dtype on its device."""
    real = next(d for d in updated_dims if d.endswith(real_dim))
    f = torch.as_tensor(_doubling_vector(da.sizes[real_dim]),
                        dtype=ps.dtype, device=ps.device)
    return LabeledArray(f, dims=(real,), coords={real: ps.coords[real]})


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


def _half_spectrum_dim(da, dim, real_dim):
    """The transform dim to compute one-sided for a two-sided power spectrum
    of real data (Hermitian symmetry halves the work on every other
    transform axis), or None."""
    if real_dim is not None or da.dtype.is_complex:
        return None
    dims = _norm_dim_list(da, dim)
    if len(dims) < 2:
        return None
    return dims[-1]


def _hermitian_expand(half, daft, da, dims, half_dim, kwargs, shift):
    """Expand a one-sided PSD over the half axis to the full two-sided grid
    via Hermitian symmetry, with the shift conventions already applied on
    the non-half axes:

        X[k_o, k] == X[-k_o mod n_o, n - k]

    Output position o on the (possibly shifted) half axis reads unshifted
    frequency k = (o - h) mod n; k <= n//2 is one-sided column k, otherwise
    column n - k with every other transform axis negated, which on its
    (possibly shifted) grid is the permutation o -> (2h - o) mod n.  Index
    maps are host constants; the data moves by ``index_select``.  Any
    geometry (``xrft_tpu/spectra.py:168-272``)."""
    n = da.sizes[half_dim]
    fd = {d: ce.freq_dim_name(d, kwargs.get("prefix", "freq_")) for d in dims}
    ax_half = daft.get_axis_num(fd[half_dim])
    dev = half.device

    h = n // 2 if shift else 0
    ks = (np.arange(n) - h) % n
    mirrored = ks > n // 2
    src = np.where(mirrored, n - ks, ks)

    full = half.index_select(ax_half, torch.as_tensor(src, device=dev))
    pos = np.nonzero(mirrored)[0]
    if pos.size:
        pos_t = torch.as_tensor(pos, device=dev)
        piece = full.index_select(ax_half, pos_t)
        for d in dims:
            if d == half_dim:
                continue
            na = daft.sizes[fd[d]]
            ha = na // 2 if shift else 0
            perm = (2 * ha - np.arange(na)) % na
            piece = piece.index_select(daft.get_axis_num(fd[d]),
                                       torch.as_tensor(perm, device=dev))
        full.index_copy_(ax_half, pos_t, piece)

    return LabeledArray(full, dims=daft.dims,
                        coords=_two_sided_coords(daft, da, dims, half_dim,
                                                 kwargs, shift, n),
                        name=da.name)


def _two_sided_coords(daft, da, dims, half_dim, kwargs, shift, n_full):
    """Coordinates of the full two-sided grid rebuilt from a one-sided
    `daft` (shared by the kernel and plain mirror routes)."""
    fd = {d: ce.freq_dim_name(d, kwargs.get("prefix", "freq_")) for d in dims}
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
    other one immediately left of it, float32/float64 data
    (``xrft_tpu/spectra.py:294-320`` without the TPU's size limits)."""
    impl = config.psd_mirror_impl
    if impl not in MIRROR_IMPLS:
        raise ValueError(f"unknown psd_mirror_impl {impl!r}; expected one "
                         f"of {MIRROR_IMPLS}")
    if impl == "plain" or len(dims) != 2:
        return False
    od = da.dims
    other = [d for d in dims if d != half_dim][0]
    return (len(od) >= 2 and od[-1] == half_dim and od[-2] == other
            and da.dtype in (torch.float32, torch.float64))


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
    amp2 = float(np.prod([
        ce.get_coordinate_spacing(_dim_coord(da, d),
                                  kwargs.get("spacing_tol", 1e-3))
        for d in dims])) ** 2
    scale = amp2 if prescale is None else amp2 * prescale

    if _mirror_kernel_applicable(da, dims, half_dim):
        # K1 takes the unshifted half spectrum and does the y-fftshift itself
        daft = fft(da, dim=dims, real_dim=half_dim, shift=False, **kwargs)
        full = mirror.mirror_psd(daft.data.contiguous(), n_full, shift, scale)
        return LabeledArray(
            full, dims=daft.dims,
            coords=_two_sided_coords(daft, da, dims, half_dim, kwargs,
                                     shift, n_full),
            name=da.name)

    daft = fft(da, dim=dims, real_dim=half_dim, shift=shift,
               _shift_nonreal=True, **kwargs)
    ps_half = _abs2(daft.data) * scale
    return _hermitian_expand(ps_half, daft, da, dims, half_dim, kwargs, shift)


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
    for d in _norm_dim_list(da, dim):
        delta = ce.get_coordinate_spacing(
            _dim_coord(da, d), kwargs.get("spacing_tol", 1e-3))
        fs *= 1.0 / (da.sizes[d] * delta)
    return pre * (fs if scaling == "density" else fs**2)


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

    if kwargs.get("chunks_to_segments") or \
            kwargs.get("segment_overlap") is not None:
        raise _not_ported("chunks_to_segments/segment_overlap",
                          "segments and short-time")

    # true_phase does not matter for |F|^2; forced off to skip phase work
    kwargs.update({"true_amplitude": True, "true_phase": False})

    half = _half_spectrum_dim(da, dim, real_dim)
    if half is not None:
        prescale = _density_prescale(da, dim, scaling, window_correction,
                                     kwargs)
        return _power_spectrum_via_rfft(da, dim, half, kwargs, prescale)

    daft = fft(da, dim=dim, real_dim=real_dim, **kwargs)
    updated_dims = [d for d in daft.dims if d not in da.dims]
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
