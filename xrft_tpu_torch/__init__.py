"""xrft_tpu_torch: the PyTorch/CUDA port of xrft_tpu.

Coordinate-aware spectral analysis on torch tensors.  Coordinates stay host
numpy; bulk data is a ``torch.Tensor`` on the device it was given.  The JAX
package ``xrft_tpu`` is the reference this package is held against.

Ported so far: the windowed, detrended ``power_spectrum`` path (``fft``,
``detrend``, windows, the Hermitian two-sided expansion), the inverse
transform (``ifft``, with the ``dft``/``idft`` aliases), the cross spectrum
and cross phase, the isotropic (radially binned) spectra, the float64
precision path (``engine="hp"``, ``fft64``/``ifft64``), the segmented
estimators (``chunks_to_segments``, ``welch``, ``csd``, ``periodogram``,
``spectrogram``, ``coherence``, ``stft``/``istft``, ``pad``/``unpad``) and
the matmul FFT engine (``config.fft_impl = "matmul"``) and the
scipy-namesake families (``hilbert``/``envelope``, the DCT/DST family,
``fftconvolve``/``oaconvolve``/``convolve``/``correlate``, the FIR filters
and ``resample_poly``/``decimate``/``savgol_filter``, ``czt``/``zoom_fft``,
``fht``/``ifht``, ``resample`` and ``lombscargle``, each taking its FFTs
through ``config.fft_impl`` or its per-call ``engine=``), with hand-written
CUDA kernels for Hopper: the fused PSD epilogue (:mod:`.ops.mirror`), the
four-step DFT (:mod:`.ops.fft_fourstep`), the binned sum
(:mod:`.ops.binning`), the FP64 direct DFT (:mod:`.ops.dft64`) and the
small-weight products of the matmul engine (:mod:`.ops.dot`).  The sharded
path (:mod:`.parallel`) runs the spectra over a ``DeviceMesh`` of
``torch.distributed``, transform dims sharded through a pencil
decomposition, with the same kernels on each rank's block.  Every public
function takes and returns ``xarray.DataArray`` where xarray is installed
(:mod:`.xarray_compat`), and ``da.xrft.<method>`` is its accessor.

Host data (numpy) given to the package land on the CUDA device unless the
caller asks for the CPU (``device="cpu"``, or a CPU tensor).
"""

from . import telemetry
from .analytic import envelope, hilbert, hilbert2
from .config import complex_mode, config, fft_engine, set_fft_engine
from .convolve import (choose_conv_method, convolve, correlate, fftconvolve,
                       oaconvolve)
from .czt import czt, zoom_fft
from .detrend import detrend
from .fht import fht, fhtoffset, ifht
from .filter import (decimate, firwin, resample_poly, savgol_coeffs,
                     savgol_filter, upfirdn)
from .highprec import fft64, ifft64
from .isotropic import (fit_loglog, isotropic_cross_spectrum,
                        isotropic_power_spectrum, isotropize)
from .labeled import Coord, LabeledArray
from .lombscargle import lombscargle
from .padding import pad, unpad
from .resample import resample
from .spectra import (coherence, cross_phase, cross_spectrum, csd,
                      periodogram, power_spectrum, spectrogram, welch)
from .stft import istft, stft
from .transform import dft, fft, idft, ifft
from .trig import dct, dctn, dst, dstn, idct, idctn, idst, idstn
from .utils import get_spacing
from .xarray_compat import from_xarray, to_xarray, xr_boundary

__all__ = [
    "Coord",
    "LabeledArray",
    "choose_conv_method",
    "coherence",
    "complex_mode",
    "config",
    "convolve",
    "correlate",
    "cross_phase",
    "cross_spectrum",
    "csd",
    "czt",
    "dct",
    "dctn",
    "decimate",
    "detrend",
    "dft",
    "dst",
    "dstn",
    "envelope",
    "fft",
    "fft64",
    "fft_engine",
    "fftconvolve",
    "fht",
    "fhtoffset",
    "firwin",
    "fit_loglog",
    "from_xarray",
    "get_spacing",
    "hilbert",
    "hilbert2",
    "idct",
    "idctn",
    "idft",
    "idst",
    "idstn",
    "ifft",
    "ifft64",
    "ifht",
    "isotropic_cross_spectrum",
    "isotropic_power_spectrum",
    "isotropize",
    "istft",
    "lombscargle",
    "oaconvolve",
    "pad",
    "periodogram",
    "power_spectrum",
    "resample",
    "resample_poly",
    "savgol_coeffs",
    "savgol_filter",
    "set_fft_engine",
    "spectrogram",
    "stft",
    "to_xarray",
    "unpad",
    "upfirdn",
    "welch",
    "xr_boundary",
    "zoom_fft",
]

# xarray at the API boundary: the public array functions take and return
# xarray.DataArray when given one, the names xrft_tpu/__init__.py:49-63 wraps;
# each outermost call of them is one call of telemetry (the package's own
# calls take the modules' functions, and neither wrapper runs there)
for _name in (
    "fft", "ifft", "dft", "idft", "power_spectrum", "cross_spectrum",
    "cross_phase", "coherence", "spectrogram", "welch", "csd",
    "periodogram", "stft", "istft", "hilbert", "hilbert2", "envelope",
    "dct", "idct", "dst", "idst", "dctn", "idctn", "dstn", "idstn",
    "czt", "zoom_fft", "resample",
    "upfirdn", "resample_poly", "decimate", "savgol_filter",
    "convolve", "fftconvolve", "oaconvolve", "correlate",
    "choose_conv_method", "lombscargle", "fht", "ifht",
    "isotropize",
    "isotropic_power_spectrum", "isotropic_cross_spectrum", "pad", "unpad",
    "detrend", "fft64", "ifft64",
):
    globals()[_name] = telemetry.entry(xr_boundary(globals()[_name]))
del _name

from .xarray_compat import register_accessor as _register_accessor  # noqa: E402

_register_accessor()
