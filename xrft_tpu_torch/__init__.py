"""xrft_tpu_torch: the PyTorch/CUDA port of xrft_tpu.

Coordinate-aware spectral analysis on torch tensors.  Coordinates stay host
numpy; bulk data is a ``torch.Tensor`` on the device it was given.  The JAX
package ``xrft_tpu`` is the reference this package is held against.

Ported so far: the windowed, detrended ``power_spectrum`` path (``fft``
forward, ``detrend``, windows, the Hermitian two-sided expansion), the cross
spectrum and cross phase, and the isotropic (radially binned) spectra, with
three hand-written CUDA kernels for Hopper: the fused PSD epilogue
(:mod:`.ops.mirror`), the four-step DFT (:mod:`.ops.fft_fourstep`) and the
binned sum (:mod:`.ops.binning`).
"""

from .config import config
from .detrend import detrend
from .isotropic import (fit_loglog, isotropic_cross_spectrum,
                        isotropic_power_spectrum, isotropize)
from .labeled import Coord, LabeledArray
from .spectra import cross_phase, cross_spectrum, power_spectrum
from .transform import fft
from .utils import get_spacing

__all__ = [
    "Coord",
    "LabeledArray",
    "config",
    "cross_phase",
    "cross_spectrum",
    "detrend",
    "fft",
    "fit_loglog",
    "get_spacing",
    "isotropic_cross_spectrum",
    "isotropic_power_spectrum",
    "isotropize",
    "power_spectrum",
]
