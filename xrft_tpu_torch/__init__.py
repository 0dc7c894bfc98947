"""xrft_tpu_torch: the PyTorch/CUDA port of xrft_tpu.

Coordinate-aware spectral analysis on torch tensors.  Coordinates stay host
numpy; bulk data is a ``torch.Tensor`` on the device it was given.  The JAX
package ``xrft_tpu`` is the reference this package is held against.

Ported so far: the windowed, detrended ``power_spectrum`` path (``fft``
forward, ``detrend``, windows, the Hermitian two-sided expansion) with two
hand-written CUDA kernels for Hopper: the fused PSD epilogue
(:mod:`.ops.mirror`) and the four-step DFT (:mod:`.ops.fft_fourstep`).
"""

from .config import config
from .detrend import detrend
from .labeled import Coord, LabeledArray
from .spectra import power_spectrum
from .transform import fft
from .utils import get_spacing

__all__ = [
    "Coord",
    "LabeledArray",
    "config",
    "detrend",
    "fft",
    "get_spacing",
    "power_spectrum",
]
