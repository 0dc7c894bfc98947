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
the matmul FFT engine (``config.fft_impl = "matmul"``), with hand-written
CUDA kernels for Hopper: the fused PSD epilogue (:mod:`.ops.mirror`), the
four-step DFT (:mod:`.ops.fft_fourstep`), the binned sum
(:mod:`.ops.binning`), the FP64 direct DFT (:mod:`.ops.dft64`) and the
small-weight products of the matmul engine (:mod:`.ops.dot`).

Host data (numpy) given to the package land on the CUDA device unless the
caller asks for the CPU (``device="cpu"``, or a CPU tensor).
"""

from .config import config
from .detrend import detrend
from .highprec import fft64, ifft64
from .isotropic import (fit_loglog, isotropic_cross_spectrum,
                        isotropic_power_spectrum, isotropize)
from .labeled import Coord, LabeledArray
from .padding import pad, unpad
from .spectra import (coherence, cross_phase, cross_spectrum, csd,
                      periodogram, power_spectrum, spectrogram, welch)
from .stft import istft, stft
from .transform import dft, fft, idft, ifft
from .utils import get_spacing

__all__ = [
    "Coord",
    "LabeledArray",
    "coherence",
    "config",
    "cross_phase",
    "cross_spectrum",
    "csd",
    "detrend",
    "dft",
    "fft",
    "fft64",
    "fit_loglog",
    "get_spacing",
    "idft",
    "ifft",
    "ifft64",
    "isotropic_cross_spectrum",
    "isotropic_power_spectrum",
    "istft",
    "isotropize",
    "pad",
    "periodogram",
    "power_spectrum",
    "spectrogram",
    "stft",
    "unpad",
    "welch",
]
