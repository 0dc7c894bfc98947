"""The sharded path: spectra over a ``torch.distributed`` DeviceMesh.

Counterpart of ``xrft_tpu.parallel``: :func:`make_mesh` and
:func:`shard_labeled` place a LabeledArray's data on a mesh as a DTensor,
:func:`pencil_fftn` is the distributed N-D FFT, and the ``sharded_*``
functions (and :func:`sharded` for the rest of the public surface) run the
package's pipelines with the input sharded.  The caller, or ``torchrun``,
initializes the process group; one card runs a one-rank NCCL group.
"""

from .mesh import axis_links, make_mesh, shard_labeled  # noqa: F401
from .pencil import pencil_fftn  # noqa: F401
from .api import (  # noqa: F401
    sharded,
    sharded_coherence,
    sharded_cross_phase,
    sharded_cross_spectrum,
    sharded_csd,
    sharded_fft,
    sharded_isotropic_cross_spectrum,
    sharded_isotropic_power_spectrum,
    sharded_power_spectrum,
    sharded_welch,
)
