"""K1, the fused two-sided PSD epilogue (xrft_tpu_torch/ops/mirror.py),
held against the TPU kernel it replaces (xrft_tpu/ops/pallas_mirror.py) in
interpret mode and against its numpy oracle.

The mirror only moves values, and the squares, sum and scale are rounded in
float32 on both sides, so the tolerance is rtol 1e-6 (room for a different
rounding order of the square), never looser.
"""

import numpy as np
import numpy.testing as npt
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp

from xrft_tpu.ops import pallas_mirror as pm
from xrft_tpu_torch.ops import mirror

RTOL = 1e-6
SCALE = 0.37


def _half_spectrum(rng, shape):
    return (rng.randn(*shape) + 1j * rng.randn(*shape)).astype(np.complex64)


def _psd_np(F):
    """(re^2 + im^2) * s in numpy float32."""
    return (F.real ** 2 + F.imag ** 2) * np.float32(SCALE)


@pytest.mark.parametrize("shift", [True, False])
def test_plain_matches_tpu_kernel(shift):
    B, NY, NX = 1, 512, 512
    F = _half_spectrum(np.random.RandomState(NY + shift), (B, NY, NX // 2 + 1))
    half = _psd_np(F)
    if shift:
        # the TPU kernel takes rows already in their final (shifted) order
        half = np.fft.fftshift(half, axes=-2)
    ref = np.asarray(pm.mirror_two_sided(jnp.asarray(half), NX, shift,
                                         interpret=True))
    got = mirror.mirror_psd(torch.from_numpy(F), NX, shift, SCALE).numpy()
    assert got.dtype == np.float32 and got.shape == (B, NY, NX)
    npt.assert_allclose(got, ref, rtol=RTOL, atol=0)


@pytest.mark.parametrize("B,NY,NX,MH", [(2, 7, 9, 5), (1, 6, 10, 6),
                                        (1, 6, 10, 8)])
@pytest.mark.parametrize("shift", [True, False])
def test_plain_matches_oracle_any_shape(B, NY, NX, MH, shift):
    """Odd and non-power-of-two sizes, and unused trailing columns.  The
    oracle mirrors the unshifted rows, then fftshifts them: right for odd
    NY too, where the TPU kernel's (NY - oy) row map on shifted rows is
    not."""
    F = _half_spectrum(np.random.RandomState(NY * NX), (B, NY, MH))
    ref = pm.mirror_reference(_psd_np(F), NX, shift)
    if shift:
        ref = np.fft.fftshift(ref, axes=-2)
    got = mirror.mirror_psd(torch.from_numpy(F), NX, shift, SCALE).numpy()
    npt.assert_allclose(got, ref, rtol=RTOL, atol=0)


def test_plain_is_the_two_sided_psd():
    """From a real field's rfft2, the mirror rebuilds |fft2|^2 (float64)."""
    x = np.random.RandomState(3).randn(2, 9, 12)
    F = np.fft.rfft2(x)
    for shift in (True, False):
        full = np.abs(np.fft.fft2(x)) ** 2 * 2.0
        if shift:
            full = np.fft.fftshift(full, axes=(-2, -1))
        got = mirror.mirror_psd(torch.from_numpy(F), 12, shift, 2.0).numpy()
        npt.assert_allclose(got, full, rtol=1e-12)


def test_wrapper_routes_and_rejects():
    before = mirror.mirror_psd.launches
    F = torch.zeros((1, 4, 3), dtype=torch.complex64)
    mirror.mirror_psd(F, 4, True, 1.0)
    assert mirror.mirror_psd.launches == before  # CPU tensor: plain version
    meta = torch.empty((1, 4, 3), dtype=torch.complex64, device="meta")
    with pytest.raises(ValueError, match="cuda or cpu"):
        mirror.mirror_psd(meta, 4, True, 1.0)
    with pytest.raises(ValueError, match="complex64/complex128"):
        mirror.mirror_psd(F.real.contiguous(), 4, True, 1.0)
    with pytest.raises(ValueError, match="columns"):
        mirror.mirror_psd(F, 6, True, 1.0)
    assert mirror.mirror_psd.launches == before
