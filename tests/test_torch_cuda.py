"""The CUDA kernels of xrft_tpu_torch against their plain versions, on the
card.  Every test here needs an NVIDIA GPU and skips without one (marker
``cuda``).  The file imports neither JAX nor xrft_tpu, so it runs where only
torch is installed, without the JAX-configuring conftest:

    python -m pytest --noconftest -p no:cacheprovider -m cuda -q tests/test_torch_cuda.py
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from xrft_tpu_torch import LabeledArray, power_spectrum
from xrft_tpu_torch.config import fft_impl, psd_mirror_impl
from xrft_tpu_torch.ops import fft_fourstep, mirror

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _rel(a, b):
    return ((a - b).abs().max() / b.abs().max()).item()


@pytest.mark.parametrize("dtype", [torch.complex64, torch.complex128])
@pytest.mark.parametrize("shape,nx", [((2, 7, 5), 9), ((1, 6, 6), 10),
                                      ((1, 6, 8), 10), ((3, 64, 40), 78)])
@pytest.mark.parametrize("shift", [True, False])
def test_mirror_kernel_matches_plain(cuda, shape, nx, shift, dtype):
    g = torch.Generator(device=cuda).manual_seed(nx)
    F = torch.randn(shape, generator=g, device=cuda, dtype=dtype)
    before = mirror.mirror_psd.launches
    got = mirror.mirror_psd(F, nx, shift, 0.37)
    assert mirror.mirror_psd.launches == before + 1
    ref = mirror.mirror_psd_plain(F, nx, shift, 0.37)
    torch.cuda.synchronize()
    assert got.dtype == ref.dtype and got.shape == ref.shape
    torch.testing.assert_close(got, ref, rtol=1e-6, atol=0)


@pytest.mark.parametrize("sign", [-1, 1])
@pytest.mark.parametrize("cplx", [False, True])
@pytest.mark.parametrize("n,rows", [(256, 8), (1000, 8), (4096, 64),
                                    (65536, 2)])
def test_fourstep_kernel_matches_plain_and_cufft(cuda, n, rows, cplx, sign):
    g = torch.Generator(device=cuda).manual_seed(n)
    x = torch.randn((rows, n), generator=g, device=cuda,
                    dtype=torch.complex64 if cplx else torch.float32)
    before = fft_fourstep.fft_last.launches
    got = fft_fourstep.fft_last(x, sign)
    assert fft_fourstep.fft_last.launches == before + 1
    plain = fft_fourstep.fft_last_plain(x, sign)
    x64 = x.to(torch.complex128)
    ref = torch.fft.fft(x64) if sign == -1 else torch.fft.ifft(x64) * n
    torch.cuda.synchronize()
    assert _rel(got, plain) <= 2e-6
    assert _rel(got.to(torch.complex128), ref) <= 2e-6


def test_kernels_reject_strided_input(cuda):
    x = torch.zeros((256, 512), device=cuda)
    with pytest.raises(ValueError, match="contiguous"):
        fft_fourstep.fft_last(x[:, ::2])
    F = torch.zeros((4, 16, 9), device=cuda, dtype=torch.complex64)
    with pytest.raises(ValueError, match="contiguous"):
        mirror.mirror_psd(F.transpose(0, 1), 16, True, 1.0)


@pytest.mark.parametrize("impl", ["torch", "kernel"])
def test_main_path_through_kernels(cuda, impl):
    g = torch.Generator(device=cuda).manual_seed(0)
    x = torch.randn((4, 256, 256), generator=g, device=cuda)
    coords = {"y": np.arange(256) * 0.5, "x": np.arange(256) * 0.5}
    kw = dict(dim=["y", "x"], window="hann", detrend="linear")
    k1, k2 = mirror.mirror_psd.launches, fft_fourstep.fft_last.launches
    with fft_impl(impl):
        got = power_spectrum(LabeledArray(x, ("time", "y", "x"), coords), **kw)
    assert mirror.mirror_psd.launches == k1 + 1
    assert fft_fourstep.fft_last.launches == k2 + (2 if impl == "kernel" else 0)
    with psd_mirror_impl("plain"):
        ref = power_spectrum(
            LabeledArray(x.double(), ("time", "y", "x"), coords), **kw)
    torch.cuda.synchronize()
    assert got.data.is_cuda and got.dims == ref.dims
    assert _rel(got.data.double(), ref.data) <= 2e-6
