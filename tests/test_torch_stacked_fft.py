"""The matmul FFT engine of xrft_tpu_torch (ops/stacked_fft.py, dispatched
by ``fft_impl="matmul"``) against xrft_tpu's stacked engine
(``fft_engine("matmul")``) on the CPU.

Tolerances, relative to max|F|: 2e-6 in float32 (products of up to 128
terms per level, summed in another order), 1e-12 in float64.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp

import xrft_tpu
from xrft_tpu.config import config as ref_config
from xrft_tpu.ops import fft_core as ref_core
from xrft_tpu.ops import stacked_fft as ref_st
from xrft_tpu_torch.config import fft_impl, level0_impl
from xrft_tpu_torch.ops import dot, fft_core, stacked_fft

TOL = {np.float32: 2e-6, np.float64: 1e-12}


def _rel(got, ref):
    ref = np.asarray(ref)
    return np.abs(np.asarray(got) - ref).max() / np.abs(ref).max()


def test_plan_matches_reference():
    got = [stacked_fft.plan(n, 128) for n in range(2, 4097)]
    want = [ref_st.plan(n, 128) for n in range(2, 4097)]
    assert got == want


@pytest.mark.parametrize("impl", ["unpacked", "packed"])
def test_level0_dot_matches_pallas_route(impl):
    """(16, 2, 2048): the 2048-point axis plans (16, 128), so the level-0
    product contracts the 16-digit of the pre-split (16, 2, 16, 128)."""
    rng = np.random.RandomState(3)
    a = rng.randn(16, 2, 16, 128).astype(np.float32)
    wl = ref_st._stack_lhs(ref_st._w_complex_np(16, -1), True, np.float32)
    ref_config.pallas_level0 = f"{impl}_interpret"
    try:
        ref = np.asarray(ref_st._pallas_level0_dot(jnp.asarray(a), wl, 2))
    finally:
        ref_config.pallas_level0 = "never"
    before = dot.dot.launches
    with level0_impl(impl):
        got = stacked_fft._level0_dot(torch.from_numpy(a),
                                      torch.from_numpy(wl), 2)
    assert dot.dot.launches == before     # the CPU runs the plain version
    assert got.shape == ref.shape == (2, 16, 16, 2, 128)
    assert _rel(got.numpy(), ref) <= 1e-6


def _case(n, ndim, kind, dtype, seed):
    rng = np.random.RandomState(seed)
    shape = (24, n) if ndim == 2 else (3, n)
    x = rng.randn(*shape)
    if kind != "rfft":
        x = x + 1j * rng.randn(*shape)
    cdt = {np.float32: np.complex64, np.float64: np.complex128}[dtype]
    return x.astype(cdt if kind != "rfft" else dtype)


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("kind", ["fft", "ifft", "rfft"])
@pytest.mark.parametrize("n", [96, 256, 1024, 2048, 4096])
def test_transforms_match_reference(n, kind, dtype):
    """Sizes: direct (96), (16, 16), (32, 32), (16, 128), (32, 128); 1-D
    over the last axis and 2-D, with and without absorbed shifts."""
    for ndim in (1, 2):
        x = _case(n, ndim, kind, dtype, seed=n + ndim)
        axes = [1] if ndim == 1 else [0, 1]
        shifts = [((), ()), (tuple(axes), tuple(axes))]
        if kind == "rfft":
            shifts = [((), ()), (tuple(axes), tuple(axes[:-1]))]
        for pre, post in shifts:
            ref_fn = {"fft": ref_core.fftn, "ifft": ref_core.ifftn,
                      "rfft": ref_core.rfftn}[kind]
            with xrft_tpu.fft_engine("matmul"):
                ref = np.asarray(ref_fn(x, axes, pre_shift_axes=pre,
                                        post_shift_axes=post))
            fn = {"fft": fft_core.fftn, "ifft": fft_core.ifftn,
                  "rfft": fft_core.rfftn}[kind]
            with fft_impl("matmul"):
                got = fn(torch.from_numpy(x), axes, pre_shift_axes=pre,
                         post_shift_axes=post)
            assert got.numpy().dtype == ref.dtype
            assert got.shape == ref.shape
            assert _rel(got.numpy(), ref) <= TOL[dtype], (ndim, pre, post)


def test_what_the_engine_cannot_plan_runs_on_the_pair_engine():
    """A prime above direct_dft_max (Bluestein), an odd outer radix under
    an output shift and irfftn have no stacked plan: under "matmul" the pair
    engine runs them, as xrft_tpu's fft_engine("matmul"), and nothing
    reaches torch.fft; fft_nd_stacked called directly still raises."""
    rng = np.random.RandomState(131)
    x = rng.randn(2, 131)
    y = rng.randn(2, 254) + 1j * rng.randn(2, 254)    # plan (2, 127)
    z = rng.randn(2, 9) + 1j * rng.randn(2, 9)
    cases = [(fft_core.fftn, ref_core.fftn, x, {}),
             (fft_core.rfftn, ref_core.rfftn, x, {}),
             (fft_core.fftn, ref_core.fftn, y, dict(pre_shift_axes=[1])),
             (fft_core.fftn, ref_core.fftn, y, dict(post_shift_axes=[1])),
             (fft_core.irfftn, ref_core.irfftn, z, {})]
    for fn, ref_fn, data, kw in cases:
        with xrft_tpu.fft_engine("matmul"):
            ref = np.asarray(ref_fn(data, [1], **kw))
        with fft_impl("matmul"):
            got = fn(torch.from_numpy(data), [1], **kw)
        assert got.numpy().dtype == ref.dtype and got.shape == ref.shape
        assert _rel(got.numpy(), ref) <= 1e-12, (fn.__name__, kw)
    xt_, yt = torch.from_numpy(x), torch.from_numpy(y)
    assert not stacked_fft.stacked_supported(xt_, [1], "fft", (), ())
    assert stacked_fft.stacked_supported(yt, [1], "fft", (1,), ())
    assert not stacked_fft.stacked_supported(yt, [1], "fft", (), (1,))
    with pytest.raises(NotImplementedError, match="prime factor above"):
        stacked_fft.fft_nd_stacked(xt_, [1], "fft")
    with pytest.raises(NotImplementedError, match="shift"):
        stacked_fft.fft_nd_stacked(yt, [1], "fft", (), (1,))
    with pytest.raises(NotImplementedError, match="irfft"):
        stacked_fft.fft_nd_stacked(torch.from_numpy(z), [1], "irfft")
