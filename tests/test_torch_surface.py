"""The process-wide engine switches and the per-call ``engine=`` names of
xrft_tpu_torch against xrft_tpu's, on the CPU.

``set_fft_engine``/``fft_engine`` take xrft_tpu's names ("auto" and "xla"
are cuFFT, ``fft_impl="torch"``, as on the JAX package's GPU; "matmul" the
matmul engine), ``complex_mode`` keeps its name (native complex only), and
``fft``, ``ifft`` and every spectrum take ``engine="auto" | "xla" |
"matmul"``, equal to xrft_tpu's results under the same name to 1e-12 in
float64.
"""

import numpy as np
import pytest

import xrft_tpu
import xrft_tpu_torch as xt
from xrft_tpu_torch.config import config, fft_impl
from torch_parity import assert_same, pair

ENGINES = ("auto", "xla", "matmul")


def _field(seed, shape=(16, 32)):
    rng = np.random.RandomState(seed)
    coords = {"y": np.arange(shape[0]) * 0.5, "x": np.arange(shape[1]) * 0.25}
    return pair(rng.randn(*shape), ("y", "x"), coords, name=f"f{seed}")


@pytest.mark.parametrize("engine", ENGINES)
@pytest.mark.parametrize("name", ["power_spectrum", "cross_spectrum", "fft",
                                  "ifft", "isotropic_power_spectrum"])
def test_engine_names_match_reference(name, engine):
    """The repair: each name gives xrft_tpu's value (it raised before)."""
    (r1, p1), (r2, p2) = _field(0), _field(1)
    kw = dict(engine=engine)
    if name == "cross_spectrum":
        refs, ports = (r1, r2), (p1, p2)
        kw.update(dim=["y", "x"])
    elif name == "ifft":
        refs = (xrft_tpu.fft(r1, true_phase=False),)
        ports = (xt.fft(p1, true_phase=False),)
        kw.update(true_phase=False, lag=[0.0, 0.0])
    else:
        refs, ports = (r1,), (p1,)
        kw.update({"window": "hann"} if name != "fft" else
                  {"true_phase": True})
    want = getattr(xrft_tpu, name)(*refs, **kw)
    got = getattr(xt, name)(*ports, **kw)
    assert_same(got, want, 1e-12)


@pytest.mark.parametrize("name", ["power_spectrum", "fft", "welch"])
def test_unknown_engine_raises(name):
    _, p = _field(2)
    with pytest.raises(ValueError, match="Unknown fft engine 'bogus'"):
        kw = dict(dim="x", seglen=8) if name == "welch" else {}
        getattr(xt, name)(p, engine="bogus", **kw)


@pytest.mark.parametrize("engine,impl", [("auto", "torch"), ("xla", "torch"),
                                         ("matmul", "matmul")])
@pytest.mark.parametrize("start", ["torch", "kernel", "matmul"])
def test_fft_engine_sets_and_restores(engine, impl, start):
    """fft_engine(name) runs the block under the name's fft_impl and
    restores the exact one before, "kernel" included."""
    with fft_impl(start):
        with xt.fft_engine(engine):
            assert config.fft_impl == impl
        assert config.fft_impl == start


def test_set_fft_engine():
    old = config.fft_impl
    try:
        for engine, impl in (("matmul", "matmul"), ("xla", "torch"),
                             ("auto", "torch")):
            xt.set_fft_engine(engine)
            assert config.fft_impl == impl
    finally:
        config.fft_impl = old


@pytest.mark.parametrize("bad", ["bogus", "torch", "kernel", None])
def test_engine_switches_reject_what_the_reference_rejects(bad):
    """The same values raise in both packages, with the same message."""
    with pytest.raises(ValueError) as ref:
        xrft_tpu.set_fft_engine(bad)
    with pytest.raises(ValueError) as got:
        xt.set_fft_engine(bad)
    assert str(got.value) == str(ref.value)
    with pytest.raises(ValueError) as got:
        with xt.fft_engine(bad):
            pass
    assert str(got.value) == str(ref.value)
    assert config.fft_impl == "torch"


@pytest.mark.parametrize("mode", ["auto", "native"])
def test_complex_mode_native_is_a_no_op(mode):
    _, p = _field(3)
    before = xt.power_spectrum(p).values
    with xrft_tpu.complex_mode(mode), xt.complex_mode(mode):
        assert config.fft_impl == "torch"
        np.testing.assert_array_equal(xt.power_spectrum(p).values, before)


def test_complex_mode_split_and_unknown():
    with pytest.raises(NotImplementedError, match="ComplexPair"):
        with xt.complex_mode("split"):
            pass
    with pytest.raises(ValueError) as ref:
        with xrft_tpu.complex_mode("planar"):
            pass
    with pytest.raises(ValueError) as got:
        with xt.complex_mode("planar"):
            pass
    assert str(got.value) == str(ref.value)


def test_pencil_overlap_chunks_default():
    assert config.pencil_overlap_chunks == \
        xrft_tpu.config.pencil_overlap_chunks == 1


def test_public_names():
    """Every public name of xrft_tpu is in xrft_tpu_torch, and the sharded
    path exports xrft_tpu.parallel's names."""
    import xrft_tpu.parallel as jp

    import xrft_tpu_torch.parallel as tp

    ref = {n for n in dir(xrft_tpu) if not n.startswith("_")}
    missing = sorted(n for n in ref - set(dir(xt))
                     if not isinstance(getattr(xrft_tpu, n), type(np)))
    assert missing == []
    for n in ("fft_engine", "set_fft_engine", "complex_mode", "from_xarray",
              "to_xarray", "xr_boundary"):
        assert n in xt.__all__
    jnames = {n for n in dir(jp) if not n.startswith("_")
              and not isinstance(getattr(jp, n), type(np))}
    tnames = {n for n in dir(tp) if not n.startswith("_")
              and not isinstance(getattr(tp, n), type(np))}
    assert jnames == tnames
