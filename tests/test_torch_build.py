"""The CUDA build of xrft_tpu_torch (ops/_build.py), on the CPU: the cache
key of a library covers its source, the shared headers csrc/*.cuh and the
nvcc flags, so an edited header is never served from a stale library.
No nvcc is called."""

import shutil

import pytest

pytest.importorskip("torch")

from xrft_tpu_torch.ops import _build


@pytest.fixture
def csrc(tmp_path, monkeypatch):
    """A copy of csrc/ that the build reads in place of the package's."""
    copy = tmp_path / "csrc"
    shutil.copytree(_build.CSRC, copy)
    monkeypatch.setattr(_build, "CSRC", copy)
    return copy


@pytest.mark.parametrize("name", ["dft64", "fft_fourstep", "mirror"])
def test_digest_follows_the_shared_header(csrc, name):
    before = _build.digest(name)
    assert before == _build.digest(name)
    header = csrc / "stockham.cuh"
    header.write_bytes(header.read_bytes() + b"\n// edited\n")
    assert _build.digest(name) != before


def test_digest_follows_source_flags_and_new_headers(csrc, monkeypatch):
    before = _build.digest("dft64")
    (csrc / "extra.cuh").write_text("#pragma once\n")
    with_header = _build.digest("dft64")
    assert with_header != before
    src = csrc / "dft64.cu"
    src.write_bytes(src.read_bytes() + b" ")
    edited = _build.digest("dft64")
    assert edited != with_header
    monkeypatch.setattr(_build, "NVCC_FLAGS", _build.NVCC_FLAGS + ["-G"])
    assert _build.digest("dft64") != edited


def test_digest_names_the_library(csrc, monkeypatch, tmp_path):
    """The library path carries the digest: a build is found again only
    under the key of the bytes it was built from."""
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    lib = tmp_path / "build" / f"dft64-{_build.digest('dft64')}.so"
    lib.parent.mkdir()
    lib.write_bytes(b"")
    assert _build._build("dft64") == lib
    header = csrc / "stockham.cuh"
    header.write_bytes(header.read_bytes() + b"\n")
    monkeypatch.setattr(_build, "_nvcc", lambda: pytest.fail("built"))
    with pytest.raises(pytest.fail.Exception, match="built"):
        _build._build("dft64")
