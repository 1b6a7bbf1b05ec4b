"""The port's kernel build (trgt_tpu_torch/kernels/_build.py): the library
name follows the sources, a failed nvcc run raises and leaves nothing to
load. The real build runs only where a CUDA device is present."""

import shutil

import pytest
import torch

from trgt_tpu_torch.kernels import _build


@pytest.fixture
def fake_csrc(tmp_path, monkeypatch):
    src = tmp_path / "csrc"
    src.mkdir()
    (src / "a.cu").write_text("// one\n")
    monkeypatch.setattr(_build, "CSRC_DIR", str(src))
    monkeypatch.setattr(_build, "BUILD_DIR", str(tmp_path / "build"))
    return src


def test_library_name_follows_the_sources(fake_csrc):
    first = _build.library_path()
    assert first == _build.library_path()
    (fake_csrc / "a.cu").write_text("// two\n")
    assert _build.library_path() != first


def test_failed_build_raises(fake_csrc, monkeypatch, tmp_path):
    monkeypatch.setattr(_build, "_nvcc", lambda: shutil.which("false"))
    with pytest.raises(RuntimeError, match="nvcc failed"):
        _build.build()
    assert not list((tmp_path / "build").glob("*.so"))


def test_build_needs_sources(tmp_path, monkeypatch):
    monkeypatch.setattr(_build, "CSRC_DIR", str(tmp_path))
    monkeypatch.setattr(_build, "BUILD_DIR", str(tmp_path / "build"))
    with pytest.raises(RuntimeError, match="no CUDA sources"):
        _build.build()


def test_entry_points_are_declared_and_defined():
    """Every C entry point `get_lib` binds is defined, extern "C", in one
    of the sources, with as many parameters as its argtypes; the two
    entry points of the genotype stage are among them."""
    import re
    text = "".join(open(src).read() for src in _build.sources())
    assert {"trgt_edit_distances", "trgt_e2e_scan"} <= set(_build._SIGNATURES)
    for name, argtypes in _build._SIGNATURES.items():
        m = re.search(r'extern "C" int ' + name + r"\(([^)]*)\)", text)
        assert m, name
        assert len(m.group(1).split(",")) == len(argtypes), name


def test_host_codec_source_is_not_a_cuda_source():
    names = [src.rsplit("/", 1)[-1] for src in _build.sources()]
    assert names == ["e2e.cu", "editdist.cu", "flank.cu", "viterbi.cu"]


@pytest.mark.cuda
def test_kernels_build_and_load():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    lib = _build.get_lib()
    assert lib.trgt_cuda_error_string(0) == b"no error"
    for name in _build._SIGNATURES:
        assert getattr(lib, name).restype is not None
