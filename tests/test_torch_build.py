"""The port's kernel build (avtex_torch/ops/_build.py): a library's path
hashes its source, every csrc header the source includes (through other
headers too) and the nvcc flags, so an edit to any of them rebuilds."""

import pytest

from avtex_torch.ops import _build


@pytest.fixture
def csrc(tmp_path, monkeypatch):
    monkeypatch.setattr(_build, "CSRC", str(tmp_path))
    (tmp_path / "k.cu").write_text('#include <cuda.h>\n#include "a.cuh"\n'
                                   "int k() { return f(); }\n")
    (tmp_path / "a.cuh").write_text('#pragma once\n  #  include "b.cuh"\n'
                                    "inline int f() { return g(); }\n")
    (tmp_path / "b.cuh").write_text("inline int g() { return 1; }\n")
    return tmp_path


def test_source_files_follow_local_includes(csrc):
    assert _build.source_files("k") == ["k.cu", "a.cuh", "b.cuh"]


@pytest.mark.parametrize("edited", ["k.cu", "a.cuh", "b.cuh"])
def test_editing_a_source_or_header_changes_the_library_path(csrc, edited):
    before = _build.lib_path("k")
    assert _build.lib_path("k") == before
    f = csrc / edited
    f.write_text(f.read_text() + "// edited\n")
    assert _build.lib_path("k") != before


def test_port_sources_hash_their_headers():
    files = _build.source_files("fused_conv1x1")
    assert files == ["fused_conv1x1.cu", "hopper.cuh"]
    for name in _build.SOURCES:
        assert _build.source_files(name)[0] == f"{name}.cu"
