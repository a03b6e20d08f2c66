"""The port's kernel build (ops/cuda_build.py) on the CPU: nothing is
compiled here, but the name of the library a source builds into must
change with everything that build reads, so an edited source or csrc
header is rebuilt and never loaded stale."""

import pytest

from tpu_asr_torch.ops import cuda_build
from tpu_asr_torch.ops.flash_attention import BWD_LIBRARY, LIBRARY


@pytest.fixture
def csrc(tmp_path, monkeypatch):
    """A csrc directory holding k.cu, which includes a.cuh, which includes
    b.cuh; and a header nothing includes."""
    monkeypatch.setattr(cuda_build, "CSRC_DIR", str(tmp_path))
    (tmp_path / "k.cu").write_text(
        '#include "a.cuh"\n#include <cuda_runtime.h>\nint k;\n')
    (tmp_path / "a.cuh").write_text('#pragma once\n  #  include "b.cuh"\n')
    (tmp_path / "b.cuh").write_text("#pragma once\nint b;\n")
    (tmp_path / "unused.cuh").write_text("int u;\n")
    return tmp_path


def test_includes_are_found_transitively(csrc):
    lib = cuda_build.KernelLibrary("k")
    assert cuda_build.local_includes(lib.source) == [
        str(csrc / "a.cuh"), str(csrc / "b.cuh")]


@pytest.mark.parametrize("edited,rebuilds", [
    ("k.cu", True), ("a.cuh", True), ("b.cuh", True), ("unused.cuh", False),
])
def test_target_changes_with_an_included_header(csrc, edited, rebuilds):
    lib = cuda_build.KernelLibrary("k")
    before = lib._target()
    assert before == lib._target()
    with open(csrc / edited, "a") as f:
        f.write("// edited\n")
    assert (lib._target() != before) == rebuilds


def test_flash_sources_hash_their_shared_header():
    """Both flash sources include csrc/flash_sm90.cuh."""
    for lib in (LIBRARY, BWD_LIBRARY):
        assert [p.rsplit("/", 1)[-1] for p in
                cuda_build.local_includes(lib.source)] == ["flash_sm90.cuh"]
