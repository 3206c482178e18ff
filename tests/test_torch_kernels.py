"""The kernel builder's staleness rule (pagan2_tpu_torch/kernels.py): a
library is rebuilt when it is missing or older than its source or a
csrc/ header the source includes (kernels D and E share
fullprob_common.cuh). Runs on the CPU: nothing is compiled."""
import os

import pytest

from pagan2_tpu_torch import kernels


@pytest.fixture
def tree(tmp_path, monkeypatch):
    csrc, build = tmp_path / "csrc", tmp_path / "build"
    csrc.mkdir()
    build.mkdir()
    (csrc / "k.cu").write_text('#include <cuda_runtime.h>\n'
                               '#include "shared.cuh"\nint k;\n')
    (csrc / "shared.cuh").write_text('#pragma once\n#include "base.cuh"\n')
    (csrc / "base.cuh").write_text("#pragma once\n")
    (csrc / "other.cu").write_text("int other;\n")
    monkeypatch.setattr(kernels, "CSRC", str(csrc))
    monkeypatch.setattr(kernels, "BUILD_DIR", str(build))
    return csrc, build


def test_kernel_inputs_follow_quoted_includes(tree):
    csrc, _build = tree
    assert kernels._inputs(str(csrc / "k.cu")) == [
        str(csrc / "k.cu"), str(csrc / "shared.cuh"), str(csrc / "base.cuh")]
    assert kernels._inputs(str(csrc / "other.cu")) == [str(csrc / "other.cu")]


@pytest.mark.parametrize("newer,stale", [
    (None, False), ("k.cu", True), ("shared.cuh", True), ("base.cuh", True),
    ("missing", True)])
def test_kernel_library_is_stale_after_its_source_or_headers(tree, newer,
                                                            stale):
    csrc, build = tree
    so = build / "libk.so"
    if newer != "missing":
        so.write_bytes(b"")
        for f in csrc.iterdir():
            os.utime(f, (1000, 1000))
        os.utime(so, (2000, 2000))
        if newer is not None:
            os.utime(csrc / newer, (3000, 3000))
    assert kernels._stale("k") is stale
    # a header that k.cu does not include does not make it stale
    if newer is None:
        (csrc / "unused.cuh").write_text("")
        os.utime(csrc / "unused.cuh", (3000, 3000))
        assert kernels._stale("k") is False
