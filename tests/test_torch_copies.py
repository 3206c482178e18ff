"""The port's verbatim copies of jax-free modules of the JAX package: each
equals its original once `pagan2_tpu` is read as `pagan2_tpu_torch` on
its import lines (the copies import relatively, so today they are byte
for byte the same). The port's own rewrites (native/__init__.py with its
build directory, the rest of align/, pipeline/, parallel/, the CLI) are
not copies and are not listed."""
import os
import re

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

COPIES = (["graph/%s.py" % m for m in ("__init__", "builders",
                                       "sequence_graph", "serialize")]
          + ["models/%s.py" % m for m in ("__init__", "alphabets", "eigen",
                                          "evol_model", "model_data")]
          + ["models/data/ecm.npz", "models/data/wag.npz"]
          + ["io/%s.py" % m for m in ("__init__", "fasta", "plots",
                                      "translate", "writers")]
          + ["tree/newick.py", "tree/inference.py", "utils/log.py",
             "utils/check_version.py"]
          + ["align/%s.py" % m for m in ("settings", "oracle", "ancestral",
                                         "anchors", "sampling", "refalign")]
          + ["native/pagan2_native.cpp"]
          + ["pipeline/%s.py" % m for m in ("orfs", "refread", "ancestors",
                                            "postprocess")])

_IMPORT = re.compile(rb"^\s*(from|import)\s")


def _normal(data: bytes) -> bytes:
    """Import lines with the JAX package's name read as the port's."""
    return b"".join(
        re.sub(rb"\bpagan2_tpu\b", b"pagan2_tpu_torch", line)
        if _IMPORT.match(line) else line
        for line in data.splitlines(keepends=True))


@pytest.mark.parametrize("path", COPIES)
def test_copy_equals_its_original(path):
    with open(os.path.join(ROOT, "pagan2_tpu", path), "rb") as f:
        original = f.read()
    with open(os.path.join(ROOT, "pagan2_tpu_torch", path), "rb") as f:
        copy = f.read()
    if path.endswith(".npz"):
        assert copy == original
    else:
        assert _normal(copy) == _normal(original)
