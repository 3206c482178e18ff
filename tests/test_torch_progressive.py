"""The whole slice: `python -m pagan2_tpu_torch --device cpu` against the
JAX package's CLI (its Pallas kernels in interpret mode, f32) on small
progressive families. The FASTA files must be byte-identical.

The 6 x 300 bp family is bench.py's family generator (a 12-bp deletion
in every third sequence): its ancestors carry skip edges of offset 13,
past the Pallas caps, so those pairs anchor from 200 sites and fill
windowed — the port's counters must show such a fill. The homopolymer
family runs the batched fan-in launch."""
import os
import re
import subprocess
import sys

import numpy as np
import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

REFERENCE = r"""
import sys
import jax
jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", False)
from pagan2_tpu.align import (viterbi_pallas, viterbi_pallas_fanin,
                              viterbi_pallas_banded)
viterbi_pallas.INTERPRET = True
viterbi_pallas_fanin.INTERPRET = True
# without it the JAX CLI fills long pairs on its f64 banded scan core
viterbi_pallas_banded.INTERPRET = True
from pagan2_tpu.cli import main
sys.exit(main(sys.argv[1:]))
"""


def _family(tmp_path, n, L, seed=5, homopolymer=False):
    rng = np.random.default_rng(seed)
    alphabet = list("AACCGGTT") if homopolymer else list("ACGT")
    base = rng.choice(alphabet, size=L)
    with open(tmp_path / "seqs.fas", "w") as f:
        for i in range(n):
            mut = base.copy()
            idx = rng.random(L) < 0.1
            mut[idx] = rng.choice(list("ACGT"), size=int(idx.sum()))
            s = "".join(mut)
            if i % 3 == 1:
                s = s[:L // 3] + s[L // 3 + 12:]
            f.write(">s%d\n%s\n" % (i, s))

    def build(lo, hi):
        if hi - lo == 1:
            return "s%d:0.1" % lo
        mid = (lo + hi) // 2
        return "(%s,%s):0.05" % (build(lo, mid), build(mid, hi))
    (tmp_path / "tree.nh").write_text(build(0, n) + ";\n")


# terminal-penalty and skip-edge flags change the open/extension
# vectors the kernels read and the ancestral graphs they build
FLAGS = ["--no-reduced-terminal-penalties", "--no-terminal-edges",
         "--keep-all-edges"]


@pytest.mark.parametrize("case", ["family_6x300", "homopolymer_6x120",
                                  "flags_6x250"])
def test_port_cli_matches_reference_cli(tmp_path, case):
    homopolymer = case.startswith("homopolymer")
    if homopolymer:
        _family(tmp_path, 6, 120, seed=3, homopolymer=True)
    elif case.startswith("flags"):
        _family(tmp_path, 6, 250, seed=8)
    else:
        _family(tmp_path, 6, 300)
    common = ["-s", str(tmp_path / "seqs.fas"),
              "-t", str(tmp_path / "tree.nh")]
    if homopolymer:
        common.append("--homopolymer")
    if case.startswith("flags"):
        common += FLAGS
    env = dict(os.environ, PYTHONPATH=ROOT, JAX_PLATFORMS="cpu",
               JAX_ENABLE_X64="0",
               PAGAN2_JAX_CACHE=str(tmp_path / "jax_cache"))
    port = subprocess.Popen(
        [sys.executable, "-m", "pagan2_tpu_torch", "--device", "cpu",
         "--time", "-o", str(tmp_path / "port")] + common,
        env=env, cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True)
    ref = subprocess.Popen(
        [sys.executable, "-c", REFERENCE,
         "-o", str(tmp_path / "ref")] + common,
        env=env, cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True)
    pout, perr = port.communicate(timeout=600)
    rout, rerr = ref.communicate(timeout=600)
    assert port.returncode == 0, perr[-3000:]
    assert ref.returncode == 0, rerr[-3000:]
    a = (tmp_path / "port.fas").read_bytes()
    b = (tmp_path / "ref.fas").read_bytes()
    assert a == b
    m = re.search(r"routes\s+(\d+) batched fan-in launches; (\d+) "
                  r"windowed \+ (\d+) full-width", perr)
    assert m, perr[-2000:]
    batched, windowed, full = (int(g) for g in m.groups())
    if homopolymer:
        assert batched >= 1
    if case == "family_6x300":
        assert windowed >= 1
