"""Anchored long linear pairs through the CLI: `python -m
pagan2_tpu_torch --device cpu` against the JAX package's CLI (its Pallas
kernels in interpret mode, f32, the banded one included) on a 3,500 bp
pair and a 4 x 3,200 bp family (bench.py's family generator, seed 5).
The FASTA files must be byte-identical, the port's `--time` routes line
must show its banded fills (kernel C's plain version here), and the
port's anchored output must equal its own `--no-anchors` output."""
import os
import re
import subprocess
import sys

import numpy as np
import pytest

from test_torch_progressive import REFERENCE, _family

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _long_pair(tmp_path, n=3500, seed=1):
    """A 3,500 bp pair: 5% substitutions and a 12-bp deletion."""
    rng = np.random.default_rng(seed)
    base = rng.choice(list("ACGT"), size=n)
    mut = base.copy()
    idx = rng.random(n) < 0.05
    mut[idx] = rng.choice(list("ACGT"), size=int(idx.sum()))
    s2 = "".join(mut)
    s2 = s2[:n // 2] + s2[n // 2 + 12:]
    (tmp_path / "seqs.fas").write_text(">a\n%s\n>b\n%s\n"
                                       % ("".join(base), s2))
    (tmp_path / "tree.nh").write_text("(a:0.1,b:0.1);\n")


def _run_both(tmp_path, extra_port=()):
    common = ["-s", str(tmp_path / "seqs.fas"),
              "-t", str(tmp_path / "tree.nh")]
    env = dict(os.environ, PYTHONPATH=ROOT, JAX_PLATFORMS="cpu",
               JAX_ENABLE_X64="0",
               PAGAN2_JAX_CACHE=str(tmp_path / "jax_cache"))
    port = subprocess.Popen(
        [sys.executable, "-m", "pagan2_tpu_torch", "--device", "cpu",
         "--time", "-o", str(tmp_path / "port")] + common,
        env=env, cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True)
    ref = subprocess.Popen(
        [sys.executable, "-c", REFERENCE, "-o", str(tmp_path / "ref")]
        + common, env=env, cwd=ROOT, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True)
    pout, perr = port.communicate(timeout=600)
    rout, rerr = ref.communicate(timeout=600)
    assert port.returncode == 0, perr[-3000:]
    assert ref.returncode == 0, rerr[-3000:]
    return perr


@pytest.mark.parametrize("case", ["pair_3500", "family_4x3200"])
def test_long_cli_matches_reference(tmp_path, case):
    if case == "pair_3500":
        _long_pair(tmp_path)
    else:
        _family(tmp_path, 4, 3200, seed=5)
    perr = _run_both(tmp_path)
    a = (tmp_path / "port.fas").read_bytes()
    assert a == (tmp_path / "ref.fas").read_bytes()
    m = re.search(r"routes\s.*; (\d+) banded linear fills", perr)
    assert m, perr[-2000:]
    # every leaf pair of this input has a thin anchored band
    assert int(m.group(1)) == (1 if case == "pair_3500" else 2)


def test_no_anchors_matches_anchored(tmp_path):
    """The verify recipe's check: the anchored (banded) alignment of the
    3,500 bp pair equals the full-matrix one."""
    _long_pair(tmp_path)
    env = dict(os.environ, PYTHONPATH=ROOT)
    outs = []
    for flags in ([], ["--no-anchors"]):
        out = str(tmp_path / ("full" if flags else "anchored"))
        proc = subprocess.run(
            [sys.executable, "-m", "pagan2_tpu_torch", "--device", "cpu",
             "--time", "-s", str(tmp_path / "seqs.fas"),
             "-t", str(tmp_path / "tree.nh"), "-o", out] + flags,
            env=env, cwd=ROOT, capture_output=True, text=True, timeout=600)
        assert proc.returncode == 0, proc.stderr[-3000:]
        m = re.search(r"; (\d+) banded linear fills", proc.stderr)
        assert m and int(m.group(1)) == (0 if flags else 1)
        outs.append(open(out + ".fas", "rb").read())
    assert outs[0] == outs[1]
