"""The full-probability slice as a whole: `python -m pagan2_tpu_torch
--device cpu` with --full-probability, --sample-path and
--sample-additional-paths against the JAX package's CLI (f32, its Pallas
kernels in interpret mode) on a 6 x 120 family whose ancestors carry the
skip edges of a 12-bp deletion. The FASTA files must be byte-identical:
the seeded draws of both come from np.random.default_rng(7), in the same
job order. The posterior support of the root's sites, which no output
file of the CLI carries, is compared through align_progressive of both
packages in this process (the reference at f64, the port at f32):
tolerance 1e-4 absolute."""
import os
import re
import subprocess
import sys

import numpy as np
import pytest

from test_torch_progressive import REFERENCE, ROOT, _family

# the fourth Pallas module of the reference, in interpret mode as well
REFERENCE_FP = REFERENCE.replace(
    "from pagan2_tpu.cli import main",
    "from pagan2_tpu.align import fullprob_pallas\n"
    "fullprob_pallas.INTERPRET = True\n"
    "from pagan2_tpu.cli import main")

MODES = {"full_probability": ["--full-probability"],
         "sample_path": ["--sample-path", "--seed", "7"],
         "sample_additional_paths": ["--sample-additional-paths", "2",
                                     "--seed", "7"]}


@pytest.mark.parametrize("mode", list(MODES))
def test_port_cli_matches_reference_cli(tmp_path, mode):
    _family(tmp_path, 6, 120)
    common = ["-s", str(tmp_path / "seqs.fas"),
              "-t", str(tmp_path / "tree.nh")] + MODES[mode]
    env = dict(os.environ, PYTHONPATH=ROOT, JAX_PLATFORMS="cpu",
               JAX_ENABLE_X64="0", PAGAN2_STRICT="1",
               PAGAN2_JAX_CACHE=str(tmp_path / "jax_cache"))
    port = subprocess.Popen(
        [sys.executable, "-m", "pagan2_tpu_torch", "--device", "cpu",
         "--time", "-o", str(tmp_path / "port")] + common,
        env=env, cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True)
    ref = subprocess.Popen(
        [sys.executable, "-c", REFERENCE_FP,
         "-o", str(tmp_path / "ref")] + common,
        env=env, cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True)
    pout, perr = port.communicate(timeout=600)
    rout, rerr = ref.communicate(timeout=600)
    assert port.returncode == 0, perr[-3000:]
    assert ref.returncode == 0, rerr[-3000:]
    assert (tmp_path / "port.fas").read_bytes() == \
        (tmp_path / "ref.fas").read_bytes()
    m = re.search(r"(\d+) linear \+ (\d+) fan-in batched "
                  r"full-probability fills", perr)
    assert m, perr[-2000:]
    # the leaf pairs batch on the linear entry points, the ancestor
    # pairs of the later generations on the fan-in ones
    assert int(m.group(1)) >= 1 and int(m.group(2)) >= 1


def test_posterior_support_matches_reference(tmp_path):
    from dataclasses import replace
    import pagan2_tpu.align as ref_align
    from pagan2_tpu.io.fasta import read_sequences as ref_read
    from pagan2_tpu.pipeline import align_progressive as ref_progressive
    from pagan2_tpu_torch.align import AlignSettings
    from pagan2_tpu_torch.io.fasta import read_sequences
    from pagan2_tpu_torch.pipeline import align_progressive

    _family(tmp_path, 6, 120)
    tree = (tmp_path / "tree.nh").read_text()
    want = ref_progressive(
        ref_read(str(tmp_path / "seqs.fas")), tree,
        settings=replace(ref_align.AlignSettings(),
                         compute_full_score=True))
    got = align_progressive(
        read_sequences(str(tmp_path / "seqs.fas")), tree,
        settings=replace(AlignSettings(), compute_full_score=True),
        device="cpu")
    assert [e.sequence for e in got.alignment] == \
        [e.sequence for e in want.alignment]
    a = np.asarray(got.tree.graph.posterior_support)
    b = np.asarray(want.tree.graph.posterior_support)
    assert a.shape == b.shape
    print("posterior support: max |err| %.3g over %d sites, range "
          "[%.4f, %.4f]" % (np.abs(a - b).max(), len(a), a.min(), a.max()))
    np.testing.assert_allclose(a, b, atol=1e-4, rtol=0)
    real = a[1:-1]
    assert real.min() > 0 and real.max() <= 1 + 1e-4


def test_posterior_plot_file(tmp_path):
    """--mpost-posterior-plot-file implies the full score and writes one
    MetaPost figure per pairwise alignment."""
    from pagan2_tpu_torch import cli
    _family(tmp_path, 4, 40)
    plot = tmp_path / "post.mp"
    rc = cli.main(["--device", "cpu", "--silent",
                   "-s", str(tmp_path / "seqs.fas"),
                   "-t", str(tmp_path / "tree.nh"),
                   "-o", str(tmp_path / "out"),
                   "--mpost-posterior-plot-file", str(plot)])
    assert rc == 0
    text = plot.read_text()
    assert text.count("beginfig") == 3
