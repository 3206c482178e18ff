"""The full-probability slice as a whole: `python -m pagan2_tpu_torch
--device cpu` with --full-probability, --sample-path and
--sample-additional-paths against the JAX package's CLI (f32, its Pallas
kernels in interpret mode) on a 6 x 120 family whose ancestors carry the
skip edges of a 12-bp deletion. The FASTA files must be byte-identical:
the seeded draws of both come from np.random.default_rng(7), in the same
job order. The amplicon family of ROADMAP Queue 3 (homopolymer-rich reads, many
tied paths) holds the Viterbi jobs of a batched full-probability bucket
to the reference's scan-core rule. The posterior support of the root's
sites, which no output file of the CLI carries, is compared through align_progressive of both
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


# ROADMAP Queue 3's tie-prone family: tools/reads.py's amplicon reads as
# a FASTA family under a balanced 8-leaf tree
AMPLICON_TREE = ("(((r000:0.1,r001:0.1):0.05,(r002:0.1,r003:0.1):0.05):0.05,"
                 "((r004:0.1,r005:0.1):0.05,(r006:0.1,r007:0.1):0.05)"
                 ":0.05);\n")


def amplicon_family(d):
    from pagan2_tpu_torch.tools.reads import amplicon_reads, write_reads
    write_reads(str(d / "amp.fas"), amplicon_reads(8, 120, 400, seed=7))
    (d / "amp.nh").write_text(AMPLICON_TREE)
    return d / "amp.fas", d / "amp.nh"


def test_full_probability_viterbi_jobs_take_the_scan_core_rule(tmp_path):
    """The reference fills the Viterbi jobs of a batched full-probability
    bucket on its scan core (batched_sheared_fill: M's candidates
    compared after the match score is added) on every backend; on the
    amplicon family the Pallas rule writes GGGG- where the scan core's
    writes GGG-G (first difference at byte 225). The port's CLI must
    write the JAX CLI's bytes."""
    fas, nh = amplicon_family(tmp_path)
    common = ["-s", str(fas), "-t", str(nh), "--full-probability"]
    env = dict(os.environ, PYTHONPATH=ROOT, JAX_PLATFORMS="cpu",
               JAX_ENABLE_X64="0", PAGAN2_STRICT="1",
               PAGAN2_JAX_CACHE=str(tmp_path / "jax_cache"))
    ref = subprocess.Popen(
        [sys.executable, "-c", REFERENCE_FP,
         "-o", str(tmp_path / "ref")] + common,
        env=env, cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True)
    from pagan2_tpu_torch import cli
    assert cli.main(["--device", "cpu", "--silent",
                     "-o", str(tmp_path / "port")] + common) == 0
    rout, rerr = ref.communicate(timeout=600)
    assert ref.returncode == 0, rerr[-3000:]
    assert (tmp_path / "port.fas").read_bytes() == \
        (tmp_path / "ref.fas").read_bytes()


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
