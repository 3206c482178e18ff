"""The rest of the JAX CLI in the port, held byte for byte against the
JAX CLI on the CPU: guide-tree inference (no -t), --output-ancestors,
--events, --output-nhx-tree, --xml-nhx, --mpost-graph-file (with the
leaf and alignment graphs), prune and trim after -q, --plot-anchors-for-R
on an anchored pair, --translate and --mt-translate (their .codon
files), --translate -q --score-as-dna, and the progressive cases no
other test holds: a 6 x 120 protein family, a 6 x 50-codon --codons
family and --outformat phylipi/paml/raxml.

One module-scoped fixture starts the port's CLI (--device cpu, the
kernels' plain versions) and the JAX CLI (f32, its Pallas kernels in
interpret mode) on the same inputs, in three processes at once: the JAX
CLI's DNA runs in one and its protein and codon runs in another, so
that each process traces its kernels' shapes once for all its runs.
Every output file and the stdout of every run must be the JAX CLI's."""
import json
import os
import subprocess
import sys

import numpy as np
import pytest

from pagan2_tpu_torch.io.fasta import FastaEntry
from pagan2_tpu_torch.io.translate import _code_table
from pagan2_tpu_torch.tools.bench_fanin import family
from pagan2_tpu_torch.tools.reads import placement_queries, write_reads
from pagan2_tpu_torch.tree.inference import infer_guide_tree

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

RUNNER = r"""
import json, sys
if sys.argv[1] == "ref":
    import jax
    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", False)
    from pagan2_tpu.align import (viterbi_pallas, viterbi_pallas_fanin,
                                  viterbi_pallas_banded)
    for m in (viterbi_pallas, viterbi_pallas_fanin, viterbi_pallas_banded):
        m.INTERPRET = True
    from pagan2_tpu.cli import main
else:
    from pagan2_tpu_torch.cli import main
for argv in json.loads(sys.argv[2]):
    rc = main(argv)
    print("== rc %d" % rc, flush=True)
"""

SIX = "((s0:0.1,(s1:0.1,s2:0.1):0.05):0.05,(s3:0.1,(s4:0.1,s5:0.1):0.05):0.05);"

# run -> (argv with {o} for the output prefix, the files it writes)
RUNS = {
    "infer": (["-s", "fam.fas", "--output-ancestors", "--events",
               "--output-nhx-tree", "--xml-nhx", "--mpost-graph-file",
               "{o}.mp", "--output-leaf-graphs",
               "--output-alignment-graphs"],
              (".fas", ".anctree", ".events", ".nhx_tree", ".xml", ".mp")),
    "prune": (["-s", "fam.fas", "-t", "fam.nh", "-q", "q.fas",
               "--terminal-nodes", "--prune-extended-alignment",
               "--prune-keep-number", "4", "--outformat", "raxml"],
              (".phy", ".pruned.phy", ".pruned.tre")),
    "trim": (["-s", "fam.fas", "-t", "fam.nh", "-q", "q.fas",
              "--terminal-nodes", "--trim-extended-alignment"],
             (".fas", ".trimmed.fas")),
    "anchors": (["-s", "pair.fas", "--plot-anchors-for-R", "{o}_anchors",
                 "--time"],
                (".fas", "_anchors_1.r")),
    "protein": (["-s", "prot.fas", "-t", "six.nh"], (".fas",)),
    "translate": (["-s", "cds.fas", "-t", "six.nh", "--translate",
                   "--output-ancestors", "--events", "--outformat",
                   "phylipi"],
                  (".phy", ".anctree", ".events", ".codon.phy",
                   ".codon.anctree")),
    "mt_translate": (["-s", "cds.fas", "-t", "six.nh", "--mt-translate",
                      "--outformat", "paml", "--xml"],
                     (".phy", ".xml", ".codon.phy", ".codon.xml")),
    "translate_q": (["-s", "cds.fas", "-t", "six.nh", "--translate", "-q",
                     "cq.fas", "--score-as-dna"],
                    (".fas", ".codon.fas")),
    "codons": (["-s", "cod50.fas", "-t", "six.nh", "--codons"], (".fas",)),
}

# the runs each process makes, in order
GROUPS = {"port": (tuple(RUNS),),
          "ref": (("infer", "prune", "trim", "anchors"),
                  ("protein", "translate", "mt_translate", "translate_q",
                   "codons"))}


def _inputs(d):
    """The runs' input files in d: a 6 x 90 family of bench.py's
    generator with its inferred guide tree and 5 queries (2 new members, 2 reads, a random
    sequence); a pair of it at 3,012 and 3,000 bp (each past the
    anchoring gate of 3,000 sites); a 6 x 120 protein family (15%
    substitutions) and the same family as coding DNA (a codon drawn
    for each residue), with 2 coding queries of 100 residues; its first
    50 codons as the --codons family."""
    seqs, _tree = family(6, 90)
    write_reads(str(d / "fam.fas"), seqs)
    # the tree the "infer" run infers, so that the JAX CLI's -t runs
    # align the family with the shapes it has traced there
    (d / "fam.nh").write_text(infer_guide_tree(
        [FastaEntry(name=n, sequence=q) for n, q in seqs], "dna") + "\n")
    write_reads(str(d / "q.fas"), placement_queries(90, 2, 2, 40, 70, 1, 1,
                                                    60))
    write_reads(str(d / "pair.fas"), family(2, 3012)[0])
    back = {}
    for codon, aa in sorted(_code_table(False).items()):
        back.setdefault(aa, []).append(codon)
    rng = np.random.default_rng(4)
    aas = list("ACDEFGHIKLMNPQRSTVWY")
    base = rng.choice(aas, 120)

    def member():
        m = base.copy()
        idx = rng.random(120) < 0.15
        m[idx] = rng.choice(aas, int(idx.sum()))
        return "".join(m)

    def coding(p):
        return "".join(back[a][rng.integers(len(back[a]))] for a in p)
    prot = [("s%d" % i, member()) for i in range(6)]
    cds = [(n, coding(p)) for n, p in prot]
    write_reads(str(d / "prot.fas"), prot)
    write_reads(str(d / "cds.fas"), cds)
    write_reads(str(d / "cod50.fas"), [(n, s[:150]) for n, s in cds])
    write_reads(str(d / "cq.fas"), [("q%d" % k, coding(member()[10:110]))
                                    for k in range(2)])
    (d / "six.nh").write_text(SIX + "\n")


@pytest.fixture(scope="module")
def cli_runs(tmp_path_factory):
    """Runs every run of RUNS through both CLIs, in the processes of
    GROUPS, all started at once; returns (directory, stdout of each run
    by side with its output prefix read as 'out', the port's stderr)."""
    d = tmp_path_factory.mktemp("cli_rest")
    _inputs(d)
    env = dict(os.environ, PYTHONPATH=ROOT, JAX_PLATFORMS="cpu",
               JAX_ENABLE_X64="0", OMP_NUM_THREADS="1",
               PAGAN2_JAX_CACHE=str(d / "jax_cache"))
    procs = {}
    for side, groups in GROUPS.items():
        extra = ["--device", "cpu"] if side == "port" else []
        for g in groups:
            runs = []
            for r in g:
                o = "%s_%s" % (side, r)
                runs.append(extra + [a.replace("{o}", o) for a in RUNS[r][0]]
                            + ["-o", o])
            procs[side, g] = subprocess.Popen(
                [sys.executable, "-c", RUNNER, side, json.dumps(runs)],
                env=env, cwd=str(d), stdout=subprocess.PIPE,
                stderr=subprocess.PIPE, text=True)
    said = {"port": {}, "ref": {}}
    try:
        for (side, g), p in procs.items():
            out, err = p.communicate(timeout=900)
            assert p.returncode == 0, err[-3000:]
            parts = out.split("== rc 0\n")
            assert len(parts) == len(g) + 1, out[-3000:]
            for r, text in zip(g, parts):
                said[side][r] = text.replace("%s_%s" % (side, r), "out")
            if side == "port":
                port_err = err
    finally:
        for p in procs.values():
            if p.poll() is None:
                p.kill()
                p.communicate()
    return d, said, port_err


@pytest.mark.parametrize("run", list(RUNS))
def test_port_cli_writes_the_jax_clis_bytes(cli_runs, run):
    """Every file the run writes, and its stdout, are the JAX CLI's."""
    d, said, _err = cli_runs
    assert said["port"][run] == said["ref"][run]
    assert "alignment:" in said["port"][run]
    for suffix in RUNS[run][1]:
        a = (d / ("port_" + run + suffix)).read_bytes()
        assert a and a == (d / ("ref_" + run + suffix)).read_bytes(), suffix


def test_runs_take_the_paths_they_name(cli_runs):
    """The pair anchored (one banded linear fill, its .r file), the
    placements were made (the random sequence and a read on terminal
    nodes discarded), and the translated runs' .codon rows are the input
    DNA with gaps."""
    d, said, err = cli_runs
    assert "1 banded linear fills" in err
    for run in ("prune", "trim"):
        assert "placed 3 queries, 2 discarded" in said["port"][run]
    assert "placed 2 queries, 0 discarded" in said["port"]["translate_q"]
    cds = dict(l.split("\n", 1) for l in
               (d / "cds.fas").read_text().lstrip(">").split("\n>"))
    rows = (d / "port_translate_q.codon.fas").read_text()
    got = dict(l.split("\n", 1) for l in rows.lstrip(">").split("\n>"))
    for name, dna in cds.items():
        assert got[name].replace("\n", "").replace("-", "") == \
            dna.replace("\n", "")
