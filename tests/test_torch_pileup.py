"""Pileup (`--pileup`) in the port: pagan2_tpu_torch.pipeline.pileup
against the cases of tests/test_pileup.py (the placement-contig case is
left to placement), the verbatim copy of pipeline/orfs.py against the
cases of tests/test_orfs.py that need no placement, and the port's CLI
against the JAX package's CLI (its Pallas kernels in interpret mode,
f32) on bench.py's amplicon reads at its CPU size: every output file
byte-identical. All of it runs on the CPU (`device="cpu"`: the kernels'
plain versions)."""
import os
import subprocess
import sys

import numpy as np
import pytest

from pagan2_tpu_torch.io.fasta import FastaEntry, read_fasta
from pagan2_tpu_torch.pipeline.pileup import (pileup_align, PileupConfig,
                                              reconstruct_contigs,
                                              translated_pileup_align)
from pagan2_tpu_torch.pipeline.orfs import find_orfs
from pagan2_tpu_torch.tools.reads import amplicon_reads, write_reads

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TEMPLATE = "ACGGTTACGATCGATTGGCACGTAGCTAGCTTAGGCCATAACGT"


def pile(reads, data_type=None, config=None, **kw):
    return pileup_align(reads, data_type, config, device="cpu", **kw)


def reads_from_template(rng, n, length=20, step=6, err=0.0):
    reads = []
    for i in range(n):
        start = (i * step) % max(1, len(TEMPLATE) - length)
        s = list(TEMPLATE[start:start + length])
        for k in range(len(s)):
            if rng.random() < err:
                s[k] = "ACGT"[rng.integers(4)]
        reads.append(FastaEntry(name=f"r{i}", sequence="".join(s)))
    return reads


def test_identical_reads():
    reads = [FastaEntry(name=f"r{i}", sequence="ACGTTGCA") for i in range(4)]
    res = pile(reads)
    assert len(res.alignment) == 4
    assert all(e.sequence == "ACGTTGCA" for e in res.alignment)
    assert res.discarded == []


def test_overlapping_reads():
    reads = reads_from_template(np.random.default_rng(3), 5)
    res = pile(reads)
    by = {e.name: e.sequence for e in res.alignment}
    assert len({len(s) for s in by.values()}) == 1
    for r in reads:
        if r.name in by:
            assert by[r.name].replace("-", "") == r.sequence


def test_junk_read_discarded():
    reads = [FastaEntry(name="r0", sequence="ACGTTGCAACGTACGT"),
             FastaEntry(name="r1", sequence="ACGTTGCAACGTACGT"),
             FastaEntry(name="junk", sequence="TTTTCCCCTTTTCCCC")]
    res = pile(reads)
    assert "junk" in res.discarded
    assert "junk" not in {e.name for e in res.alignment}


def test_reverse_strand():
    from pagan2_tpu_torch.graph import revcomp
    s = "ACGGTTACGATCGATTGGCA"
    reads = [FastaEntry(name="r0", sequence=s),
             FastaEntry(name="r1", sequence=revcomp(s))]
    res = pile(reads, config=PileupConfig(both_strands=True))
    assert res.discarded == []
    by = {e.name: e.sequence for e in res.alignment}
    assert by["r1"] == by["r0"]


@pytest.mark.parametrize("odd", [False, True], ids=["all", "majority"])
def test_consensus(odd):
    """Six copies of the template give it back; with one read off at
    one base the majority still wins."""
    reads = [FastaEntry(name=f"r{i}", sequence=TEMPLATE)
             for i in range(5 if odd else 6)]
    if odd:
        assert TEMPLATE[10] != "G"
        reads.append(FastaEntry(name="odd", sequence=TEMPLATE[:10] + "G"
                                + TEMPLATE[11:]))
    res = pile(reads, config=PileupConfig(use_consensus=True,
                                          consensus_minimum=3))
    assert res.consensus == TEMPLATE


def test_homopolymer_pileup():
    reads = [FastaEntry(name="r0", sequence="ACGGGGTACGTACGT"),
             FastaEntry(name="r1", sequence="ACGGGTACGTACGT"),
             FastaEntry(name="r2", sequence="ACGGGGGTACGTACGT")]
    res = pile(reads, config=PileupConfig(homopolymer=True))
    assert res.discarded == []
    assert len({len(e.sequence) for e in res.alignment}) == 1


def test_both_strands_batches_through_executor():
    """--both-strands launches each read's forward and reverse-complement
    jobs as one batched fill (execute_pair_jobs on the given device)."""
    from pagan2_tpu_torch.graph import revcomp
    from pagan2_tpu_torch.parallel import executor
    rng = np.random.default_rng(8)
    tmpl = "".join(rng.choice(list("ACGT"), size=40))
    reads = [FastaEntry(name="r0", sequence=tmpl),
             FastaEntry(name="r1", sequence=revcomp(tmpl)),
             FastaEntry(name="r2", sequence=tmpl[5:35])]
    executor.reset_stats()
    res = pile(reads, config=PileupConfig(both_strands=True))
    assert executor.EXEC_STATS["launches"] >= 1, executor.EXEC_STATS
    assert executor.EXEC_STATS["batched_jobs"] >= 2
    assert res.discarded == []
    by = {e.name: e.sequence for e in res.alignment}
    assert by["r1"] == by["r0"]


def test_build_contigs_includes_read_rows():
    reads = [FastaEntry("r1", "ACGTACGTGGACTTACGT"),
             FastaEntry("r2", "ACGTACGTGGACTTACGT"),
             FastaEntry("r3", "GGACTTACGTTTGCAGGC")]
    cfg = PileupConfig(min_query_overlap=0.2, min_query_identity=0.2,
                       use_consensus=True, consensus_minimum=1,
                       consensus_minimum_proportion=0.1)
    res = pile(reads, "dna", cfg)
    only = reconstruct_contigs(res.root, cfg, consensus_only=True)
    both = reconstruct_contigs(res.root, cfg, consensus_only=False)
    assert all(e.name.startswith("consensus_") for e in only)
    read_rows = [e for e in both if not e.name.startswith("consensus_")]
    assert read_rows
    cons = [e for e in both if e.name.startswith("consensus_")]
    assert {len(e.sequence) for e in both} == {len(cons[0].sequence)}
    assert all(e.sequence.replace("-", "") for e in read_rows)


def test_deep_homopolymer_pileup_k5():
    """Reads of a template with a run of five As: raw fan-in K 5 on the
    leaves and the growing root, filled on kernel B's plain version."""
    from pagan2_tpu_torch.align.viterbi_fanin import fanin_stats
    from pagan2_tpu_torch.graph import build_leaf_graph
    tmpl = "CGTCGTACGAAAAATGCATGCTGACTGAC"
    reads = [FastaEntry(name="r0", sequence=tmpl),
             FastaEntry(name="r3", sequence=tmpl.replace("AAAAA", "AAAAAA")),
             FastaEntry(name="r1", sequence=tmpl[:22]),
             FastaEntry(name="r2", sequence=tmpl[6:]),
             FastaEntry(name="r4", sequence=tmpl.replace("AAAAA", "AAAA"))]
    assert fanin_stats(build_leaf_graph(tmpl, "dna", homopolymer=True))[0] \
        >= 5
    res = pile(reads, config=PileupConfig(homopolymer=True,
                                          use_consensus=True))
    assert res.discarded == []
    assert len({len(e.sequence) for e in res.alignment}) == 1
    core = res.consensus.replace("-", "")
    assert "ACGAAAA" in core and "TGCATGCT" in core, res.consensus


def test_banded_reads_match_unbanded():
    """Read-vs-root pairs anchor from anchor_reads_min_sites (200): the
    banded pileup gives the rows of the unbanded one."""
    rng = np.random.default_rng(31)
    parts, total = [], 0
    while total < 230:
        c = "ACGT"[int(rng.integers(0, 4))]
        parts.append(c * int(rng.integers(1, 5)))
        total += len(parts[-1])
    genome = "".join(parts)
    reads = []
    for k in range(8):
        start = int(rng.integers(0, len(genome) - 210))
        r = []
        for c in genome[start:start + 210]:
            u = rng.random()
            if u < 0.01:
                r.append(c + c)
            elif u >= 0.02:
                r.append(c)
        reads.append(FastaEntry(f"r{k}", "".join(r)))

    def rows(min_sites):
        res = pile(reads, config=PileupConfig(
            homopolymer=True, use_consensus=True,
            anchor_reads_min_sites=min_sites))
        return ({e.name: e.sequence for e in res.alignment},
                res.consensus, res.discarded)
    assert rows(200) == rows(10 ** 9)


# ----------------------------------------------------------------------
# pipeline/orfs.py (a verbatim copy) and the translated pileup
def _orf_dna(prot: str, mt=False) -> str:
    from pagan2_tpu_torch.io.translate import _mock_codons
    rep = _mock_codons(mt)
    return "".join(rep[a] for a in prot)


def test_find_orfs_simple():
    prot = "MKLVINGGGHHEELLKKVVMMAA"
    dna = _orf_dna(prot)
    f1 = [o for o in find_orfs(dna, min_orf_length=10) if o.frame == 1]
    assert f1 and f1[0].translation == prot
    assert (f1[0].start, f1[0].end) == (0, len(dna) - 1)


def test_find_orfs_stop_splits():
    protA, protB = "MKLVINGGGHHEELL", "KKVVMMAAHHEELLG"
    dna = _orf_dna(protA) + "TAA" + _orf_dna(protB)
    orfs = [o for o in find_orfs(dna, min_orf_length=10) if o.frame == 1]
    assert [o.translation for o in orfs] == [protA, protB]
    assert orfs[1].start == len(protA) * 3 + 3


def test_find_orfs_reverse_strand():
    from pagan2_tpu_torch.graph.builders import revcomp
    prot = "MKLVINGGGHHEELL"
    dna = revcomp(_orf_dna(prot))
    orfs = [o for o in find_orfs(dna, min_orf_length=10) if o.frame < 0]
    o = next(o for o in orfs if o.translation == prot)
    assert o.frame == -1 and o.start == 0 and o.end == len(dna) - 1


def test_find_orfs_min_length_and_coverage():
    assert find_orfs(_orf_dna("MKLVI"), min_orf_length=10) == []
    prot = "MKLVINGGGHHEELLKKVV"
    orfs = find_orfs(_orf_dna(prot), min_orf_coverage=0.9)
    assert any(o.translation == prot for o in orfs)


def test_translated_pileup():
    """--find-orfs: each read's ORFs aligned as protein to the root."""
    core = "MKLVINGGGHHEELLKKVVMMAAWWQQRRDDEE"
    reads = [FastaEntry(name="r1", sequence=_orf_dna(core)),
             FastaEntry(name="r2", sequence=_orf_dna(core[5:25])),
             FastaEntry(name="r3", sequence="TTTTTTTTTTTT")]
    cfg = PileupConfig(min_query_overlap=0.3, min_query_identity=0.3)
    res = translated_pileup_align(reads, cfg, min_orf_length=10,
                                  device="cpu")
    names = [e.name for e in res.alignment]
    assert "r1" in names and "r2_orf1" in names
    assert "r3" in res.discarded
    row = {e.name: e.sequence for e in res.alignment}["r1"]
    assert set(row) <= set("ARNDCQEGHILKMFPSTWYVX-")


# ----------------------------------------------------------------------
# the CLI: what still raises, and parity with the JAX CLI
from pagan2_tpu_torch import cli                               # noqa: E402

REFERENCE = r"""
import sys
import jax
jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", False)
from pagan2_tpu.align import (viterbi_pallas, viterbi_pallas_fanin,
                              viterbi_pallas_banded)
viterbi_pallas.INTERPRET = True
viterbi_pallas_fanin.INTERPRET = True
viterbi_pallas_banded.INTERPRET = True
from pagan2_tpu.cli import main
sys.exit(main(sys.argv[1:]))
"""


@pytest.mark.parametrize("flags", [
    ["--ref-seqfile", "ref.fas", "--ref-treefile", "t.nh"],
    ["-q", "reads.fas"], ["-q", "reads.fas", "--align-reads-at-root"]],
    ids=["ref_seqfile", "queries", "queries_at_root"])
def test_placement_flags_still_raise(tmp_path, monkeypatch, flags):
    """Placement (ROADMAP Queue 1 item 9) is ported: --ref-seqfile with
    its --ref-treefile, and -q without --pileup (placement onto the
    progressive alignment, or --align-reads-at-root), no longer raise;
    each run exits 0 and writes out.fas with every row."""
    monkeypatch.chdir(tmp_path)
    (tmp_path / "s.fas").write_text(">a\nACGTACGTTGCA\n>b\nACGTACTTGCA\n")
    (tmp_path / "ref.fas").write_text(
        ">a\nACGTACGTTGCA\n>b\nACGTAC-TTGCA\n")
    (tmp_path / "t.nh").write_text("(a:0.1,b:0.1);\n")
    (tmp_path / "reads.fas").write_text(">r\nACGTACGTTGCA\n")
    argv = ["--device", "cpu", "-s", "s.fas", "-t", "t.nh", "-o", "out",
            "--silent"]
    assert cli.main(argv + flags) == 0
    names = [e.name for e in read_fasta("out.fas")]
    assert {"a", "b"} <= set(names)
    assert any(n.startswith("r") for n in names) == ("-q" in flags)


def test_pileup_without_reads_exits_1(tmp_path, capsys):
    assert cli.main(["--device", "cpu", "--pileup",
                     "-o", str(tmp_path / "out")]) == 1
    assert "--pileup requires -q/--queryfile" in capsys.readouterr().err


def run_both(tmp_path, reads_file, flags, outputs):
    """The port's CLI (--device cpu) and the JAX CLI on the same reads,
    at once; every file of `outputs` (suffixes) byte-identical."""
    env = dict(os.environ, PYTHONPATH=ROOT, JAX_PLATFORMS="cpu",
               JAX_ENABLE_X64="0",
               PAGAN2_JAX_CACHE=str(tmp_path / "jax_cache"))
    common = ["--pileup", "-q", str(reads_file)] + flags
    procs = [subprocess.Popen(
        cmd + ["-o", str(tmp_path / name)] + common, env=env, cwd=ROOT,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for name, cmd in (
            ("port", [sys.executable, "-m", "pagan2_tpu_torch",
                      "--device", "cpu", "--time"]),
            ("ref", [sys.executable, "-c", REFERENCE]))]
    outs = [p.communicate(timeout=600) for p in procs]
    for p, (out, err) in zip(procs, outs):
        assert p.returncode == 0, err[-3000:]
    # the "pileup: N rows, M reads discarded -> out" line
    assert outs[0][0].replace(str(tmp_path / "port"), "out") == \
        outs[1][0].replace(str(tmp_path / "ref"), "out")
    for suffix in outputs:
        a = (tmp_path / ("port" + suffix)).read_bytes()
        assert a == (tmp_path / ("ref" + suffix)).read_bytes(), suffix
        assert a
    return outs[0][1]


@pytest.mark.parametrize("case", ["homopolymer", "both_strands"])
def test_port_pileup_cli_matches_reference_cli(tmp_path, case):
    """bench.py's amplicon reads at its CPU size (6 x 96 from a 110-bp
    genome): --homopolymer --output-consensus with the XML, graph and
    NEXUS writers in one run; --both-strands --build-contigs in the
    other."""
    reads = write_reads(str(tmp_path / "reads.fas"),
                        amplicon_reads(6, 96, 110))
    if case == "homopolymer":
        run_both(tmp_path, reads,
                 ["--homopolymer", "--output-consensus", "--xml",
                  "--output-graph", "--outformat", "nexus"],
                 [".nex", ".xml", ".grp", "_consensus.fas"])
    else:
        err = run_both(tmp_path, reads, ["--both-strands",
                                         "--build-contigs"],
                       [".fas", "_contigs.fas"])
        assert "batched fan-in launches" in err
