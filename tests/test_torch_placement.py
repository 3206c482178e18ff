"""Query placement and reference alignments in the port:
pagan2_tpu_torch.pipeline.{refread,placement} and the CLI's -q,
--ref-seqfile/--ref-treefile, --fragments and --align-reads-at-root,
held against the JAX package on the CPU.

Every case runs once on each side: the port with `device="cpu"` (the
kernels' plain versions), the JAX package as its CLI runs for the
reference files (f32, its three Viterbi Pallas kernels in interpret
mode). The cases are those of tests/test_placement.py, the placement
cases of tests/test_flags_wiring.py, tests/test_pileup.py's placement
contigs, tests/test_orfs.py's translated placement and
tests/test_cli_io.py's -q after a progressive run: each keeps its
original assertions on the port's result, and the two sides must give
the same placed and discarded queries and the same alignment rows.
read_reference_alignment's graphs are compared node for node, field
for field. One module-scoped fixture runs the port's CLI and the JAX
CLI at once on a 6 x 150 family with 8 queries of
tools/reads.py::placement_queries; every output file must be
byte-identical."""
import json
import os
import subprocess
import sys
from types import SimpleNamespace

import pytest
import torch

import pagan2_tpu_torch.cli as P_CLI
import pagan2_tpu_torch.io.fasta as P_FA
import pagan2_tpu_torch.io.translate as P_TR
import pagan2_tpu_torch.models as P_MO
import pagan2_tpu_torch.parallel.executor as P_EX
import pagan2_tpu_torch.pipeline.pileup as P_PU
import pagan2_tpu_torch.pipeline.placement as P_PL
import pagan2_tpu_torch.pipeline.progressive as P_PG
import pagan2_tpu_torch.pipeline.refread as P_RR
from pagan2_tpu_torch.tools.bench_fanin import family
from pagan2_tpu_torch.tools.reads import placement_queries, write_reads

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _side(port):
    if port:
        fa, tr, mo, pu, pl, pg, rr, cli = (P_FA, P_TR, P_MO, P_PU, P_PL,
                                           P_PG, P_RR, P_CLI)
    else:
        import pagan2_tpu.cli as cli
        import pagan2_tpu.io.fasta as fa
        import pagan2_tpu.io.translate as tr
        import pagan2_tpu.models as mo
        import pagan2_tpu.pipeline.pileup as pu
        import pagan2_tpu.pipeline.placement as pl
        import pagan2_tpu.pipeline.progressive as pg
        import pagan2_tpu.pipeline.refread as rr
    kw = {"device": "cpu"} if port else {}
    return SimpleNamespace(
        port=port, FastaEntry=fa.FastaEntry, fasta=fa, translate=tr,
        ModelFactory=mo.ModelFactory, pileup=pu, placement=pl,
        PlacementConfig=pl.PlacementConfig, cli=cli,
        read_reference_alignment=rr.read_reference_alignment,
        progressive=lambda *a, **k: pg.align_progressive(*a, **kw, **k),
        place=lambda *a, **k: pl.place_queries(*a, **kw, **k),
        cli_argv=["--device", "cpu"] if port else [])


PORT = _side(True)


@pytest.fixture(scope="module")
def ref():
    """The JAX package as the reference CLI runs it (REFERENCE in
    tests/test_torch_progressive.py): x64 off, the linear, fan-in and
    banded Viterbi Pallas kernels in interpret mode; restored after."""
    import jax
    from pagan2_tpu.align import (viterbi_pallas, viterbi_pallas_fanin,
                                  viterbi_pallas_banded)
    mods = (viterbi_pallas, viterbi_pallas_fanin, viterbi_pallas_banded)
    x64 = jax.config.jax_enable_x64
    saved = [m.INTERPRET for m in mods]
    jax.config.update("jax_enable_x64", False)
    for m in mods:
        m.INTERPRET = True
    yield _side(False)
    jax.config.update("jax_enable_x64", x64)
    for m, v in zip(mods, saved):
        m.INTERPRET = v


def rows(aln):
    return [(e.name, e.sequence) for e in aln]


def summary(out):
    """What a placement gives: placed, discarded, the alignment rows."""
    return (list(out.placed), [e.name for e in out.discarded],
            rows(out.result.alignment))


def both(ref, case):
    """case(side) on the port and on the JAX package; the port's result,
    after the two summaries (summary() for a placement) are equal."""
    got, want = case(PORT), case(ref)
    s = summary if hasattr(got, "placed") else (lambda r: r)
    assert s(got) == s(want)
    return got


def graph_fields(g):
    """Every field of a sequence graph, its edge lists included."""
    d = {k: v for k, v in vars(g).items() if k != "edges"}
    d.update({"edges." + k: v for k, v in vars(g.edges).items()})
    return d


def same_graphs(a, b):
    """Two trees node for node: names, branch lengths and graph fields
    equal element for element."""
    na, nb = list(a.nodes_postorder()), list(b.nodes_postorder())
    assert [(n.name, n.dist) for n in na] == [(n.name, n.dist) for n in nb]
    for x, y in zip(na, nb):
        fx, fy = graph_fields(x.graph), graph_fields(y.graph)
        assert fx.keys() == fy.keys()
        for k in fx:
            assert fx[k] == fy[k], (x.name, k)
        assert x.graph.gapped_seq is not None


# ---------------------------------------------- tests/test_placement.py
TREE = "((a:0.1,b:0.2):0.05,(c:0.15,d:0.1):0.1);"
SEQS = [("a", "ACGTACGTGGACTTACGT"), ("b", "ACGTACGGACTTAGGT"),
        ("c", "ACGTATGTGGACTTACGA"), ("d", "ACCTACGTGGATTTACGT")]


def aligned_rows(side):
    res = side.progressive([side.FastaEntry(n, s) for n, s in SEQS], TREE,
                           data_type="dna")
    return [side.FastaEntry(e.name, e.sequence) for e in res.alignment]


def reference(side):
    return side.read_reference_alignment(aligned_rows(side), TREE,
                                         data_type="dna")


def place_one(side, seq, name="q", **cfg):
    return side.place(reference(side), [side.FastaEntry(name, seq)],
                      "dna",
                      side.PlacementConfig(one_placement_only=True, **cfg))


def test_refread_roundtrip(ref):
    def case(side):
        r = aligned_rows(side)
        return rows(r), rows(side.read_reference_alignment(
            r, TREE, data_type="dna").alignment)
    given, got = both(ref, case)
    assert dict(got) == dict(given)


def test_refread_rejects_ragged(ref):
    for side in (PORT, ref):
        r = aligned_rows(side)
        r[0].sequence = r[0].sequence + "A"
        with pytest.raises(ValueError):
            side.read_reference_alignment(r, TREE, data_type="dna")


def test_refread_builds_internal_graphs(ref):
    """Every node has a graph with its gapped row, and the port's tree
    is the JAX package's node for node."""
    got, want = reference(PORT), reference(ref)
    same_graphs(got.tree, want.tree)
    assert rows(got.alignment) == rows(want.alignment)


def test_placement_exact_query(ref):
    out = both(ref, lambda side: place_one(side, "ACGTACGTGGACTTACGT"))
    assert "q" in out.placed
    got = dict(rows(out.result.alignment))
    assert got["q"].replace("-", "") == "ACGTACGTGGACTTACGT"
    assert len({len(s) for s in got.values()}) == 1


def test_placement_query_with_insertion(ref):
    """A read insertion adds columns to the global alignment
    (additional_sites_before_alignment_column, node.cpp:976-1059)."""
    width = len(aligned_rows(PORT)[0].sequence)
    out = both(ref, lambda side: place_one(side, "ACGTACGTAAAGGACTTACGT"))
    assert "q" in out.placed
    got = dict(rows(out.result.alignment))
    assert {len(s) for s in got.values()} == {width + 3}
    assert got["q"].replace("-", "") == "ACGTACGTAAAGGACTTACGT"
    assert got["a"].replace("-", "") == "ACGTACGTGGACTTACGT"


def test_placement_discards_garbage(ref):
    out = both(ref, lambda side: place_one(side, "T" * 18, "junk"))
    assert [e.name for e in out.discarded] == ["junk"] or \
        "junk" not in dict(rows(out.result.alignment))


def test_placement_both_strands(ref):
    rc = "ACGTACGTGGACTTACGT".translate(str.maketrans("ACGT", "TGCA"))[::-1]
    out = both(ref, lambda side: place_one(side, rc, both_strands=True))
    assert "q" in out.placed


def test_placement_terminal_nodes_only(ref):
    out = both(ref, lambda side: place_one(side, "ACGTACGTGGACTTACGT",
                                           terminal_nodes=True))
    assert "q" in out.placed
    for n in out.result.tree.nodes_postorder():
        if not n.is_leaf and n.right.name == "q":
            assert n.left.is_leaf
            break
    else:
        pytest.fail("q not found in tree")


def test_placement_scoring_batches_through_executor(ref):
    """Candidate scoring (query x node x strand) goes through the
    batched executor: 7 nodes x 2 strands in shared launches."""
    def case(side):
        if side.port:
            P_EX.reset_stats()
        return place_one(side, "ACGTACGTGGACTTACGT", both_strands=True)
    out = both(ref, case)
    assert P_EX.EXEC_STATS["launches"] >= 1, P_EX.EXEC_STATS
    assert P_EX.EXEC_STATS["batched_jobs"] >= 4, P_EX.EXEC_STATS
    assert "q" in out.placed
    got = dict(rows(out.result.alignment))
    assert got["q"].replace("-", "") == "ACGTACGTGGACTTACGT"


def test_refread_accepts_dot_gaps(ref):
    def case(side):
        r = aligned_rows(side)
        return [rows(side.read_reference_alignment(
            [side.FastaEntry(e.name, e.sequence.replace("-", gap))
             for e in r], TREE, data_type="dna").alignment)
            for gap in "-."]
    dashed, dotted = both(ref, case)
    assert dashed == dotted


# ---------------- placement cases of tests/test_flags_wiring.py:208-356
def scored_ref(side):
    entries = [side.FastaEntry("a", "ACGTACGTGGACTTACGTTGCA"),
               side.FastaEntry("b", "ACGTACGTGGACTTACGTTGCA")]
    return side.read_reference_alignment(entries, "(a:0.1,b:0.1);",
                                         data_type="dna")


WEAK = ("weak", "ACGTACGTGGACAAACGTTGCA")      # 3 mismatches
STRONG = ("strong", "ACGTACGTGGACTTACGTTGCA")  # exact
LOOSE = dict(one_placement_only=True, min_query_overlap=0.4,
             min_query_identity=0.4)


def place_scored(side, queries, **cfg):
    return side.place(scored_ref(side),
                      [side.FastaEntry(n, s) for n, s in queries], "dna",
                      side.PlacementConfig(**LOOSE, **cfg))


@pytest.mark.parametrize("fragments", [True, False],
                         ids=["fragments", "input_order"])
def test_fragments_orders_queries_by_score(ref, fragments):
    """--fragments inserts the queries grouped on a node best score
    first (sort_reads_vector, reads_aligner.cpp:443-468); without it,
    input order rules."""
    out = both(ref, lambda side: place_scored(side, [WEAK, STRONG],
                                              fragments=fragments))
    assert set(out.placed) == {"weak", "strong"}
    assert out.placed[0] == ("strong" if fragments else "weak")


def test_fragments_chains_queries_on_one_node(ref):
    """Accepted queries on one node stack onto the merged node
    (current_root chaining, reads_aligner.cpp:483-620)."""
    qs = [("q%d" % i, STRONG[1]) for i in (1, 2, 3)]
    out = both(ref, lambda side: place_scored(side, qs, fragments=True))
    assert len(out.placed) == 3
    got = dict(rows(out.result.alignment))
    assert len({len(s) for s in got.values()}) == 1
    for q in ("q1", "q2", "q3"):
        assert got[q].replace("-", "") == STRONG[1]


@pytest.mark.parametrize("rank", [False, True], ids=["unscored", "ranked"])
def test_rank_reads_for_nodes_scores_single_candidates(ref, rank):
    """One candidate (the --assembly root): assigned unscored in input
    order, unless --rank-reads-for-nodes scores it
    (reads_aligner.cpp:2748)."""
    out = both(ref, lambda side: place_scored(
        side, [WEAK, STRONG], fragments=True, assembly=True,
        rank_reads_for_nodes=rank))
    assert out.placed[0] == ("strong" if rank else "weak")


def test_tid_for_subroot_moves_tag_up(ref):
    """--tid-for-subroot: the spliced parent inherits the target's NHX
    TID tag (reads_aligner.cpp:858-862)."""
    def case(side):
        entries = [side.FastaEntry(name="a", sequence="ACGTACGTAA"),
                   side.FastaEntry(name="b", sequence="ACGTACGTAA"),
                   side.FastaEntry(name="c", sequence="TTTTGGGGCC")]
        res = side.read_reference_alignment(
            entries, "((a:0.1,b:0.1)[&&NHX:TID=1]:0.1,c:0.2);",
            data_type="dna")
        q = [side.FastaEntry(name="q1", sequence="ACGTACGTAA",
                             comment="TID=1")]
        return side.place(res, q, "dna", side.PlacementConfig(
            guided=True, tid_for_subroot=True, **LOOSE))
    out = both(ref, case)
    assert out.placed
    tagged = [n for n in out.result.tree.nodes_postorder()
              if n.nhx_tid == "1"]
    assert len(tagged) == 1
    t = tagged[0]
    assert not t.is_leaf and t.name.startswith("#")
    assert t.left.nhx_tid == "" and t.right.nhx_tid == ""


def test_preselection_keeps_best_candidates(ref):
    def case(side):
        entries = [side.FastaEntry("a", "ACGTACGTGGACTTACGTACGT"),
                   side.FastaEntry("b", "ACGTACGTGGACTTACGAACGT"),
                   side.FastaEntry("c", "TTGCAGGCCATTGCAGGCCATT"),
                   side.FastaEntry("d", "TTGCAGGCCATTGCAGGCCTTT")]
        res = side.progressive(entries,
                               "((a:0.1,b:0.1):0.1,(c:0.1,d:0.1):0.1);",
                               data_type="dna")
        nodes = {n.name: n for n in res.tree.nodes_postorder()}
        cand = [n for n in nodes if nodes[n].is_leaf]
        q = side.FastaEntry("q", "ACGTACGTGGACTTACGTACGT")
        pre = side.placement._preselect_candidates
        return (cand, pre(q, cand, nodes, 2, k=8),
                pre(q, cand, nodes, 10))
    cand, kept, all_kept = both(ref, case)
    assert set(kept) == {"a", "b"}
    assert all_kept == cand


def test_very_fast_placement_end_to_end(ref):
    out = both(ref, lambda side: place_scored(side, [("q", STRONG[1])],
                                              preselect_keep_best=1))
    assert out.placed == ["q"]


def test_score_as_dna_places_translated_query(ref):
    """--score-as-dna with a translated run: candidates score on the
    original DNA (reads_aligner.cpp:2930-2942) through a dna_map; the
    placement itself is protein."""
    dna = "ATGAAACTGGTGATTAACTCG"

    def case(side):
        entries = [side.FastaEntry("a", dna), side.FastaEntry("b", dna)]
        dna_map = side.translate.translate_entries(entries)
        queries = [side.FastaEntry("q", dna)]
        dna_map.update(side.translate.translate_entries(queries))
        res = side.read_reference_alignment(entries, "(a:0.1,b:0.1);",
                                            data_type="protein")
        return side.place(res, queries, "protein", side.PlacementConfig(
            score_as_dna=True, terminal_nodes=True, **LOOSE),
            dna_map=dna_map)
    out = both(ref, case)
    assert out.placed == ["q"]
    assert dict(rows(out.result.alignment))["q"].replace("-", "") == \
        "MKLVINS"


# ---------------------------------- tests/test_pileup.py:147 (contigs)
def test_placement_contigs_have_real_consensus(ref):
    """--build-contigs on a placement run: spliced graphs accumulate
    pileup counts (PlacementConfig.compute_consensus), so the contig
    consensus carries real bases."""
    def case(side):
        entries = [side.FastaEntry("a", SEQS[0][1]),
                   side.FastaEntry("b", SEQS[0][1])]
        res = side.read_reference_alignment(entries, "(a:0.1,b:0.1);",
                                            data_type="dna")
        qs = [side.FastaEntry("q1", SEQS[0][1]),
              side.FastaEntry("q2", SEQS[0][1])]
        out = side.place(res, qs, "dna", side.PlacementConfig(
            compute_consensus=True, **LOOSE))
        contigs = side.pileup.reconstruct_contigs(
            out.result.tree, side.pileup.PileupConfig(
                consensus_minimum=1, consensus_minimum_proportion=0.1),
            consensus_only=True)
        return summary(out), rows(contigs)
    (placed, _d, _r), contigs = both(ref, case)
    assert len(placed) == 2
    assert contigs
    assert contigs[0][1].replace("-", "").replace("n", "")


# ------------------------------ tests/test_orfs.py:87, :111 (--find-orfs)
PROT_A = "MKLVINGGGHHEELLKKVV"
PROT_B = "MKLVINGGGHHEELLKKIV"


def orf_dna(prot):
    """DNA encoding of a protein, one codon per residue."""
    rep = P_TR._mock_codons(False)
    return "".join(rep[a] for a in prot)


@pytest.mark.parametrize("fragments", [False, True],
                         ids=["one", "fragments"])
def test_translated_placement(ref, fragments):
    """DNA queries onto a protein reference through their best ORF's
    translation (translated_query_placement_one/_all,
    reads_aligner.cpp:~2450, :1353-1436)."""
    qs = [("q1", orf_dna(PROT_A[2:15]))]
    if fragments:
        qs.append(("q2", orf_dna(PROT_A[1:16])))

    def case(side):
        res = side.read_reference_alignment(
            [side.FastaEntry(name="A", sequence=PROT_A),
             side.FastaEntry(name="B", sequence=PROT_B)],
            "(A:0.1,B:0.1);", data_type="protein")
        cfg = side.PlacementConfig(
            find_orfs=True, fragments=fragments, min_orf_length=10,
            min_query_overlap=0.2, min_query_identity=0.2, all_nodes=True,
            one_placement_only=True)
        return side.place(res, [side.FastaEntry(name=n, sequence=s)
                                for n, s in qs], "protein", cfg,
                          model_factory=side.ModelFactory("protein"))
    out = both(ref, case)
    assert sorted(out.placed) == [n + "_orf1" for n, _s in qs]
    got = dict(rows(out.result.alignment))
    assert len({len(s) for s in got.values()}) == 1


# --------------------------- tests/test_cli_io.py:157 (-q after -s/-t)
def test_progressive_with_queryfile_places_queries(ref, tmp_path, capsys):
    """-s/-t with -q: the queries are placed onto the finished
    progressive alignment (main.cpp:206-218)."""
    seqs = [("a", "ACGTACGTTGCAACGTGGTC"), ("b", "ACGTACGTTGCAACGTGGTC"),
            ("c", "ACGTACTTGCAACGTGGTC"), ("d", "ACGTACGTTGCAACGTGGTC")]
    fas = write_reads(str(tmp_path / "in.fas"), seqs)
    (tmp_path / "t.nh").write_text(
        "((a:0.1,b:0.1):0.05,(c:0.1,d:0.1):0.05);")
    q = write_reads(str(tmp_path / "q.fas"),
                    [("q0", "ACGTACGTTGCAACGTGGTC")])
    for side, name in ((PORT, "port"), (ref, "ref")):
        assert side.cli.main(side.cli_argv + [
            "-s", fas, "-t", str(tmp_path / "t.nh"), "-q", q,
            "-o", str(tmp_path / name), "--engine", "oracle",
            "--one-placement-only"]) == 0
    out = capsys.readouterr().out
    got = (tmp_path / "port.fas").read_text()
    assert got == (tmp_path / "ref.fas").read_text()
    assert out.count("placed 1 queries, 0 discarded") == 2
    by = dict(rows(P_FA.read_fasta(str(tmp_path / "port.fas"))))
    qrow = next(v for k, v in by.items() if k.startswith("q0"))
    assert qrow.replace("-", "") == "ACGTACGTTGCAACGTGGTC"


# ------------------------------ read_reference_alignment on a family
def test_refread_graphs_on_a_family(ref):
    """A 6 x 150 family of bench.py's generator (its 12-bp deletion in
    the second member), aligned by each side, read back as a reference:
    the same graphs node for node and the same rows."""
    seqs, tree = family(6, 150)

    def case(side):
        res = side.progressive([side.FastaEntry(n, s) for n, s in seqs],
                               tree, data_type="dna")
        return side.read_reference_alignment(
            [side.FastaEntry(e.name, e.sequence) for e in res.alignment],
            tree, data_type="dna")
    got, want = case(PORT), case(ref)
    same_graphs(got.tree, want.tree)
    assert rows(got.alignment) == rows(want.alignment)


# ------------------------------------------------- the port's own rules
def test_placement_defaults_to_cuda():
    """place_queries, like every entry point of the port, runs on CUDA
    unless asked for the CPU: here, with no card, it raises."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(torch.cuda, "is_available", lambda: False)
        with pytest.raises(RuntimeError, match="cuda"):
            P_PL.place_queries(reference(PORT),
                               [P_FA.FastaEntry("q", SEQS[0][1])], "dna")


@pytest.mark.parametrize("flags", [
    ["--ref-seqfile", "s.fas", "--ref-treefile", "t.nh", "-q", "q.fas"],
    ["-s", "s.fas", "-t", "t.nh", "-q", "q.fas"],
    ["-s", "s.fas", "-t", "t.nh", "-q", "q.fas", "--align-reads-at-root"]],
    ids=["ref_seqfile", "queries", "queries_at_root"])
def test_cli_placement_without_a_card_raises(tmp_path, monkeypatch, flags):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.chdir(tmp_path)
    for name in ("s.fas", "q.fas"):
        (tmp_path / name).write_text(">a\nACGTACGTTGCA\n>b\nACGTACTTGCA\n")
    (tmp_path / "t.nh").write_text("(a:0.1,b:0.1);\n")
    with pytest.raises(RuntimeError, match="cuda"):
        P_CLI.main(flags + ["-o", "out", "--silent"])
    assert not (tmp_path / "out.fas").exists()


def test_placed_graphs_hold_no_tensors():
    """Placement deep-copies the live graphs per query and candidate:
    after a run on the executor no graph of the tree holds a tensor
    that a copy would duplicate."""
    out = place_one(PORT, "ACGTACGTGGACTTACGT", both_strands=True)
    for n in out.result.tree.nodes_postorder():
        for k, v in graph_fields(n.graph).items():
            assert not isinstance(v, torch.Tensor), (n.name, k)
            if isinstance(v, list) and v:
                assert not isinstance(v[0], torch.Tensor), (n.name, k)


# ---------------- the CLIs at once: runs (a)-(d) and --full-probability
RUNNER = r"""
import json, sys
if sys.argv[1] == "ref":
    import jax
    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", False)
    from pagan2_tpu.align import (viterbi_pallas, viterbi_pallas_fanin,
                                  viterbi_pallas_banded, fullprob_pallas)
    for m in (viterbi_pallas, viterbi_pallas_fanin, viterbi_pallas_banded,
              fullprob_pallas):
        m.INTERPRET = True
    from pagan2_tpu.cli import main
else:
    from pagan2_tpu_torch.cli import main
for argv in json.loads(sys.argv[2]):
    rc = main(argv)
    print("== rc %d" % rc, flush=True)
"""

RUNS = {
    "a": ["--ref-seqfile", "family_ref.fas", "--ref-treefile", "family.nh",
          "-q", "q8.fas", "--both-strands", "--output-discarded-queries"],
    "b": ["--ref-seqfile", "family_ref.fas", "--ref-treefile", "family.nh",
          "-q", "q8.fas", "--both-strands", "--output-discarded-queries",
          "--fragments"],
    "c": ["-s", "family.fas", "-t", "family.nh", "-q", "q3.fas"],
    "d": ["--ref-seqfile", "family_ref.fas", "--ref-treefile", "family.nh",
          "-q", "r4.fas", "--align-reads-at-root"],
    "fp": ["--ref-seqfile", "four.fas", "--ref-treefile", "four.nh",
           "-q", "four_q.fas", "--full-probability"],
}


# the runs each process makes, in order: the JAX CLI's (a) and (b) share
# their traced shapes in one process, (c), (d) and the
# --full-probability run go in another; the port's CLI makes all five
GROUPS = {"port": (("a", "b", "c", "d", "fp"),),
          "ref": (("a", "b"), ("c", "d", "fp"))}


@pytest.fixture(scope="module", autouse=True)
def cli_procs(tmp_path_factory):
    """Starts the port's CLI (--device cpu) and the JAX CLI on the same
    inputs, at once, before the module's first case, so that they run
    while the cases above do; a process still running at the module's
    end is killed. The reference family_ref.fas is the port's own
    progressive alignment of the 6 x 150 family, which the JAX CLI gives
    byte for byte (tests/test_torch_progressive.py). Yields (directory,
    {(side, runs): process})."""
    d = tmp_path_factory.mktemp("placement_cli")
    seqs, tree = family(6, 150)
    write_reads(str(d / "family.fas"), seqs)
    (d / "family.nh").write_text(tree + "\n")
    # 3 new members, 4 reads of 100-128 bp (2 reverse-complemented) and
    # a random 100-bp sequence: the reads stay in one shape bucket
    q = placement_queries(150, 3, 4, 100, 128, 2, 1, 100)
    write_reads(str(d / "q8.fas"), q)
    write_reads(str(d / "q3.fas"), q[:3])
    write_reads(str(d / "r4.fas"), q[3:7])
    assert P_CLI.main(["--device", "cpu", "-s", str(d / "family.fas"),
                       "-t", str(d / "family.nh"), "--silent",
                       "-o", str(d / "family_ref")]) == 0
    write_reads(str(d / "four.fas"), rows(aligned_rows(PORT)))
    (d / "four.nh").write_text(TREE + "\n")
    write_reads(str(d / "four_q.fas"), [("q", "ACGTACGTAAAGGACTTACGT"),
                                        ("r", "ACGTATGTGGACTTACG")])
    env = dict(os.environ, PYTHONPATH=ROOT, JAX_PLATFORMS="cpu",
               JAX_ENABLE_X64="0", OMP_NUM_THREADS="1",
               PAGAN2_JAX_CACHE=str(d / "jax_cache"))
    procs = {}
    for side, groups in GROUPS.items():
        extra = ["--device", "cpu"] if side == "port" else []
        for g in groups:
            runs = [extra + RUNS[r] + ["-o", "%s_%s" % (side, r)]
                    for r in g]
            procs[side, g] = subprocess.Popen(
                [sys.executable, "-c", RUNNER, side, json.dumps(runs)],
                env=env, cwd=str(d), stdout=subprocess.PIPE,
                stderr=subprocess.PIPE, text=True)
    yield d, procs
    for p in procs.values():
        if p.poll() is None:
            p.kill()
            p.communicate()


@pytest.fixture(scope="module")
def cli_runs(cli_procs):
    """Waits for the processes of cli_procs; returns (directory, stdout
    of each run by side, the out prefix read as 'out')."""
    d, procs = cli_procs
    said = {"port": {}, "ref": {}}
    for (side, g), p in procs.items():
        out, err = p.communicate(timeout=900)
        assert p.returncode == 0, err[-3000:]
        parts = out.split("== rc 0\n")
        assert len(parts) == len(g) + 1, out[-3000:]
        for r, text in zip(g, parts):
            said[side][r] = text.replace("%s_%s" % (side, r), "out")
    return d, said


@pytest.mark.parametrize("run, outputs", [
    ("a", (".fas", ".discarded")), ("b", (".fas", ".discarded")),
    ("c", (".fas",)), ("d", (".fas",)), ("fp", (".fas",))],
    ids=["ref_both_strands", "fragments", "after_progressive",
         "reads_at_root", "full_probability"])
def test_port_cli_matches_reference_cli(cli_runs, run, outputs):
    """Every output file of each run, and its stdout (the placed and
    discarded counts, the alignment line), are the JAX CLI's."""
    d, said = cli_runs
    assert said["port"][run] == said["ref"][run]
    assert "placed" in said["port"][run]
    for suffix in outputs:
        a = (d / ("port_" + run + suffix)).read_bytes()
        assert a and a == (d / ("ref_" + run + suffix)).read_bytes(), suffix


def test_placement_discards_the_random_query(cli_runs):
    """Run (a): the random sequence is the one discarded query, and the
    reference rows keep their alignment."""
    d, said = cli_runs
    assert [e.name for e in P_FA.read_fasta(str(d / "port_a.discarded"))] \
        == ["x0"]
    assert "1 discarded" in said["port"]["a"]
    got = dict(rows(P_FA.read_fasta(str(d / "port_a.fas"))))
    ref_rows = dict(rows(P_FA.read_fasta(str(d / "family_ref.fas"))))
    assert len({len(s) for s in got.values()}) == 1
    for name, s in ref_rows.items():
        assert got[name].replace("-", "") == s.replace("-", "")
