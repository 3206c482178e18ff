"""Pair-end reads (`--pair-end`) in the port. The JAX package fills a
pair-end linear pair on its scan core (viterbi_sheared.sheared_fill,
kept off its Pallas kernel: viterbi_sheared.py:450-455), so kernel A's
pair-end rule, held here on its plain version, is that core's: the
j-side break column, and M's candidates compared after the match score
is added. Then the port's versions of tests/test_pairend.py's cases,
the executor's routing, and the CLI against the JAX CLI (interpret
mode, f32) with --pileup --pair-end, alone and with --full-probability.
Everything runs on the CPU."""
import os
from dataclasses import replace

import numpy as np
import pytest

from pagan2_tpu_torch.align import AlignSettings, PairAligner, align_pair
from pagan2_tpu_torch.align import viterbi_linear as tl
from pagan2_tpu_torch.align.oracle import mark_no_gap_penalty_sites
from pagan2_tpu_torch.align.parity import inputs_from_reference
from pagan2_tpu_torch.align.viterbi_sheared import prepare_sheared
from pagan2_tpu_torch.graph import build_leaf_graph
from pagan2_tpu_torch.graph.sequence_graph import BREAK_START_SITE
from pagan2_tpu_torch.models import ModelFactory, alphabets as alph
from pagan2_tpu_torch.tools.reads import (amplicon_reads, pair_end_reads,
                                          write_reads)

from test_torch_pileup import run_both

MODEL = ModelFactory(alph.DNA).alignment_model(0.3)


def _pe_graph(read1, read2, **kw):
    """A '0'-joined FASTQ pair: the site before the '0' is BREAK_START,
    the one after BREAK_STOP."""
    seq = read1 + "0" + read2
    return build_leaf_graph(seq, alph.DNA, quality="I" * len(seq), **kw)


@pytest.mark.parametrize("brk", ["0", "1", "mid", "R-1", "none"])
def test_linear_plain_pair_end_matches_scan_core(brk):
    """The JAX package's scan core against kernel A's plain version on
    the same f32 prep of a pair-end pair of homopolymer-rich reads (many
    tied paths), the j-side break at column 0, 1, mid, R - 1 or none
    and the i-side break at a third of the rows: corner scores
    bit-equal and every code the scan core defines equal (it marks the
    cells it leaves at -inf with no code)."""
    from pagan2_tpu.align import viterbi_sheared as VS
    from pagan2_tpu.align import AlignSettings as JaxSettings
    from pagan2_tpu.graph import build_leaf_graph as jax_leaf
    (_n1, s1), (_n2, s2) = amplicon_reads(2, 150, 170, seed=11)
    g1, g2 = jax_leaf(s1, alph.DNA), jax_leaf(s2, alph.DNA)
    L, R = g1.num_sites() - 1, g2.num_sites() - 1
    y = {"0": 0, "1": 1, "mid": R // 2, "R-1": R - 1, "none": -1}[brk]
    s = replace(JaxSettings(), pair_end_reads=True, x_read1_length=L // 3,
                y_read1_length=y).for_reads()
    inp = VS.prepare_sheared(g1, g2, MODEL, s, np.float32)
    args = VS.shear_device_inputs(inp, Lp=VS._bucket(L), Rp=VS._bucket(R))
    bp, final = VS.sheared_fill(*args)
    ref = np.asarray(bp).astype(np.int64) & 63

    # the port's prep of the same pair is the reference's, plus its kind
    mine = prepare_sheared(build_leaf_graph(s1, alph.DNA),
                           build_leaf_graph(s2, alph.DNA), MODEL,
                           replace(AlignSettings(), pair_end_reads=True,
                                   x_read1_length=L // 3,
                                   y_read1_length=y).for_reads(),
                           np.float32)
    for key in ("ms", "gext_j", "gext_i", "open_l", "open_r_shifted", "lw",
                "rw"):
        assert np.array_equal(mine[key], inp[key]), key
    assert (mine["pair_end"], mine["jbrk"]) == (True, y)
    kw = inputs_from_reference([dict(inp, pair_end=True, jbrk=y)])
    assert kw["pair_end"]
    codes, corner = tl.linear_fill_plain(**kw)
    assert np.array_equal(corner[0].numpy().view(np.uint32),
                          np.asarray(final, np.float32).view(np.uint32))
    codes = codes[0].numpy().astype(np.int64)
    d = np.arange(1, L + R - 1)[:, None]
    i = np.arange(L)[None, :]
    cell = (d - i >= 0) & (d - i < R)
    dd, ii = np.nonzero(cell)
    dd = dd + 1
    n = 0
    for sh in (0, 2, 4):
        a = (ref[dd, ii] >> sh) & 3
        b = (codes[dd, ii] >> sh) & 3
        defined = a != 3
        assert np.array_equal(a[defined], b[defined]), sh
        n += int(defined.sum())
    assert n > L * R


def test_scalar_form_refuses_other_j_side_differences():
    """Kernel A rebuilds the j-side penalties from scalars: a pair-end
    prep whose break is not named (the reference's dict has no "jbrk")
    raises, and so does a break on a job that is not pair-end."""
    g1 = build_leaf_graph("ACGTTGCAAGGCTTACGATCGA", alph.DNA)
    g2 = build_leaf_graph("ACGTTGCAGGCTTACGTTCGA", alph.DNA)
    s = replace(AlignSettings(), pair_end_reads=True, y_read1_length=7)
    inp = prepare_sheared(g1, g2, MODEL, s, np.float32)
    tl._add_scalar_params(dict(inp))
    with pytest.raises(ValueError, match="scalar form"):
        tl._add_scalar_params(dict(inp, jbrk=-1))
    with pytest.raises(ValueError, match="non-pair-end"):
        tl._add_scalar_params(dict(inp, pair_end=False))


def _ref_and_reads(seed, n1, n2, nmid):
    rng = np.random.default_rng(seed)
    r1 = "".join(rng.choice(list("ACGT"), n1))
    r2 = "".join(rng.choice(list("ACGT"), n2))
    return r1 + "".join(rng.choice(list("ACGT"), nmid)) + r2, r1, r2


def test_device_path_matches_oracle_pair_end():
    """Kernel A's pair-end fill (plain version) gives the host oracle's
    path with the pair-break penalties active."""
    ref, r1, r2 = _ref_and_reads(0, 20, 20, 30)
    s = replace(AlignSettings(), pair_end_reads=True)
    a = PairAligner(build_leaf_graph(ref, alph.DNA), _pe_graph(r1, r2),
                    MODEL, s)
    opath, oend = a.align()
    assert a.y_read1_length == 20
    gl, gr = build_leaf_graph(ref, alph.DNA), _pe_graph(r1, r2)
    sd = replace(s, x_read1_length=mark_no_gap_penalty_sites(gl),
                 y_read1_length=mark_no_gap_penalty_sites(gr))
    dpath, dend = tl.linear_align_path(gl, gr, MODEL, sd, device="cpu")
    assert [(p.mp.matrix, p.mp.x_ind, p.mp.y_ind) for p in opath] == \
        [(p.mp.matrix, p.mp.x_ind, p.mp.y_ind) for p in dpath]
    assert dend.score == pytest.approx(oend.score, rel=1e-6)


def test_fanin_matches_oracle_pair_end():
    """454-mode pair-end reads are fan-in graphs: align_pair fills them on
    kernel B's plain version, never on the oracle, with the oracle's
    score, states and site types."""
    import unittest.mock as mock
    import pagan2_tpu_torch.align as al
    from pagan2_tpu_torch.align.viterbi_sheared import is_linear_chain
    rng = np.random.default_rng(5)
    r1 = "".join(rng.choice(list("ACGT"), 16)) + "AAAA"
    r2 = "TTTT" + "".join(rng.choice(list("ACGT"), 16))
    ref = r1 + "".join(rng.choice(list("ACGT"), 24)) + r2

    def rebuild():
        return (build_leaf_graph(ref, alph.DNA, mode454=True),
                _pe_graph(r1, r2, mode454=True))
    s = replace(AlignSettings(), pair_end_reads=True)
    l0, r0 = rebuild()
    assert not (is_linear_chain(l0) and is_linear_chain(r0))
    anc_o, end_o = align_pair(*rebuild(), MODEL, s, engine="oracle",
                              device="cpu")
    called = {}
    orig = al.PairAligner.align

    def spy(self):
        called["oracle"] = True
        return orig(self)
    with mock.patch.object(al.PairAligner, "align", spy):
        anc_d, end_d = align_pair(*rebuild(), MODEL, s, device="cpu")
    assert "oracle" not in called
    assert end_d.score == pytest.approx(end_o.score, rel=1e-6)
    n = anc_d.num_sites()
    assert n == anc_o.num_sites()
    assert [int(x) for x in anc_d.states[:n]] == \
        [int(x) for x in anc_o.states[:n]]
    assert list(anc_d.site_type[:n]) == list(anc_o.site_type[:n])


def test_align_pair_end_marks_ancestor_and_strips_once():
    """The site over the read1 boundary maps to one ancestor site (marked
    BREAK_START at creation, unless the boundary edge split consumed
    the mark); the inputs were stripped in place, so a second strip
    finds no boundary and changes no site."""
    ref, r1, r2 = _ref_and_reads(2, 18, 18, 25)
    gl, gr = build_leaf_graph(ref, alph.DNA), _pe_graph(r1, r2)
    s = replace(AlignSettings(), pair_end_reads=True)
    anc, _end = align_pair(gl, gr, MODEL, s, is_reads_sequence=True,
                           device="cpu")
    assert anc is not None and anc.check_valid_graph()
    bidx = [i for i in range(anc.num_sites()) if anc.child_r[i] == 18]
    assert len(bidx) == 1
    types = list(gr.site_type[:gr.num_sites()])
    assert BREAK_START_SITE not in types
    assert mark_no_gap_penalty_sites(gr) == -1
    assert list(gr.site_type[:gr.num_sites()]) == types


def test_device_and_oracle_agree_through_align_pair():
    ref, r1, r2 = _ref_and_reads(3, 12, 12, 20)

    def run(engine):
        s = replace(AlignSettings(), pair_end_reads=True)
        return align_pair(build_leaf_graph(ref, alph.DNA),
                          _pe_graph(r1, r2), MODEL, s, engine=engine,
                          device="cpu")[0]
    a1, a2 = run("auto"), run("oracle")
    n = a1.num_sites()
    assert n == a2.num_sites()
    assert [a1.states[i] for i in range(n)] == \
        [a2.states[i] for i in range(n)]
    assert [a1.site_type[i] for i in range(n)] == \
        [a2.site_type[i] for i in range(n)]
    assert len(a1.edges) == len(a2.edges)


@pytest.mark.parametrize("full", [False, True], ids=["viterbi", "fullprob"])
def test_executor_runs_pair_end_jobs_single(full):
    """execute_pair_jobs no longer raises on pair-end jobs: it runs each
    one through align_pair (routing "single"), Viterbi and full
    probability alike, with align_pair's ancestors."""
    from pagan2_tpu_torch.parallel import executor as EX
    jobs, want = [], []
    for seed in (4, 6):
        ref, r1, r2 = _ref_and_reads(seed, 14, 14, 16)
        s = replace(AlignSettings(), pair_end_reads=True,
                    compute_full_score=full)

        def job():
            return EX.PairJob(left=build_leaf_graph(ref, alph.DNA),
                              right=_pe_graph(r1, r2), model=MODEL,
                              settings=s, is_reads_sequence=True)
        j = job()
        assert EX._plan_job(j) == "single"
        jobs.append(j)
        w = job()
        want.append(align_pair(w.left, w.right, MODEL, s,
                               is_reads_sequence=True, device="cpu")[0])
    EX.reset_stats()
    got = EX.execute_pair_jobs(jobs, device="cpu")
    assert EX.EXEC_STATS["single_jobs"] == 2
    for (anc, _end), w in zip(got, want):
        n = anc.num_sites()
        assert n == w.num_sites()
        assert list(anc.states[:n]) == list(w.states[:n])
        assert list(anc.site_type[:n]) == list(w.site_type[:n])


@pytest.mark.parametrize("extra", [[], ["--full-probability"]],
                         ids=["viterbi", "fullprob"])
def test_port_pair_end_cli_matches_reference_cli(tmp_path, extra):
    """--pileup --pair-end on 6 pair-end FASTQ reads of 2 x 40 bp (the
    amplicon generator's 100-bp reads, a 20-bp insert cut out of each):
    the JAX CLI's bytes, alone and with --full-probability."""
    reads = write_reads(str(tmp_path / "reads.fastq"), pair_end_reads(
        amplicon_reads(6, 100, 120), 20, 20))
    assert os.path.getsize(reads) > 0
    run_both(tmp_path, reads, ["--pair-end"] + extra, [".fas"])


def test_break_reaches_kernels_b_and_c_on_the_pileup_path(monkeypatch):
    """--pileup --pair-end on reads past the 200-site anchoring gate: the
    first pair (linear, thin band) fills on kernel C with both break
    scalars at real positions, the next read on kernel B with the break
    in its positional vectors (plain versions, on the CPU)."""
    from pagan2_tpu_torch.align import viterbi_banded as VB
    from pagan2_tpu_torch.align import viterbi_fanin as VF
    from pagan2_tpu_torch.io.fasta import FastaEntry
    from pagan2_tpu_torch.pipeline.pileup import pileup_align
    banded, preps = [], []
    fill, prep = VB.banded_fill, VF.prepare_fanin

    def record_fill(**kw):
        banded.append(kw["iscal"][:4].tolist())
        return fill(**kw)

    def record_prep(*a, **kw):
        inp = prep(*a, **kw)
        preps.append(inp)
        return inp
    monkeypatch.setattr(VB, "banded_fill", record_fill)
    monkeypatch.setattr(VF, "prepare_fanin", record_prep)
    reads = [FastaEntry(name=n, sequence=s, quality=q) for n, s, q in
             pair_end_reads(amplicon_reads(3, 330, 360), 60, 60)]
    res = pileup_align(reads, "dna", settings=replace(
        AlignSettings(), pair_end_reads=True), device="cpu")
    assert res.discarded == []
    assert len(banded) == 1
    L, R, brkx, brky = banded[0]
    assert 0 < brkx < L - 1 and 0 < brky < R - 1
    assert preps and all(p["pair_end"] for p in preps)
    gbrk = np.float32(MODEL.log_gap_break_ext())
    assert all(np.isin(gbrk, p["gext_j"]) for p in preps)
