"""Kernels D and E of the port (align/fullprob_fill.py) on the CPU, where
their wrappers take the plain PyTorch versions: against the JAX
package's Pallas kernels in interpret mode (linear pairs), against its
gather and one-hot scan cores (fan-in pairs), against the port's own f64
host oracle cell by cell, against closed forms, and the seeded sampler
against the reference's.

Tolerances (f32 on both sides; XLA's CPU log and its freedom to contract
a multiply and an add make 0 unlikely): planes rtol 2e-5 with atol 1e-30
(a diagonal's maximum is 1; far from the path the values fall to the
subnormal range, which XLA's CPU code flushes to zero and torch keeps),
cum 1e-5 * max(1, |cum|); against the f64 oracle rtol 1e-4 on fwd and bwd
values (one f32 rounding per diagonal accumulates in cum) and 1e-4
absolute on posteriors. Each test prints the maximum it found.
"""
from dataclasses import replace

import numpy as np
import pytest
import torch

import pagan2_tpu.align as ref_align
from pagan2_tpu.align import fullprob as rfp
from pagan2_tpu.align import fullprob_pallas as fpp
from pagan2_tpu.graph import build_leaf_graph as ref_leaf
from pagan2_tpu.models import ModelFactory as RefModelFactory

from pagan2_tpu_torch import align as port_align
from pagan2_tpu_torch.align import AlignSettings, PairAligner, align_pair
from pagan2_tpu_torch.align import fullprob as fp
from pagan2_tpu_torch.align import fullprob_fill as ff
from pagan2_tpu_torch.align.parity import inputs_from_reference
from pagan2_tpu_torch.align.sampling import merge_sampled_graph
from pagan2_tpu_torch.align.settings import X_MAT, Y_MAT, M_MAT
from pagan2_tpu_torch.graph import build_leaf_graph
from pagan2_tpu_torch.models import ModelFactory, alphabets as alph

MODEL = ModelFactory(alph.DNA).alignment_model(0.2)
REF_MODEL = RefModelFactory(alph.DNA).alignment_model(0.2)
FS = replace(AlignSettings(), compute_full_score=True)

PLANE_RTOL = 2e-5
PLANE_ATOL = 1e-30
CUM_RTOL = 1e-5


def _seqs(seed, n, cut=3, sub=0.1):
    rng = np.random.default_rng(seed)
    base = rng.choice(list("ACGT"), size=n)
    mut = base.copy()
    idx = rng.random(n) < sub
    mut[idx] = rng.choice(list("ACGT"), size=int(idx.sum()))
    return "".join(base), "".join(mut[cut:])


def _fanin_seqs(seed, n=30):
    """The 454/homopolymer generator of the reference's fan-in tests."""
    rng = np.random.default_rng(seed)
    base = rng.choice(list("AACCGGTT"), size=n)
    base[5:9] = "A"
    base[n // 2:n // 2 + 4] = "T"
    mut = base.copy()
    idx = rng.random(n) < 0.15
    mut[idx] = rng.choice(list("ACGT"), size=int(idx.sum()))
    return "".join(base), "".join(mut)


def _ancestor_pair(leaf, align, model, n, gap, seed=4):
    """An ancestor graph carrying the skip edge of a `gap`-bp deletion,
    against a leaf: the shape of every job after a family's first
    generation. gap 12 gives offsets of 13, past the one-hot caps."""
    rng = np.random.default_rng(seed)
    s1 = "".join(rng.choice(list("ACGT"), size=n))
    s2 = s1[: n // 3] + s1[n // 3 + gap:]
    anc = align(leaf(s1, alph.DNA), leaf(s2, alph.DNA), model)
    return anc, leaf(s1, alph.DNA)


def _ref_align(g1, g2, model):
    return ref_align.align_pair(g1, g2, model, ref_align.AlignSettings())[0]


def _port_align(g1, g2, model):
    return align_pair(g1, g2, model, AlignSettings(), device="cpu")[0]


def _close(name, got, want, rtol):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    err = np.abs(got - want)
    big = np.abs(want) > 1e3 * PLANE_ATOL
    worst = float((err[big] / np.abs(want[big])).max()) if big.any() else 0.0
    print("%s: max |err| %.3g, max relative %.3g" % (name, err.max(), worst))
    np.testing.assert_allclose(got, want, rtol=rtol, atol=PLANE_ATOL,
                               err_msg=name)


def _cum_close(name, got, want):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    err = float(np.abs(got - want).max())
    print("%s: max |err| %.3g of max |cum| %.3g" % (name, err,
                                                    np.abs(want).max()))
    assert err <= CUM_RTOL * max(1.0, float(np.abs(want).max())), name


def _pallas_interpret(monkeypatch):
    """Run the reference's probability kernels in interpret mode. Its
    backward kernel rolls lanes by -1, which this JAX's pltpu.roll
    refuses (ROADMAP Queue 3); a roll by n - 1 is the same roll, so the
    test wraps the library call and leaves the kernel as it is."""
    monkeypatch.setattr(fpp, "INTERPRET", True)
    roll = fpp.pltpu.roll

    def roll_any_sign(x, shift, axis, **kw):
        return roll(x, shift % x.shape[axis], axis, **kw)
    monkeypatch.setattr(fpp.pltpu, "roll", roll_any_sign)


# ----------------------------------------------------------------------
@pytest.mark.parametrize("case", ["equal", "unequal", "ragged_batch",
                                  "few_hundred"])
def test_linear_plain_matches_pallas_interpret(case, monkeypatch):
    """fullprob_fwd_plain / fullprob_bwd_plain against
    fullprob_fwd_pallas / fullprob_bwd_pallas called directly (through
    linear_plane_fills a failing interpret run would quietly take the
    scan cores), f32 in, on the same numpy inputs."""
    sizes = {"equal": [(40, 0)], "unequal": [(57, 21)],
             "ragged_batch": [(33, 2), (60, 9), (48, 30)],
             "few_hundred": [(300, 12)]}[case]
    pairs = [_seqs(10 + k, n, cut) for k, (n, cut) in enumerate(sizes)]
    Lp = rfp._bucket(max(len(a) for a, _b in pairs) + 1)
    Rp = rfp._bucket(max(len(b) for _a, b in pairs) + 1)
    ds = [rfp.linear_fullprob_inputs(ref_leaf(a, alph.DNA),
                                     ref_leaf(b, alph.DNA), REF_MODEL,
                                     np.float32, Lp=Lp, Rp=Rp)
          for a, b in pairs]
    _pallas_interpret(monkeypatch)
    jargs = [np.stack([d[k] for d in ds])
             for k in ("msp_sh", "wr_rext", "wl", "consts")]
    jargs += [np.array([d["L"] for d in ds], np.int32),
              np.array([d["R"] for d in ds], np.int32)]
    assert all(a.dtype in (np.float32, np.int32) for a in jargs)
    seeds = np.array([d["seed"] for d in ds], np.float32)
    rf = fpp.fullprob_fwd_pallas(*jargs)
    rb = fpp.fullprob_bwd_pallas(*jargs, seeds)
    assert rf[0].dtype == np.float32
    # the scan cores are the Pallas kernels' spec
    sb = rfp._bwd_fill_batched(*jargs, seeds)

    args = inputs_from_reference(ds, "cpu")
    planes, cum = ff.fullprob_fwd(**args)
    bplanes, bcum = ff.fullprob_bwd(**args)
    assert planes.shape == (len(ds), 3) + ds[0]["msp_sh"].shape
    for k, name in enumerate("MXY"):
        _close("f" + name, planes[:, k].numpy(), rf[k], PLANE_RTOL)
        _close("b" + name, bplanes[:, k].numpy(), rb[k], PLANE_RTOL)
        _close("scan b" + name, bplanes[:, k].numpy(), sb[k], PLANE_RTOL)
    _cum_close("fcum", cum.numpy(), rf[3])
    _cum_close("bcum", bcum.numpy(), rb[3])
    # rows above each job's corner: planes 0, backward cum exactly 0
    for b, d in enumerate(ds):
        top = d["L"] + d["R"] - 1
        assert not bplanes[b, :, top:].any() and not bcum[b, top:].any()
        assert not planes[b, :, top:].any()


def _ref_fanin_graphs(case):
    if case == "454":
        a, b = _fanin_seqs(1)
        return (ref_leaf(a, alph.DNA, mode454=True),
                ref_leaf(b, alph.DNA, mode454=True))
    if case == "homopolymer":
        a, b = _fanin_seqs(2)
        return (ref_leaf(a, alph.DNA, homopolymer=True),
                ref_leaf(b, alph.DNA, mode454=True))
    gap = 4 if case == "ancestor_deletion" else 12
    return _ancestor_pair(ref_leaf, _ref_align, REF_MODEL, 26 + gap, gap)


@pytest.mark.parametrize("case", ["454", "homopolymer", "ancestor_deletion",
                                  "beyond_cap"])
def test_fanin_plain_matches_scan_cores(case):
    """The fan-in plain versions against the batched gather cores (any
    K, ring depth G) and, where every K and offset is within 8, against
    the one-hot cores, f32, on the reference's own numpy inputs."""
    g1, g2 = _ref_fanin_graphs(case)
    d = rfp.fanin_fullprob_inputs(g1, g2, REF_MODEL, np.float32)
    capped = max(d["OLm"], d["ORm"], d["KL"], d["KR"]) <= 8
    assert capped == (case != "beyond_cap")
    G = d["OLm"] + d["ORm"]
    F = max(8, d["ORm"])
    roff, rw = rfp.fanin_rext(d["roffp"], d["rwp"], d["Lp"], d["Rp"], F)
    rfoff, rfw = rfp.fanin_rext(d["rfoff"], d["rfw"], d["Lp"], d["Rp"], F)
    L, R = np.int32(d["L"]), np.int32(d["R"])
    fwd, bwd = rfp.fanin_gather_fills_batched(d["KL"], d["KR"], d["KFL"],
                                              d["KFR"], G)
    one = lambda a: np.asarray(a)[None]             # noqa: E731
    rf = fwd(one(d["msp_sh"]), one(d["loffp"]), one(d["lwp"]), one(roff),
             one(rw), one(d["consts"]), one(L), one(R))
    rb = bwd(one(d["msp_sh"]), one(d["lfoff"]), one(d["lfw"]), one(rfoff),
             one(rfw), one(d["consts"]), one(L), one(R),
             one(d["seed_block"]))
    assert rf[0].dtype == np.float32

    fkw, bkw = inputs_from_reference(d, "cpu")
    planes, cum = ff.fullprob_fwd_fanin(**fkw)
    bplanes, bcum = ff.fullprob_bwd_fanin(**bkw)
    for k, name in enumerate("MXY"):
        _close("gather f" + name, planes[0, k].numpy(), rf[k][0],
               PLANE_RTOL)
        _close("gather b" + name, bplanes[0, k].numpy(), rb[k][0],
               PLANE_RTOL)
    _cum_close("gather fcum", cum[0].numpy(), rf[3][0])
    _cum_close("gather bcum", bcum[0].numpy(), rb[3][0])
    if capped:
        f1, b1 = rfp._fanin_fills(d["KL"], d["KR"], d["OLm"], d["ORm"])
        a = (d["msp_sh"], d["loffp"], d["lwp"], roff, rw, d["consts"], L, R)
        of = f1(*a)
        ob = b1(*a, d["seed_block"])
        for k, name in enumerate("MXY"):
            _close("one-hot f" + name, planes[0, k].numpy(), of[k],
                   PLANE_RTOL)
            _close("one-hot b" + name, bplanes[0, k].numpy(), ob[k],
                   PLANE_RTOL)
        _cum_close("one-hot fcum", cum[0].numpy(), of[3])
        _cum_close("one-hot bcum", bcum[0].numpy(), ob[3])


# ----------------------------------------------------------------------
def _port_graphs(case):
    if case == "linear":
        a, b = _seqs(21, 36, 0)
        return build_leaf_graph(a, alph.DNA), build_leaf_graph(b, alph.DNA)
    if case == "linear_unequal":
        a, b = _seqs(22, 41, 14, sub=0.2)
        return build_leaf_graph(a, alph.DNA), build_leaf_graph(b, alph.DNA)
    if case == "454":
        a, b = _fanin_seqs(3)
        return (build_leaf_graph(a, alph.DNA, mode454=True),
                build_leaf_graph(b, alph.DNA, mode454=True))
    if case == "homopolymer":
        a, b = _fanin_seqs(4)
        return (build_leaf_graph(a, alph.DNA, homopolymer=True),
                build_leaf_graph(b, alph.DNA, mode454=True))
    gap = 4 if case == "ancestor_deletion" else 12
    return _ancestor_pair(build_leaf_graph, _port_align, MODEL, 26 + gap,
                          gap)


@pytest.mark.parametrize("case", ["linear", "linear_unequal", "454",
                                  "homopolymer", "ancestor_deletion",
                                  "beyond_cap"])
def test_planes_match_host_oracle(case):
    """fwd, bwd and posterior of every cell against the port's f64 host
    oracle; the forward and the backward total agree."""
    g1, g2 = _port_graphs(case)
    planes = fp.FullProbPlanes(g1, g2, MODEL, FS, device="cpu")
    assert planes.fanin == (not case.startswith("linear"))
    orc = PairAligner(g1, g2, MODEL, FS)
    end = orc.fill()
    assert planes.total_fwd_score() == pytest.approx(end.fwd_score,
                                                     rel=1e-4)
    worst = {"fwd": 0.0, "bwd": 0.0, "posterior": 0.0}
    for mk, om in ((M_MAT, orc.M), (X_MAT, orc.X), (Y_MAT, orc.Y)):
        for i in range(planes.L):
            for j in range(planes.R):
                c = om[i][j]
                for key, got, want in (
                        ("fwd", planes.fwd(mk, i, j), c.fwd_score),
                        ("bwd", planes.bwd(mk, i, j), c.bwd_score)):
                    assert got == pytest.approx(want, rel=1e-4, abs=1e-300)
                    if want > 0:
                        worst[key] = max(worst[key], abs(got / want - 1))
                post = planes.posterior(mk, i, j)
                assert post == pytest.approx(c.full_score, abs=1e-4)
                worst["posterior"] = max(worst["posterior"],
                                         abs(post - c.full_score))
    print("against the oracle:", worst)
    # the backward total lacks the end-gap-close paths: within 1%
    assert abs(planes.log_total - planes.log_total_bwd) < np.log(1.01)


def _constants():
    a = alph.get_alphabet(alph.DNA)
    m = MODEL
    return (m.non_gap(), m.gap_close(), m.gap_open(),
            float(m.score[a.state_of("A"), a.state_of("A")]),
            float(m.score[a.state_of("C"), a.state_of("C")]))


def test_single_site_pair_closed_form():
    """'A' vs 'A': every fwd and bwd cell written out by hand."""
    planes = fp.FullProbPlanes(build_leaf_graph("A", alph.DNA),
                               build_leaf_graph("A", alph.DNA), MODEL, FS,
                               device="cpu")
    ng, gc, go, ms, _msC = _constants()
    ap = lambda v: pytest.approx(v, rel=1e-5)       # noqa: E731
    assert planes.fwd(M_MAT, 0, 0) == ap(1.0)
    assert planes.fwd(X_MAT, 1, 0) == ap(ng * go)
    assert planes.fwd(Y_MAT, 0, 1) == ap(ng * go)
    assert planes.fwd(M_MAT, 1, 1) == ap(ms * ng * ng)
    assert planes.fwd(Y_MAT, 1, 1) == ap(gc * go * ng * go)
    assert planes.fwd(X_MAT, 1, 1) == ap(gc * go * ng * go)
    total = ng * ms * ng * ng + 2 * gc * gc * go * ng * go
    assert planes.total_fwd_score() == ap(total)
    assert planes.bwd(M_MAT, 1, 1) == ap(ng)
    assert planes.bwd(X_MAT, 1, 1) == 0.0
    assert planes.bwd(Y_MAT, 1, 1) == 0.0
    assert planes.bwd(M_MAT, 0, 0) == ap(ng ** 3 * ms)
    assert planes.bwd(X_MAT, 0, 0) == ap(gc * ng * ng * ms)
    assert planes.bwd(Y_MAT, 0, 0) == ap(gc * ng * ng * ms)
    assert planes.posterior(M_MAT, 1, 1) == ap(ms * ng * ng * ng / total)


def test_two_site_identity_pair_closed_form():
    """'AC' vs 'AC': the match chain compounds cell by cell."""
    planes = fp.FullProbPlanes(build_leaf_graph("AC", alph.DNA),
                               build_leaf_graph("AC", alph.DNA), MODEL, FS,
                               device="cpu")
    ng, gc, go, msA, msC = _constants()
    ap = lambda v: pytest.approx(v, rel=1e-5)       # noqa: E731
    fM11 = msA * ng * ng
    fX11 = fY11 = gc * go * ng * go
    assert planes.fwd(M_MAT, 1, 1) == ap(fM11)
    assert planes.fwd(M_MAT, 2, 2) == ap(
        msC * (ng * ng * fM11 + gc * ng * (fX11 + fY11)))
    assert planes.bwd(M_MAT, 2, 2) == ap(ng)
    assert planes.bwd(X_MAT, 2, 1) == 0.0
    assert planes.bwd(M_MAT, 1, 1) == ap(ng ** 3 * msC)
    assert planes.bwd(X_MAT, 1, 1) == ap(gc * ng * ng * msC)


def test_fanin_corner_seed_covers_stop_edge_pairs():
    """A left graph whose stop site has TWO bwd edges (the chain from
    site 2 and a bridge from site 1): the corner seeding places
    ng * w_bridge at cell (1, R-1) on its own diagonal, and the forward
    total counts both stop-edge pairs."""
    g1 = build_leaf_graph("AC", alph.DNA)
    wb = 0.25
    g1.add_edge(1, 3, wb)
    planes = fp.FullProbPlanes(g1, build_leaf_graph("A", alph.DNA), MODEL,
                               FS, device="cpu")
    assert planes.fanin
    ng, _gc, _go, ms, _msC = _constants()
    ap = lambda v: pytest.approx(v, rel=1e-5)       # noqa: E731
    assert planes.bwd(M_MAT, 2, 1) == ap(ng)
    assert planes.bwd(M_MAT, 1, 1) == ap(ng * wb)
    assert planes.fwd(M_MAT, 1, 1) == ap(ms * ng * ng)
    chain = fp.FullProbPlanes(build_leaf_graph("AC", alph.DNA),
                              build_leaf_graph("A", alph.DNA), MODEL, FS,
                              device="cpu")
    assert planes.total_fwd_score() > chain.total_fwd_score()


# ----------------------------------------------------------------------
def _steps(path):
    return [(p.mp.matrix, p.mp.x_ind, p.mp.y_ind) for p in path]


@pytest.mark.parametrize("case", ["linear", "fanin"])
def test_sampled_path_equals_reference(case, monkeypatch):
    """With the same np.random.default_rng(seed), the port's sampler
    walks the reference's path over its own f32 planes."""
    if case == "linear":
        a, b = _seqs(31, 60, 5)
        kw1 = kw2 = {}
    else:
        a, b = _fanin_seqs(6, 40)
        kw1, kw2 = {"homopolymer": True}, {"mode454": True}
    _pallas_interpret(monkeypatch)
    ref_planes = rfp.FullProbPlanes(
        ref_leaf(a, alph.DNA, **kw1), ref_leaf(b, alph.DNA, **kw2),
        REF_MODEL, ref_align.AlignSettings(), dtype=np.float32)
    planes = fp.FullProbPlanes(
        build_leaf_graph(a, alph.DNA, **kw1),
        build_leaf_graph(b, alph.DNA, **kw2), MODEL, FS, device="cpu")
    assert ref_planes.f[0].dtype == np.float32
    for seed in (7, 8, 9):
        want, wend = rfp.sample_path_planes(
            ref_planes, ref_align.AlignSettings(),
            np.random.default_rng(seed))
        got, gend = fp.sample_path_planes(planes, FS,
                                          np.random.default_rng(seed))
        assert _steps(got) == _steps(want)
        assert (gend.matrix, gend.x_ind, gend.y_ind) == \
            (wend.matrix, wend.x_ind, wend.y_ind)
    # different seeds do part: the draws are not degenerate
    paths = {tuple(_steps(fp.sample_path_planes(
        planes, FS, np.random.default_rng(s))[0])) for s in range(12)}
    assert len(paths) > 1


# a 60 bp homopolymer fan-in pair on which the reference's own forward
# and backward totals part by 3.1e-3 nats, in f64 too: past the 1e-3
# that chip_smoke.py's kernel_fullprob phase holds its oracle pairs to,
# inside the reference's 1% agreement window (ROADMAP Queue 3)
TOTALS_PART_PAIR = (
    "AAGATAATTCCGAGAAACGGCGAACGAGCCTCATGGCGATGTTACGTCTAATGGTGGACC",
    "TAATTCCGAGCAACGGCGAACGAGCCTCATGGCGTTGTTAAGTCTAATTGTGGAAC")


def test_fanin_totals_part_as_the_reference_does(monkeypatch):
    """On TOTALS_PART_PAIR the port's |log fwd - log bwd| is the JAX
    package's in f32 (within 1e-5), and both, and the reference's f64,
    exceed 1e-3: the gap is the reference's, not kernels D and E's."""
    a, b = TOTALS_PART_PAIR
    _pallas_interpret(monkeypatch)
    port = fp.FullProbPlanes(
        build_leaf_graph(a, alph.DNA, homopolymer=True),
        build_leaf_graph(b, alph.DNA, homopolymer=True), MODEL, FS,
        device="cpu")
    assert port.fanin
    got = abs(port.log_total - port.log_total_bwd)
    want = {}
    for dtype in (np.float32, np.float64):
        ref = rfp.FullProbPlanes(
            ref_leaf(a, alph.DNA, homopolymer=True),
            ref_leaf(b, alph.DNA, homopolymer=True), REF_MODEL,
            ref_align.AlignSettings(), dtype=dtype)
        want[dtype] = abs(ref.log_total - ref.log_total_bwd)
    print("|log fwd - log bwd|: port %.6g, reference f32 %.6g, f64 %.6g"
          % (got, want[np.float32], want[np.float64]))
    assert abs(got - want[np.float32]) <= 1e-5
    assert min(got, *want.values()) > 1e-3
    assert max(got, *want.values()) < np.log(1.01)


def test_merge_sampled_graph_round_trip():
    """--sample-additional-paths through align_pair: the merged graph
    holds the first path's sites and at least as many edges, and a
    seeded repeat gives the same graph."""
    a, b = _seqs(41, 50, 4, sub=0.3)

    def run(extra):
        port_align.set_sampling_seed(11)
        s = replace(AlignSettings(), sample_additional_paths=extra)
        anc, _end = align_pair(build_leaf_graph(a, alph.DNA),
                               build_leaf_graph(b, alph.DNA), MODEL, s,
                               device="cpu")
        return anc
    try:
        one, merged, again = run(0), run(3), run(3)
    finally:
        port_align._RNG = None
    assert merged.num_sites() >= one.num_sites()
    assert len(merged.edges) >= len(one.edges)
    assert merged.num_sites() == again.num_sites()
    assert list(merged.edges.start) == list(again.edges.start)
    assert list(merged.edges.end) == list(again.edges.end)
    sg = align_pair(build_leaf_graph(a, alph.DNA),
                    build_leaf_graph(b, alph.DNA), MODEL, FS,
                    device="cpu")[0]
    n0 = len(sg.edges)
    merge_sampled_graph(sg, sg)
    assert len(sg.edges) == n0      # merging a graph into itself adds none


@pytest.mark.parametrize("case", ["linear", "homopolymer", "beyond_cap"])
def test_full_score_never_fills_the_host_oracle(case, monkeypatch):
    """align_pair with compute_full_score takes the plane fills for every
    pair over 4 sites, whatever its fan-in; PairAligner.fill is only for
    engine='oracle' and pairs of empty sequences."""
    g1, g2 = _port_graphs(case)

    def boom(self):
        raise AssertionError("PairAligner.fill called")
    monkeypatch.setattr(PairAligner, "fill", boom)
    n0 = dict(ff.PLAIN_CALLS)
    anc, end = align_pair(g1, g2, MODEL, FS, device="cpu")
    key = "fullprob_fwd" + ("" if case == "linear" else "_fanin")
    assert ff.PLAIN_CALLS[key] == n0[key] + 1
    assert not any(ff.LAUNCHES.values())
    sup = np.asarray(anc.posterior_support[1:anc.num_sites() - 1])
    assert sup.min() > 0 and sup.max() <= 1 + 1e-4
    assert end.full_score == 1.0


def test_wrappers_check_their_arguments():
    a, b = _seqs(51, 30, 2)
    inp = fp.linear_fullprob_inputs(build_leaf_graph(a, alph.DNA),
                                    build_leaf_graph(b, alph.DNA), MODEL)
    args = ff.linear_batch_args([inp], "cpu")
    with pytest.raises(TypeError, match="ms2"):
        ff.fullprob_fwd(**dict(args, ms2=args["ms2"].double()))
    with pytest.raises(ValueError, match="iscal"):
        ff.fullprob_bwd(**dict(args, iscal=args["iscal"][:, :1]
                               .contiguous()))
    g1, g2 = _port_graphs("homopolymer")
    fkw, bkw = ff.fanin_batch_args(
        [fp.fanin_fullprob_inputs(g1, g2, MODEL)], "cpu")
    with pytest.raises(TypeError, match="loff"):
        ff.fullprob_fwd_fanin(**dict(fkw, loff=fkw["loff"].long()))
    with pytest.raises(ValueError, match="seed"):
        ff.fullprob_bwd_fanin(**dict(bkw, seed=bkw["seed"][:, :, :-1]
                                     .contiguous()))
    planes, cum = ff.fullprob_fwd_fanin(**fkw)
    assert planes.dtype == torch.float32 and planes.shape[1] == 3
    assert cum.shape == planes.shape[:1] + planes.shape[2:3]


# ----------------------------------------------------------------------
# kernel E's launch plans (plain Python; the kernel refuses any other)
@pytest.mark.parametrize("key, want", [
    # the --full-probability run's fan-in calls: 16 x 1535 ancestors
    ((1536, 26, 2, 2, 1536), (2, 2, 2, 768, "hot", 11, True)),
    ((768, 14, 2, 2, 768), (2, 2, 2, 384, "shared", 15, True)),
    ((1536, 26, 3, 3, 1536), (0, 0, 0, 1024, "hot", 10, True)),
    ((768, 26, 3, 3, 768), (3, 3, 2, 384, "hot", 23, True)),
    ((2048, 26, 3, 3, 2048), (0, 0, 0, 1024, "hot", 7, True)),
    # a 6 x 2000 family's ancestors and 454 pairs of 2047 bp
    ((2016, 26, 2, 2, 2001), (2, 2, 4, 512, "hot", 8, True)),
    ((2016, 14, 1, 2, 2001), (1, 2, 4, 512, "hot", 8, True)),
    ((2048, 6, 2, 2, 2048), (2, 2, 4, 512, "shared", 7, True)),
    ((96, 8, 6, 2, 80), (0, 0, 2, 64, "shared", 9, True)),
    ((2528, 2, 1, 1, 41), (0, 0, 0, 1024, "shared", 3, True)),
    ((6624, 3, 2, 1, 31), (0, 0, 0, 1024, "global", 0, True)),
    ((64, 4, 2, 2, 15001), (2, 2, 2, 32, "shared", 5, False))])
def test_bwd_fanin_plan(key, want):
    p = ff.bwd_fanin_plan(*key)
    assert (p["KL"], p["KR"], p["rows"], p["threads"], p["placement"],
            p["hot"], p["rtab"]) == want
    Lp, G, KL, KR, Rr = key
    assert p["smem"] == 4 * (64 + G + 1) + 8 * KR * Rr * p["rtab"] \
        + 12 * Lp * p["hot"] <= ff.SHARED_BYTES


def _check_fanin_plan_limits(planner, K, cell):
    """Over a grid of lane counts, ring depths and right sides (`cell`:
    ring bytes a lane and diagonal): shared
    bytes within the H100's 227 KB; the right-slot table on chip exactly
    when it fits beside MIN_HOT ring diagonals (or alone, where those do
    not fit); the whole ring on chip
    exactly when it fits beside the table, else the most diagonals that
    fit (at least MIN_HOT, or none); every lane owned by one thread of a
    block of whole warps with no idle warp, within the block size of its
    build (two lanes: 768 threads, 384 for a templated fan-in past
    2 x 2; four, for a templated fan-in up to 2 x 2: 512; any: 1024)."""
    KL, KR = K
    templ = max(KL, KR) <= ff.TEMPLATE_K
    for Lp in (32, 64, 500, 1024, 1536, 1537, 2048, 2049, 4096, 6500,
               9000):
        for G in (1, 2, 6, 26, 64):
            for Rr in (8, 1536, 20000):
                p = planner(Lp, G, KL, KR, Rr)
                GR, table = G + 1, 8 * KR * Rr
                fixed = 4 * (64 + GR) + table * p["rtab"]
                assert p["smem"] == fixed + cell * Lp * p["hot"] \
                    <= ff.SHARED_BYTES
                least = cell * Lp * min(GR, ff.MIN_HOT)
                if 4 * (64 + GR) + least > ff.SHARED_BYTES:
                    least = 0
                assert p["rtab"] == (4 * (64 + GR) + table + least
                                     <= ff.SHARED_BYTES)
                fits = fixed + cell * Lp * GR <= ff.SHARED_BYTES
                assert (p["placement"] == "shared") == fits
                if fits:
                    assert p["hot"] == GR
                elif p["hot"]:
                    assert p["placement"] == "hot"
                    assert ff.MIN_HOT <= p["hot"] <= G
                    assert fixed + cell * Lp * (p["hot"] + 1) \
                        > ff.SHARED_BYTES
                else:
                    assert p["placement"] == "global"
                t, rows = p["threads"], p["rows"]
                two = 768 if not templ or max(KL, KR) <= 2 else 384
                cap = {2: two, 4: 512, 0: 1024}[rows]
                four = templ and max(KL, KR) <= 2 and Lp <= 2048
                assert rows == (2 if Lp <= 2 * two else 4 if four else 0)
                assert t % 32 == 0 and 32 <= t <= cap
                if rows:
                    assert (p["KL"], p["KR"]) == ((KL, KR) if templ
                                                  else (0, 0))
                    assert t * rows >= Lp > (t - 32) * rows
                else:
                    assert (p["KL"], p["KR"]) == (0, 0)
                    assert t == min(1024, -(-Lp // 32) * 32)


@pytest.mark.parametrize("K", [(1, 1), (2, 2), (3, 1), (4, 4), (6, 3)])
def test_bwd_fanin_plan_limits(K):
    """Kernel E's fan-in plans keep the limits of _check_fanin_plan_limits
    (K: its forward-edge fan-in; its ring holds q, X and Y, 12 bytes a
    lane and diagonal)."""
    _check_fanin_plan_limits(ff.bwd_fanin_plan, K, 12)


@pytest.mark.parametrize("Lp, want", [
    (32, (1, 32, 0)), (512, (1, 512, 0)), (513, (2, 288, 0)),
    (1536, (2, 768, 0)), (2048, (2, 1024, 0)),
    (4096, (2, 256, 8)), (4097, (2, 288, 8)),
    (20000, (2, 640, 16)), (40000, (4, 640, 16))])
def test_bwd_linear_plan(Lp, want):
    """Kernel E's linear plan: one lane a thread up to 512 lanes, two up
    to 2048 (a lane build, cluster 0); past that the cluster build
    (test_torch_fullprob_cluster.py): 8 CTAs of two lanes a thread, 16
    past 16,384 lanes, four lanes a thread past 32,768; the X and q rows
    of two diagonals, 16 bytes a lane of the block or CTA and one more,
    in shared memory."""
    p = ff.bwd_linear_plan(Lp)
    assert (p["rows"], p["threads"], p["cluster"]) == want
    lanes = p["rows"] * p["threads"] if p["cluster"] else Lp
    assert p["smem"] == 16 * (lanes + 1) <= ff.SHARED_BYTES
    assert p["threads"] * p["rows"] * max(1, p["cluster"]) >= Lp


# ----------------------------------------------------------------------
# kernel D's launch plans (plain Python; the kernel refuses any other)
@pytest.mark.parametrize("key, want", [
    # the --full-probability run's fan-in calls: 16 x 1535 ancestors,
    # backward edges K 2/2
    ((1536, 26, 2, 2, 1536), (2, 2, 2, 768, "hot", 8, True)),
    ((768, 14, 2, 2, 768), (2, 2, 2, 384, "shared", 15, True)),
    ((768, 26, 3, 3, 768), (3, 3, 2, 384, "hot", 17, True)),
    # 454 pairs of 2047 bp (backward K 3/3: runtime K, any lane count)
    # and a 6 x 2000 family's ancestors (four lanes a thread)
    ((2048, 6, 3, 3, 2048), (0, 0, 0, 1024, "hot", 5, True)),
    ((2016, 26, 2, 2, 2001), (2, 2, 4, 512, "hot", 6, True)),
    # a hot split at a deep ring, runtime K of two lanes, G = 1
    ((1100, 40, 2, 2, 60), (2, 2, 2, 576, "hot", 13, True)),
    ((96, 8, 6, 2, 80), (0, 0, 2, 64, "shared", 9, True)),
    ((3000, 1, 1, 1, 100), (0, 0, 0, 1024, "shared", 2, True)),
    # no diagonal on chip; a right-slot table too large for it
    ((6624, 3, 1, 1, 31), (0, 0, 0, 1024, "global", 0, True)),
    ((64, 4, 2, 2, 15001), (2, 2, 2, 32, "shared", 5, False))])
def test_fwd_fanin_plan(key, want):
    p = ff.fwd_fanin_plan(*key)
    assert (p["KL"], p["KR"], p["rows"], p["threads"], p["placement"],
            p["hot"], p["rtab"]) == want
    Lp, G, KL, KR, Rr = key
    assert p["smem"] == 4 * (64 + G + 1) + 8 * KR * Rr * p["rtab"] \
        + 16 * Lp * p["hot"] <= ff.SHARED_BYTES


@pytest.mark.parametrize("K", [(1, 1), (2, 2), (3, 1), (4, 4), (6, 3)])
def test_fwd_fanin_plan_limits(K):
    """Kernel D's fan-in plans keep the limits of _check_fanin_plan_limits
    (K: its backward-edge fan-in; its ring holds raw (M, X, Y, 0), 16
    bytes a lane and diagonal)."""
    _check_fanin_plan_limits(ff.fwd_fanin_plan, K, 16)


@pytest.mark.parametrize("Lp, want", [
    (32, (1, 32, 0)), (512, (2, 256, 0)), (513, (2, 288, 0)),
    (1536, (2, 768, 0)), (2048, (2, 1024, 0)),
    (4096, (2, 256, 8)), (4097, (2, 288, 8)),
    (20000, (2, 640, 16)), (128, (1, 128, 0)),
    (129, (2, 96, 0)), (16576, (2, 544, 16)), (40000, (4, 640, 16))])
def test_fwd_linear_plan(Lp, want):
    """Kernel D's linear plan: one lane a thread up to 128 lanes (E's up
    to 512), two up to 2048 (a lane build, cluster 0); past that the
    cluster build: 8 CTAs of two lanes a thread, 16 past 16,384 lanes,
    four lanes a thread past 32,768; the raw (M, X, Y, 0) rows of two
    diagonals, 32 bytes a lane of the block or CTA and one more, in
    shared memory."""
    p = ff.fwd_linear_plan(Lp)
    assert (p["rows"], p["threads"], p["cluster"]) == want
    lanes = p["rows"] * p["threads"] if p["cluster"] else Lp
    assert p["smem"] == 32 * (lanes + 1) <= ff.SHARED_BYTES
    assert p["threads"] * p["rows"] * max(1, p["cluster"]) >= Lp
