"""Kernel C's plain version (pagan2_tpu_torch.align.viterbi_banded)
against the JAX package's windowed banded Pallas kernel in interpret
mode, the stripe folds of both packages, the band plan, and the routes
of anchored linear pairs.

Inputs come from one numpy seed and go through each package's own prep
(graphs, prepare_sheared, band schedule, folded stripe). Corner scores
are bit-equal and every in-window code equals the Pallas code realigned
by `_PallasBandedCells._field` (tolerance 0: the fill only adds and
takes maxima)."""
from dataclasses import replace

import numpy as np
import pytest
import torch

from pagan2_tpu.align import AlignSettings, plan_band
from pagan2_tpu.align import viterbi_pallas_banded as vpb
from pagan2_tpu.align.oracle import mark_no_gap_penalty_sites
from pagan2_tpu.align.settings import M_MAT, X_MAT, Y_MAT
from pagan2_tpu.graph import build_leaf_graph
from pagan2_tpu.models import ModelFactory, alphabets as alph

from pagan2_tpu_torch import native as tnative
from pagan2_tpu_torch.align import AlignSettings as TAlignSettings
from pagan2_tpu_torch.align import plan_band as tplan_band
from pagan2_tpu_torch.align import viterbi_banded as tb
from pagan2_tpu_torch.align import viterbi_linear as tl
from pagan2_tpu_torch.align.oracle import \
    mark_no_gap_penalty_sites as tmark
from pagan2_tpu_torch.align.parity import inputs_from_reference
from pagan2_tpu_torch.graph import build_leaf_graph as tbuild
from pagan2_tpu_torch.models import (ModelFactory as TModelFactory,
                                     alphabets as talph)
from pagan2_tpu_torch.parallel import executor as tex

MODEL = ModelFactory(alph.DNA).alignment_model(0.2)
TMODEL = TModelFactory(talph.DNA).alignment_model(0.2)


def _related(rng, n, sub, deletion=0):
    base = rng.choice(list("ACGT"), size=n)
    mut = base.copy()
    idx = rng.random(n) < sub
    mut[idx] = rng.choice(list("ACGT"), size=int(idx.sum()))
    s2 = "".join(mut)
    if deletion:
        s2 = s2[:n // 2] + s2[n // 2 + deletion:]
    return "".join(base), s2


def _case(name):
    """(s1, s2, quality of s2, settings kw, band) of one kernel case; the
    band is None (plan it from anchors) or a function of (L, R)."""
    rng = np.random.default_rng({"narrow": 1, "wide": 2, "pair_end": 3,
                                 "dead_end": 4}[name])
    if name == "narrow":
        s1, s2 = _related(rng, 520, 0.05, deletion=12)
        return s1, s2, "", {}, None
    if name == "wide":
        # a window of more than 128 rows
        s1, s2 = _related(rng, 420, 0.1, deletion=7)
        return s1, s2, "", {}, lambda L, R: (
            np.maximum(np.arange(L) - 150, 0),
            np.minimum(np.arange(L) + 150, R - 1))
    if name == "pair_end":
        # the "0" marker splits the right side into two reads: the
        # break scalars xbrk / ybrk are set
        r1, r2, mid = (rng.choice(list("ACGT"), k) for k in (25, 25, 40))
        s1 = "".join(r1) + "".join(mid) + "".join(r2)
        s2 = "".join(r1) + "0" + "".join(r2)
        return s1, s2, "I" * len(s2), {"pair_end_reads": True}, \
            lambda L, R: (np.zeros(L, np.int64), np.full(L, R - 1))
    # dead end: a band that cannot reach the end corner
    s1 = "".join(rng.choice(list("ACGT"), 80))
    s2 = "ACGTACGTACGTACGTACGT" + s1
    return s1, s2, "", {}, lambda L, R: (np.zeros(L, np.int64),
                                         np.full(L, 3, np.int64))


def _prep(build, mark, settings_cls, s1, s2, qual, kw):
    g1 = build(s1, alph.DNA)
    g2 = build(s2, alph.DNA, quality=qual) if qual else build(s2, alph.DNA)
    s = replace(settings_cls(), **kw)
    if s.pair_end_reads:
        s = replace(s, x_read1_length=mark(g1), y_read1_length=mark(g2))
    return g1, g2, s


@pytest.mark.parametrize("name", ["narrow", "wide", "pair_end",
                                  "dead_end"])
def test_banded_plain_matches_pallas_interpret(name):
    s1, s2, qual, kw, band = _case(name)
    g1, g2, s = _prep(build_leaf_graph, mark_no_gap_penalty_sites,
                      AlignSettings, s1, s2, qual, kw)
    t1, t2, ts = _prep(tbuild, tmark, TAlignSettings, s1, s2, qual, kw)
    if band is None:
        band, _ = plan_band(g1, g2, s)
        tband, _ = tplan_band(t1, t2, ts)
        assert all(np.array_equal(a, b) for a, b in zip(band, tband))
    else:
        band = band(g1.num_sites() - 1, g2.num_sites() - 1)
    upper, lower = band

    args, meta = vpb.pallas_banded_args(g1, g2, MODEL, s, upper, lower)
    vpb.INTERPRET = True
    try:
        bpp, fM, fX, fY = vpb.pallas_banded_fill(
            args["fscal"], args["iscal"], args["sched_dev"], args["ms"])
    finally:
        vpb.INTERPRET = False
    L, R = meta["inp"]["L"], meta["inp"]["R"]
    ilo, w = meta["ilo"], meta["w"]
    tc = (L - 1) - int(ilo[L + R - 2])
    Wl = meta["Wl"]
    ref_corner = np.array([np.asarray(v)[tc // Wl, tc % Wl]
                           if 0 <= tc < meta["S"] * Wl else -np.inf
                           for v in (fM, fX, fY)], np.float32)

    targs, tmeta = tb.banded_args(t1, t2, TMODEL, ts, upper, lower, "cpu")
    assert np.array_equal(tmeta["ilo"], ilo)
    assert np.array_equal(tmeta["w"], w)
    assert targs["ms"].shape[1] == tb.stripe_width(w.max())
    if name == "wide":
        assert w.max() > 128
    if name == "pair_end":
        assert int(targs["iscal"][3]) >= 0      # ybrk
    n0 = tb.PLAIN_CALLS
    codes, corner = tb.banded_fill(**targs)
    assert tb.PLAIN_CALLS == n0 + 1
    assert np.array_equal(corner.numpy().view(np.uint32),
                          ref_corner.view(np.uint32))
    assert np.isfinite(ref_corner).any() == (name != "dead_end")

    cells = vpb._PallasBandedCells(bpp, meta, g1, g2)
    codes = codes.numpy()
    mine, ref = [], []
    for d in range(1, L + R - 1):
        for t in range(int(w[d])):
            i = int(ilo[d]) + t
            c = int(codes[d - 1, t])
            mine.append((c & 3, (c >> 2) & 3, (c >> 4) & 3))
            ref.append(tuple(cells._field(m, i, d - i)
                             for m in (M_MAT, X_MAT, Y_MAT)))
    assert len(mine) == int(w[1:].sum()) > 0
    assert mine == ref

    # the reference's own prepared state through the parity harness
    # gives the same fill
    hargs = inputs_from_reference(dict(meta, **args))
    for k in ("fscal", "iscal", "sched", "ms"):
        assert torch.equal(hargs[k], targs[k]), k
    hcodes, hcorner = tb.banded_fill(**hargs)
    assert np.array_equal(hcodes.numpy(), codes)
    assert torch.equal(hcorner.view(torch.int32), corner.view(torch.int32))


def test_banded_fill_prefix_is_the_same_work():
    """The fill is causal over diagonals: the call cut to its first N
    diagonals, with the corner moved to the last of them, gives the whole
    call's first N code rows (how a long call is held against the plain
    version on a card)."""
    s1, s2, qual, kw, _band = _case("narrow")
    t1, t2, ts = _prep(tbuild, tmark, TAlignSettings, s1, s2, qual, kw)
    upper, lower = tplan_band(t1, t2, ts)[0]
    targs, _meta = tb.banded_args(t1, t2, TMODEL, ts, upper, lower, "cpu")
    codes, corner = tb.banded_fill(**targs)
    Dn = targs["ms"].shape[0]
    for n in (Dn // 2, Dn):
        pre = {"fscal": targs["fscal"], "sched": targs["sched"][:n],
               "ms": targs["ms"][:n], "iscal": targs["iscal"].clone()}
        pre["iscal"][4] = n
        pre["iscal"][5] = pre["sched"][-1, 1] - 1
        pcodes, pcorner = tb.banded_fill(**pre)
        assert torch.equal(pcodes, codes[:n])
        assert torch.isfinite(pcorner).any()
    # at the whole length the moved corner is the pair's end corner
    assert torch.equal(pcorner.view(torch.int32), corner.view(torch.int32))


def test_stripe_folds_bit_identical(monkeypatch):
    """The port's torch fold, its native host fold and the JAX device
    fold (PAGAN2_DEVICE_MSFOLD=1 on the CPU) give the same bits."""
    rng = np.random.default_rng(7)
    # Dn * 128 must pass the reference's 2**22-cell device-fold gate
    s1, s2 = _related(rng, 16500, 0.02)
    g1, g2 = build_leaf_graph(s1, alph.DNA), build_leaf_graph(s2, alph.DNA)
    settings = AlignSettings()
    upper, lower = plan_band(g1, g2, replace(settings, force_gap=True))[0]
    monkeypatch.setenv("PAGAN2_DEVICE_MSFOLD", "1")
    args, meta = vpb.pallas_banded_args(g1, g2, MODEL, settings, upper,
                                        lower)
    ilo, w = meta["ilo"], meta["w"]
    Dn = len(ilo) - 1
    assert Dn * meta["S"] * meta["Wl"] >= 1 << 22
    ref = np.asarray(args["ms"]).reshape(args["ms"].shape[0], -1)

    t1, t2 = tbuild(s1, talph.DNA), tbuild(s2, talph.DNA)
    inp = tb.prepare_sheared(t1, t2, TMODEL, TAlignSettings(), np.float32,
                             with_ms=False)
    L, R = inp["L"], inp["R"]
    Wk = tb.stripe_width(w.max())
    streams = (np.asarray(t1.states[:L], np.int32),
               np.asarray(t2.states[:R], np.int32),
               inp["lw"], inp["rw"],
               np.asarray(TMODEL.log_score, np.float32), ilo, w, Wk,
               inp["lng"])
    monkeypatch.setattr(tb, "FOLD_CHUNK_CELLS", 1 << 20)
    mine = tb.fold_banded_stripe(*streams, "cpu").numpy()
    assert tnative.get_lib() is not None
    native = tb._host_fold(*streams, "cpu").numpy()
    assert mine.shape == (Dn, Wk)
    assert np.array_equal(mine.view(np.uint32), native.view(np.uint32))
    assert np.array_equal(mine.view(np.uint32),
                          np.ascontiguousarray(ref[:Dn, :Wk])
                          .view(np.uint32))
    assert not ref[:Dn, Wk:].any()
    # and the schedule the reference built on the device
    sched = tb.band_sched(ilo, w, Wk)
    assert np.array_equal(sched, np.asarray(args["sched_dev"])[:Dn])


def test_plan_band_matches_reference():
    rng = np.random.default_rng(1)
    s1, s2 = _related(rng, 3500, 0.05, deletion=12)
    band, skipped = plan_band(build_leaf_graph(s1, alph.DNA),
                              build_leaf_graph(s2, alph.DNA),
                              AlignSettings())
    tband, tskipped = tplan_band(tbuild(s1, talph.DNA),
                                 tbuild(s2, talph.DNA), TAlignSettings())
    assert skipped is tskipped is False
    for a, b in zip(band, tband):
        assert np.array_equal(np.asarray(a), np.asarray(b))
    _ilo, W = tb.band_windows(tband[0], tband[1], len(s1) + 1,
                              len(s2) + 1)
    assert W < 128


def _sig(path):
    return [(p.mp.matrix, p.mp.x_ind, p.mp.y_ind, p.mp.x_edge_ind,
             p.mp.y_edge_ind) for p in path]


def test_routes_and_dead_end_refill():
    """_plan_job sends a thin-band linear job to kernel C ("banded") and a
    wide-band one to the batched kernel A launch ("batch"); a band that
    dead-ends is refilled over the full matrix and gives the unbanded
    path."""
    rng = np.random.default_rng(3)
    s1, s2 = _related(rng, 600, 0.05)
    L, R = len(s1) + 1, len(s2) + 1
    c = np.arange(L) * R // L
    settings = TAlignSettings()

    def job(half):
        return tex.PairJob(tbuild(s1, talph.DNA), tbuild(s2, talph.DNA),
                           TMODEL, settings,
                           band=(np.maximum(c - half, 0),
                                 np.minimum(c + half, R - 1)))
    assert tex._plan_job(job(20)) == "banded"
    assert tex._plan_job(job(400)) == "batch"

    s1, s2, _q, _kw, band = _case("dead_end")

    def pair():
        return tbuild(s1, talph.DNA), tbuild(s2, talph.DNA)
    upper, lower = band(len(s1) + 1, len(s2) + 1)
    n_plain = tl.PLAIN_CALLS
    n_banded = tb.PLAIN_CALLS
    path, end = tb.banded_align_path(*pair(), TMODEL, settings, upper,
                                     lower, device="cpu")
    assert tb.PLAIN_CALLS == n_banded + 1
    assert tl.PLAIN_CALLS == n_plain + 1
    fpath, fend = tl.linear_align_path(*pair(), TMODEL, settings,
                                       device="cpu")
    assert _sig(path) == _sig(fpath)
    assert end.score == fend.score


def test_cli_anchor_flags_reach_plan_band(monkeypatch):
    """--force-gap, --force-gap-threshold, --memory-for-single-alignment,
    --anchors-offset and the prefix-anchor flags reach plan_band for a
    linear pair as the CLI drives it (through the executor); with
    --no-anchors no band is planned; a budget the band cannot meet
    raises the reference's memory error."""
    from pagan2_tpu_torch import align as talign
    from pagan2_tpu_torch.cli import build_parser, make_settings

    def settings(*flags):
        return make_settings(build_parser().parse_args(
            ["-s", "seqs.fas", "-t", "tree.nh"] + list(flags)))

    seen = []
    real = talign.plan_band

    def spy(left, right, s):
        seen.append(s)
        return real(left, right, s)
    monkeypatch.setattr(talign, "plan_band", spy)
    s1, s2 = _related(np.random.default_rng(1), 3500, 0.05, deletion=12)

    def job(s):
        return tex.PairJob(tbuild(s1, talph.DNA), tbuild(s2, talph.DNA),
                           TMODEL, s)
    j = job(settings("--force-gap", "--force-gap-threshold", "77",
                     "--memory-for-single-alignment", "4321",
                     "--anchors-offset", "9", "--use-prefix-anchors",
                     "--prefix-hit-length", "21"))
    tex._plan_job(j)
    assert len(seen) == 1 and j.band is not None
    got = seen[0]
    assert (got.force_gap, got.force_gap_threshold, got.memory_limit_mb,
            got.anchors_offset, got.use_prefix_anchors,
            got.prefix_hit_length) == (True, 77, 4321, 9, True, 21)

    seen.clear()
    j = job(settings("--no-anchors"))
    assert tex._plan_job(j) == "batch" and j.band is None and not seen

    with pytest.raises(MemoryError):
        talign.align_pair(tbuild(s1, talph.DNA), tbuild(s2, talph.DNA),
                          TMODEL, settings("--memory-for-single-alignment",
                                           "0"), device="cpu")
    assert len(seen) == 1


# Wk -> (build, threads, window positions a thread, diagonals staged)
# of kernel C's launch plan
BANDED_PLANS = [
    (128, ("window", 128, 1, 32)),     # the megabase pair, w.max() 65
    (256, ("window", 256, 1, 32)),     # long_family, the 10% pair
    (384, ("window", 128, 3, 32)),     # long_family
    (512, ("window", 256, 2, 32)),     # pair-end breaks
    (640, ("window", 128, 5, 16)),
    (1024, ("window", 256, 4, 8)),
    (1152, ("block", 1024, 2, 16)),    # the wide window
    (1280, ("window", 256, 5, 4)),
    (1536, ("block", 1024, 2, 8)),
    (5504, ("global", 1024, 6, 0)),    # the global ring
]


@pytest.mark.parametrize("Wk, want", BANDED_PLANS,
                         ids=["Wk%d" % w for w, _p in BANDED_PLANS])
def test_banded_plan(Wk, want):
    """banded_plan's build, block and staging for the stripe widths the
    paths give kernel C (the megabase pair's 128, the long family's 256
    and 384, the band shapes') and around them, and its shared bytes
    for that build."""
    p = tb.banded_plan(Wk)
    assert (p["build"], p["threads"], p["rows_a_thread"], p["stage"]) \
        == want
    td = p["stage"]
    if p["build"] == "window":
        assert p["smem"] == 144 * Wk + 2 * td * (4 * Wk + 80)
    elif p["build"] == "block":
        assert p["smem"] == 36 * Wk + 2 * td * (4 * Wk + 32)
    else:
        assert p["smem"] == 0


def test_banded_plan_grid_limits():
    """Over stripe widths up to 8,192: the window kernel takes exactly
    the instantiations it has (threads x positions = Wk) and is chosen
    wherever one fits in shared memory; the block kernel's threads are
    min(1024, Wk), covering the stripe; the staged chunks and the ring
    fit in shared memory; the global ring only where the block kernel's
    ring and one staged diagonal do not."""
    for Wk in range(128, 8193, 128):
        p = tb.banded_plan(Wk)
        threads = p["threads"]
        assert 0 <= p["smem"] <= tb.MAX_SHARED_BYTES
        assert threads % 32 == 0 and 32 <= threads <= 1024
        built = (threads in tb.WINDOW_BUILDS
                 and p["rows_a_thread"] in tb.WINDOW_BUILDS[threads])
        if p["build"] == "window":
            assert built and threads * p["rows_a_thread"] == Wk
            assert 1 <= p["stage"] <= tb.WINDOW_MAX_STAGE
        else:
            assert threads == min(1024, Wk)
            assert threads * p["rows_a_thread"] >= Wk
            for t, rpts in tb.WINDOW_BUILDS.items():
                if Wk % t == 0 and Wk // t in rpts:
                    assert tb.window_plan(Wk, t)["stage"] == 0
            if p["build"] == "block":
                assert 1 <= p["stage"] <= tb.MAX_STAGE_DIAGONALS
            else:
                assert p["stage"] == 0
                assert 36 * Wk + 2 * (4 * Wk + 32) > tb.MAX_SHARED_BYTES
