"""Kernel B's plain version (pagan2_tpu_torch.align.viterbi_fanin)
against the JAX package's fan-in fills on the same f32 inputs:

- the Pallas fan-in kernel in interpret mode, on graphs within its caps
  (454 / homopolymer leaf graphs, and ancestors built by the JAX package,
  written with its graph_to_npz and read back with the port's
  graph_from_npz);
- the f32 scan cores (get_fanin_fill + stack_fanin) on graphs past the
  Pallas caps, at full width and windowed.

Codes and corner snapshots must be bit-equal (tolerance 0)."""
import numpy as np
import pytest
import torch

from pagan2_tpu.align import AlignSettings, align_pair
from pagan2_tpu.align import viterbi_pallas_fanin as vpf
from pagan2_tpu.align.viterbi_banded import band_windows
from pagan2_tpu.align.viterbi_fanin import (prepare_fanin, stack_fanin,
                                            get_fanin_fill, fanin_stats,
                                            _k_bucket, _g_bucket)
from pagan2_tpu.align.viterbi_sheared import _bucket
from pagan2_tpu.graph import build_leaf_graph
from pagan2_tpu.graph.serialize import graph_to_npz
from pagan2_tpu.models import ModelFactory, alphabets as alph

from pagan2_tpu_torch.align import viterbi_fanin as tf
from pagan2_tpu_torch.align.parity import inputs_from_reference
from pagan2_tpu_torch.graph.serialize import graph_from_npz
from pagan2_tpu_torch.models import (ModelFactory as TModelFactory,
                                     alphabets as talph)

SETTINGS = AlignSettings()


def _leaf_pair(seed, n, mode):
    rng = np.random.default_rng(seed)
    s1 = "".join(rng.choice(list("AACCGGTT"), size=n))
    s2 = "".join(rng.choice(list("AACCGGTT"), size=n - 5))
    kw = {"homopolymer": True} if mode == "homopolymer" else \
        {"mode454": True}
    return build_leaf_graph(s1, alph.DNA, **kw), \
        build_leaf_graph(s2, alph.DNA, **kw)


def _ancestor_pair(seed, n, gap):
    """Two ancestors made by the JAX package from leaves with an
    interior deletion of `gap` bases (skip edges of offset gap + 1)."""
    rng = np.random.default_rng(seed)
    model = ModelFactory(alph.DNA).alignment_model(0.2)
    base = rng.choice(list("ACGT"), size=n)

    def leaf(drop):
        mut = base.copy()
        idx = rng.random(n) < 0.1
        mut[idx] = rng.choice(list("ACGT"), size=int(idx.sum()))
        s = "".join(mut)
        if drop:
            s = s[:n // 3] + s[n // 3 + gap:]
        return build_leaf_graph(s, alph.DNA)

    a1, _ = align_pair(leaf(False), leaf(True), model, SETTINGS,
                       engine="oracle")
    a2, _ = align_pair(leaf(True), leaf(False), model, SETTINGS,
                       engine="oracle")
    return a1, a2


def _both_sides(tmp_path, g1, g2, dist=0.2):
    """(reference prep, port prep) of one pair: the port reads its graphs
    from the JAX package's .npz files, and builds its own model."""
    for k, g in enumerate((g1, g2)):
        graph_to_npz(g, str(tmp_path / ("g%d.npz" % k)))
    p1 = graph_from_npz(str(tmp_path / "g0.npz"))
    p2 = graph_from_npz(str(tmp_path / "g1.npz"))
    model = ModelFactory(alph.DNA).alignment_model(dist)
    tmodel = TModelFactory(talph.DNA).alignment_model(dist)
    ref = prepare_fanin(g1, g2, model, SETTINGS, dtype=np.float32)
    mine = tf.prepare_fanin(p1, p2, tmodel, SETTINGS, dtype=np.float32)
    return ref, mine


def _same_args(a, b):
    assert set(a) == set(b)
    for k in a:
        if isinstance(a[k], torch.Tensor):
            assert torch.equal(a[k], b[k]), k
        else:
            assert a[k] == b[k], k


def _bits(x):
    return np.asarray(x, np.float32).view(np.uint32)


@pytest.mark.parametrize("case", ["homopolymer", "454", "ancestors"])
def test_fanin_plain_matches_pallas_interpret(tmp_path, case):
    if case == "ancestors":
        g1, g2 = _ancestor_pair(7, 60, 3)
    else:
        g1, g2 = _leaf_pair(3, 40, case)
    ref, mine = _both_sides(tmp_path, g1, g2)
    assert max(ref["KL"], ref["KR"]) > 1      # real fan-in
    assert vpf.pallas_fanin_eligible([ref], 1, _bucket(ref["L"]))
    Lp, Rp = _bucket(ref["L"]), _bucket(ref["R"])
    KL, KR = _k_bucket(ref["KL"]), _k_bucket(ref["KR"])
    vpf.INTERPRET = True
    try:
        bp, snaps = vpf.pallas_fanin_run([ref], Lp, Rp, KL, KR)
    finally:
        vpf.INTERPRET = False
    G = snaps[0].shape[1]
    kw = dict(W=Lp, G=G, KL=KL, KR=KR, D=Lp + Rp - 1)
    args = inputs_from_reference(ref, **kw)
    _same_args(args, tf.fanin_batch_args([mine], "cpu", **kw))
    tbp, tsnap = tf.fanin_fill(**args)
    assert np.array_equal(tbp[0].numpy().view(np.uint32), bp[0])
    for m in range(3):
        assert np.array_equal(_bits(tsnap[0, m].numpy()),
                              _bits(snaps[m][0]))


def _overcap_pair(case):
    if case == "homopolymer_run":
        # a homopolymer run of 9: fan-in K = 9 > K_CAP_R, offsets 9
        s1 = "CGTCGTAC" + "A" * 9 + "GTCGCTGCA"
        s2 = "CGTCGTA" + "A" * 8 + "TCGCTGCAT"
        return (build_leaf_graph(s1, alph.DNA, homopolymer=True),
                build_leaf_graph(s2, alph.DNA, homopolymer=True))
    if case == "ancestors_onehot":
        # skip offset 8 on both sides: past OFF_CAP, within the one-hot
        # core's OLm * ORm <= 64
        return _ancestor_pair(5, 70, 7)
    return _ancestor_pair(11, 90, 12)           # skip offset 13: gather


@pytest.mark.parametrize("case,windowed", [("homopolymer_run", False),
                                           ("ancestors", False),
                                           ("ancestors", True),
                                           ("ancestors_onehot", True)])
def test_fanin_plain_matches_scan_core(tmp_path, case, windowed):
    g1, g2 = _overcap_pair(case)
    ref, mine = _both_sides(tmp_path, g1, g2)
    KLg, OL = fanin_stats(g1)
    KRg, OR = fanin_stats(g2)
    assert not vpf.pallas_fanin_eligible([ref], 1, _bucket(ref["L"]))
    L, R = ref["L"], ref["R"]
    Lp, Rp = _bucket(L), _bucket(R)
    D = Lp + Rp - 1
    KL, KR = _k_bucket(ref["KL"]), _k_bucket(ref["KR"])
    G = _g_bucket(ref["OL"] + ref["OR"])
    W, ilo = Lp, np.zeros(D, np.int32)
    if windowed:
        c = np.arange(L) * R // L
        upper, lower = np.maximum(c - 6, 0), np.minimum(c + 6, R - 1)
        ilo_r, Wreal = band_windows(upper, lower, L, R)
        W = _bucket(Wreal)
        assert W < Lp
        ilo[:len(ilo_r)] = ilo_r
        ilo[len(ilo_r):] = ilo_r[-1]
        for p in (ref, mine):
            p["band_upper"] = upper.astype(np.int32)
            p["band_lower"] = lower.astype(np.int32)
    OLm, ORm = _k_bucket(ref["OL"]), _k_bucket(ref["OR"])
    assert (OLm * ORm <= 64) == (case == "ancestors_onehot")
    fill = get_fanin_fill(KL, KR, G, W, OLm=OLm, ORm=ORm)
    bp, sM, sX, sY = fill(*stack_fanin([ref], Lp, Rp, KL, KR, G, W=W,
                                       ilo=ilo, dtype=np.float32))
    kw = dict(W=W, ilo=ilo, G=G, KL=KL, KR=KR, D=D)
    args = inputs_from_reference(ref, **kw)
    _same_args(args, tf.fanin_batch_args([mine], "cpu", **kw))
    tbp, tsnap = tf.fanin_fill(**args)
    assert np.array_equal(tbp[0].numpy().view(np.uint32),
                          np.asarray(bp)[:, 0, :])
    for m, s in enumerate((sM, sX, sY)):
        assert np.array_equal(_bits(tsnap[0, m].numpy()),
                              _bits(np.asarray(s)[0]))


# kernel B's launch plan: (W, G, KL, KR, nf) -> (instantiation,
# placement, diagonals on chip, threads, window positions per thread)
PLANS = [
    # the 16 x 1535 main path's windowed and full-width calls
    ((32, 26, 2, 2, 15), (2, 2, "shared", 27, 32, 1)),
    ((512, 26, 2, 2, 15), (2, 2, "shared", 27, 512, 1)),
    ((640, 26, 2, 2, 15), (2, 2, "shared", 27, 320, 2)),
    ((1024, 14, 2, 1, 15), (2, 1, "shared", 15, 512, 2)),
    ((1536, 14, 2, 1, 15), (2, 1, "hot", 12, 768, 2)),
    ((1536, 26, 2, 2, 15), (2, 2, "hot", 12, 768, 2)),
    # 454 K3/3 pairs at full width; a fan-in past 2 x 2 takes 512 threads
    ((2048, 6, 3, 3, 15), (3, 3, "shared", 7, 512, 4)),
    ((1100, 4, 3, 3, 15), (3, 3, "shared", 5, 384, 3)),
    # a window that is not a multiple of 32; a protein table
    ((50, 4, 1, 1, 20), (1, 1, "shared", 5, 64, 1)),
    # past the templates: the runtime-K instantiation
    ((100, 8, 9, 2, 15), (0, 0, "shared", 9, 128, 1)),
    ((300, 12, 4, 5, 15), (0, 0, "shared", 13, 320, 1)),
    # too wide for 3 diagonals on chip
    ((7000, 26, 1, 1, 15), (1, 1, "global", 0, 1024, 7)),
]


@pytest.mark.parametrize("key,want", PLANS)
def test_fanin_launch_plan(key, want):
    p = tf.launch_plan(*key)
    assert (p["KL"], p["KR"], p["placement"], p["hot"], p["threads"],
            p["rows"]) == want
    W, G, KL, KR, nf = key
    assert p["smem"] == 4 * (nf * nf + G + 1) + 12 * W * p["hot"]
    assert p["smem"] <= 227 * 1024


@pytest.mark.parametrize("nf", [4, 15, 20, 64])
@pytest.mark.parametrize("K", [(1, 1), (2, 2), (3, 1), (4, 4), (6, 3)])
def test_fanin_launch_plan_limits(nf, K):
    """Over a grid of widths and ring depths: shared bytes within the
    H100's 227 KB, the whole ring on chip exactly when it fits, else the
    most diagonals that fit (at least 3, or none), every window position
    owned by one thread of a block of whole warps with no idle warp."""
    KL, KR = K
    templ = max(KL, KR) <= tf.TEMPLATE_K
    for W in (1, 31, 32, 33, 500, 1023, 1024, 1025, 2047, 4096, 6000,
              7000, 20000):
        for G in (1, 2, 6, 14, 26, 64, 200):
            p = tf.launch_plan(W, G, KL, KR, nf)
            fixed = 4 * (nf * nf + G + 1)
            assert p["smem"] == fixed + 12 * W * p["hot"] <= 227 * 1024
            fits = fixed + 12 * W * (G + 1) <= 227 * 1024
            assert (p["placement"] == "shared") == fits
            if fits:
                assert p["hot"] == G + 1
            elif p["hot"]:
                assert p["placement"] == "hot" and 3 <= p["hot"] <= G
                assert fixed + 12 * W * (p["hot"] + 1) > 227 * 1024
            else:
                assert p["placement"] == "global"
                assert fixed + 12 * W * 3 > 227 * 1024
            assert (p["KL"], p["KR"]) == ((KL, KR) if templ else (0, 0))
            cap = 1024 if max(p["KL"], p["KR"]) <= 2 else 512
            t, rows = p["threads"], p["rows"]
            assert t % 32 == 0 and t <= cap
            assert rows == (1 if W <= 512 else max(2, -(-W // cap)))
            assert t * rows >= W > (t - 32) * rows
            assert p["ahead"] == (2 if t <= 256 else 1)
