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
    if case == "homopolymer_runs11":
        # a pileup's fan-in on both sides: runs of 12 and 11 on the
        # left, 11 and 13 on the right (K 12 x 13, offsets up to 13)
        rng = np.random.default_rng(19)

        def seq(runs):
            s = ""
            for c, n in runs:
                while len(s) % 50 < 45:
                    s += str(rng.choice([b for b in "ACGT"
                                         if b != c and s[-1:] != b]))
                s += c * n
            return s + "GTCAGT"
        return (build_leaf_graph(seq([("A", 12), ("C", 11), ("T", 3)]),
                                 alph.DNA, homopolymer=True),
                build_leaf_graph(seq([("A", 11), ("G", 13), ("T", 2)]),
                                 alph.DNA, homopolymer=True))
    if case == "ancestors_onehot":
        # skip offset 8 on both sides: past OFF_CAP, within the one-hot
        # core's OLm * ORm <= 64
        return _ancestor_pair(5, 70, 7)
    return _ancestor_pair(11, 90, 12)           # skip offset 13: gather


@pytest.mark.parametrize("case,windowed", [("homopolymer_run", False),
                                           ("ancestors", False),
                                           ("ancestors", True),
                                           ("ancestors_onehot", True),
                                           ("homopolymer_runs11", True)])
def test_fanin_plain_matches_scan_core(tmp_path, case, windowed):
    g1, g2 = _overcap_pair(case)
    ref, mine = _both_sides(tmp_path, g1, g2)
    KLg, OL = fanin_stats(g1)
    KRg, OR = fanin_stats(g2)
    assert not vpf.pallas_fanin_eligible([ref], 1, _bucket(ref["L"]))
    if case == "homopolymer_runs11":
        assert (ref["KL"], ref["KR"]) == (12, 13)
    L, R = ref["L"], ref["R"]
    Lp, Rp = _bucket(L), _bucket(R)
    D = Lp + Rp - 1
    KL, KR = _k_bucket(ref["KL"]), _k_bucket(ref["KR"])
    G = _g_bucket(ref["OL"] + ref["OR"])
    W, ilo = Lp, np.zeros(D, np.int32)
    if windowed:
        # the pileup's window of 64 rows for the homopolymer runs
        half = 44 if case == "homopolymer_runs11" else 6
        c = np.arange(L) * R // L
        upper, lower = np.maximum(c - half, 0), np.minimum(c + half, R - 1)
        ilo_r, Wreal = band_windows(upper, lower, L, R)
        W = _bucket(Wreal)
        assert W < Lp and (W == 64) == (case == "homopolymer_runs11")
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
    # past the templates: the group build (8 and 2 lanes a group)
    ((100, 8, 9, 2, 15), (0, 0, "shared", 9, 800, 1)),
    ((300, 12, 4, 5, 15), (0, 0, "shared", 13, 608, 1)),
    # too wide for 3 diagonals on chip
    ((7000, 26, 1, 1, 15), (1, 1, "global", 0, 1024, 7)),
]


def _smem(p, W, G, KL, KR, nf, Lr, Rr):
    """The shared bytes a plan must ask for: the ring, the match table
    and the window-start ring, and the group build's tables (16 bytes an
    entry, from a 16-byte boundary) where they are in shared memory."""
    ring = 4 * (nf * nf + G + 1) + 12 * W * p["hot"]
    if p["tables"] != "shared":
        return ring
    return -(-ring // 16) * 16 + 16 * (Lr + Rr + Lr * KL + Rr * KR)


@pytest.mark.parametrize("key,want", PLANS)
def test_fanin_launch_plan(key, want):
    W = key[0]
    p = tf.launch_plan(*key, W, W)
    assert (p["KL"], p["KR"], p["placement"], p["hot"], p["threads"],
            p["rows"]) == want
    assert p["build"] == ("templated" if want[0] else "groups")
    assert p["smem"] == _smem(p, *key, W, W) <= 227 * 1024


# the group build's plans on the --pileup calls (K 11-13 x 10-12, G
# 20-25, W 32-96; Lr, Rr up to 546 x 390 at 160 reads), the --454 ones
# (K 6 x 3, G 9), one side's fan-in alone past the templates, and wide
# windows whose ring goes "hot" and "global": (W, G, KL, KR, nf, Lr,
# Rr) -> (lanes a group, rows a group, threads, ring, diagonals on chip,
# tables)
GROUP_PLANS = [
    ((32, 20, 11, 12, 15, 500, 390), (8, 1, 256, "shared", 21, "shared")),
    ((64, 22, 12, 11, 15, 500, 390), (8, 1, 512, "shared", 23, "shared")),
    ((96, 25, 13, 10, 15, 546, 390), (8, 1, 768, "shared", 26, "shared")),
    ((64, 24, 13, 10, 15, 546, 390), (8, 1, 512, "shared", 25, "shared")),
    ((96, 20, 11, 12, 15, 420, 385), (8, 1, 768, "shared", 21, "shared")),
    ((64, 9, 6, 3, 15, 500, 390), (8, 1, 512, "shared", 10, "shared")),
    ((64, 14, 13, 1, 15, 400, 390), (8, 1, 512, "shared", 15, "shared")),
    ((64, 14, 1, 13, 15, 400, 390), (8, 1, 512, "shared", 15, "shared")),
    # a pileup's tables past 227 KB beside the ring: read through the L1
    ((96, 25, 13, 12, 15, 700, 500), (8, 1, 768, "shared", 26, "global")),
    # wider windows: fewer lanes a group, then rows
    ((300, 12, 6, 5, 15, 300, 300), (2, 1, 608, "shared", 13, "shared")),
    ((2048, 26, 6, 3, 15, 2048, 2048), (1, 2, 1024, "hot", 9, "global")),
    ((7000, 26, 6, 3, 15, 7000, 390), (1, 7, 1024, "global", 0, "global")),
]


@pytest.mark.parametrize("key,want", GROUP_PLANS)
def test_fanin_group_plan(key, want):
    p = tf.launch_plan(*key)
    assert (p["group"], p["rows"], p["threads"], p["placement"], p["hot"],
            p["tables"]) == want
    assert (p["build"], p["KL"], p["KR"]) == ("groups", 0, 0)
    assert p["smem"] == _smem(p, *key) <= 227 * 1024
    # a group size forced for the --groups sweep: the block follows it
    for S in (1, 2, 4, 8, 16, 32):
        f = tf.launch_plan(*key, group=S)
        assert f["group"] == S and f["rows"] == -(-key[0] // (1024 // S))
        assert f["threads"] == -(-(-(-key[0] // f["rows"]) * S) // 32) * 32
    for S in (3, 64):
        with pytest.raises(ValueError, match="power of two"):
            tf.launch_plan(*key, group=S)


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
            p = tf.launch_plan(W, G, KL, KR, nf, W, W)
            fixed = 4 * (nf * nf + G + 1)
            assert p["smem"] == _smem(p, W, G, KL, KR, nf, W, W) \
                <= 227 * 1024
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
            t, rows = p["threads"], p["rows"]
            if not templ:
                # whole groups of S lanes, one a window position, in
                # the fewest rows a block of 1,024 threads allows
                S = p["group"]
                assert S == tf.group_size(W) and t % 32 == 0 and t <= 1024
                assert rows == -(-W // (1024 // S))
                assert (t // S) * rows >= W > ((t - 32) // S) * rows
                assert p["tables"] == ("shared" if p["smem"] > fixed +
                                       12 * W * p["hot"] else "global")
                continue
            cap = 1024 if max(p["KL"], p["KR"]) <= 2 else 512
            assert t % 32 == 0 and t <= cap
            assert rows == (1 if W <= 512 else max(2, -(-W // cap)))
            assert t * rows >= W > (t - 32) * rows
            assert p["ahead"] == (2 if t <= 256 else 1)


def _emulate_group_build(args, G, W, S):
    """Kernel B's group build (csrc/viterbi_fanin.cu, design note 5) in
    plain Python: each row's and column's live slots (offset in 1..G, in
    slot order); a cell's X and Y slots dealt over S lanes, then its M
    slot pairs (a pair's left slot by the kernel's multiply-high with
    2^32 / nr rounded up); each lane's strict first-wins scan, then the
    shuffle butterfly (larger value; lower code on equal values). f32
    adds in the kernel's order. Returns (bp, snap) as numpy."""
    h = {k: v.numpy() for k, v in args.items() if isinstance(v, torch.Tensor)}
    f = np.float32
    NEG = f(-np.inf)
    B, D = h["ilo"].shape
    KR = h["roff"].shape[2]
    bp = np.zeros((B, D, W), np.uint32)
    snap = np.full((B, 3, G, W), NEG, f)

    def live(off, lw, op):
        return [[(int(off[x, k]), k, lw[x, k], op[x, k])
                 for k in range(off.shape[1]) if 0 < off[x, k] <= G]
                for x in range(off.shape[0])]

    def better(a, o):
        return o if o[0] > a[0] or (o[0] == a[0] and o[1] < a[1]) else a

    for b in range(B):
        L, R = (int(v) for v in h["iscal"][b])
        lng, lgo = h["fscal"][b]
        ilo = h["ilo"][b]
        lsl = live(h["loff"][b], h["llw"][b], h["lopen"][b])
        rsl = live(h["roff"][b], h["rlw"][b], h["ropen"][b])
        ring = np.full((3, D, W), NEG, f)

        def fetch(d, o, r):
            e = d - o
            rel = r - int(ilo[e]) if e >= 0 else -1
            return ring[:, e, rel] if 0 <= rel < W else (NEG, NEG, NEG)
        for d in range(D):
            for t in range(W):
                i = int(ilo[d]) + t
                j = d - i
                lanes = [[(NEG, 255), (NEG, 255), (NEG, 65535)]
                         for _ in range(S)]
                if 0 <= i < L and 0 <= j < R and \
                        h["bup"][b, i] <= j <= h["blo"][b, i]:
                    nl, nr = len(lsl[i]), len(rsl[j])
                    magic = 0xffffffff // nr + 1 if nr > 1 else 0
                    mbase = lng + h["table"][b, h["lstate"][b, i],
                                             h["rstate"][b, j]]
                    for q in range(nl + nr + nl * nr):
                        if q < nl:
                            o, k, _lw, op = lsl[i][q]
                            vm, vx, vy = fetch(d, o, i - o)
                            kind, code = 0, 3 * k
                            cand = (vx + h["gextj"][b, j], vy + lgo,
                                    (vm + lng) + op)
                        elif q < nl + nr:
                            o, k, _lw, op = rsl[j][q - nl]
                            vm, vx, vy = fetch(d, o, i)
                            kind, code = 1, 3 * k
                            cand = (vy + h["gexti"][b, i], vx + lgo,
                                    (vm + lng) + op)
                        else:
                            p = q - nl - nr
                            al = p if nr == 1 else (p * magic) >> 32
                            ol, kl, lw, _o = lsl[i][al]
                            orr, kr, rw, _o = rsl[j][p - al * nr]
                            if ol + orr > G:
                                continue
                            vm, vx, vy = fetch(d, ol + orr, i - ol)
                            base = (mbase + lw) + rw
                            kind, code = 2, (kl * KR + kr) * 3
                            cand = ((vm + lng) + base, vx + base, vy + base)
                        lane = q % S if q < nl + nr else (q - nl - nr) % S
                        best = lanes[lane][kind]
                        for move, v in enumerate(cand):
                            if v > best[0]:
                                best = (f(v), code + move)
                        lanes[lane][kind] = best
                m = S // 2
                while m:
                    lanes = [[better(lanes[x][s], lanes[x ^ m][s])
                              for s in range(3)] for x in range(S)]
                    m //= 2
                (bX, cX), (bY, cY), (bM, cM) = lanes[0]
                ok = (i > 0 and bX > NEG, j > 0 and bY > NEG,
                      i > 0 and j > 0 and bM > NEG)
                X = bX if ok[0] else NEG
                Y = bY if ok[1] else NEG
                M = f(0) if i == 0 and j == 0 else bM if ok[2] else NEG
                ring[:, d, t] = (M, X, Y)
                bp[b, d, t] = ((cM if ok[2] else 65535)
                               | (cX if ok[0] else 255) << 16
                               | (cY if ok[1] else 255) << 24)
            if d == L + R - 2:
                for g in range(min(G, d + 1)):
                    snap[b, :, g] = ring[:, d - g]
    return bp, snap


@pytest.mark.parametrize("case,S", [("pileup", 1), ("pileup", 4),
                                    ("pileup", 32), ("ties", 8),
                                    ("batch", 16)])
def test_group_build_emulation_matches_plain(case, S):
    """The group build's schedule, emulated in plain Python at several
    group sizes, gives fanin_fill_plain's codes and corner snapshots bit
    for bit: on windowed homopolymer pairs of fan-in 11 x 10 (a band
    of +-14), the same with every edge of one weight and one sequence on
    both sides (ties across slots), and a ragged batch at full width
    past the 4 x 4 templates."""
    model = TModelFactory(talph.DNA).alignment_model(0.2)
    rng = np.random.default_rng(23)

    def graph(n, longest, seq=None):
        if seq is None:
            s = []
            while len(s) < n:
                c = str(rng.choice([c for c in "ACGT" if not s or c != s[-1]]))
                s += c * (longest if n // 3 - 4 <= len(s) < n // 3
                          else int(rng.integers(1, 5)))
            seq = "".join(s[:n])
        from pagan2_tpu_torch.graph import build_leaf_graph as leaf
        return leaf(seq, talph.DNA, homopolymer=True), seq

    def prep(n1, k1, n2, k2, same=False):
        g1, s1 = graph(n1, k1)
        g2, _s = graph(n2, k2, s1 if same else None)
        return tf.prepare_fanin(g1, g2, model, SETTINGS, np.float32)
    if case == "batch":
        inps, kw = [prep(60, 6, 50, 2), prep(40, 2, 55, 7)], {}
    else:
        inp = prep(110, 11, 100, 10, same=case == "ties")
        if case == "ties":
            inp["llw"][:] = 0.0
            inp["rlw"][:] = 0.0
        L, R = inp["L"], inp["R"]
        c = np.arange(L) * R // L
        inp["band_upper"] = np.maximum(c - 14, 0).astype(np.int32)
        inp["band_lower"] = np.minimum(c + 14, R - 1).astype(np.int32)
        ilo_r, Wreal = band_windows(inp["band_upper"], inp["band_lower"],
                                    L, R)
        ilo = np.zeros(L + R - 1, np.int32)
        ilo[:len(ilo_r)] = ilo_r
        ilo[len(ilo_r):] = ilo_r[-1]
        inps, kw = [inp], dict(W=_bucket(Wreal), ilo=ilo)
    args = tf.fanin_batch_args(inps, "cpu", **kw)
    assert max(args["loff"].shape[2], args["roff"].shape[2]) > tf.TEMPLATE_K
    G, W = args.pop("G"), args.pop("W")
    pb, ps = tf.fanin_fill_plain(G=G, W=W, **args)
    eb, es = _emulate_group_build(args, G, W, S)
    assert np.array_equal(eb, pb.numpy().view(np.uint32))
    assert np.array_equal(_bits(es), _bits(ps.numpy()))
