"""Band-axis sharding of one pair in the port (align/viterbi_shardband.py:
kernels G and H, here their plain versions) against the JAX package on
the CPU, the cases of tests/test_shardband.py at f32:

- the linear fill's codes and corner scores bit-equal to the JAX
  package's scan core (sheared_fill, which its own tests hold
  bit-identical to its shard_map fill) on every in-matrix cell, and to
  its shard_map fill itself on the (4, 129, 257, 8) shape (its compiles
  are kept few and small: a halo of 32 unrolls a 46-second compile);
- paths against the host oracle and the scan core, banded and with the
  full-matrix retry of a band that dead-ends, on uneven splits, one
  shard and a halo clamped to the owned width;
- the fan-in fill against the one-hot fan-in scan core (fanin_align_path
  at f32) and the JAX package's shard_map fan-in fill, on 454 graphs,
  ancestors with an indel bridge on either side, a large halo, and the
  ValueError of a left bridge wider than the halo;
- the executor's routing with SHARDBAND_MIN_L lowered: a giant pair of a
  generation that underfills the mesh is band-sharded in both packages
  with the same result, and a pair whose bridge exceeds the halo runs
  unsharded.

Every mesh here is JobsMesh([cpu] * n): logical shards in one process."""
import copy

import numpy as np
import pytest
import jax
from jax.sharding import Mesh

from pagan2_tpu.align import AlignSettings as JSettings
from pagan2_tpu.align import align_pair as j_align_pair
from pagan2_tpu.align import viterbi_sheared as JS
from pagan2_tpu.align import viterbi_shardband as JSB
from pagan2_tpu.align.viterbi_fanin import (fanin_align_path as
                                            j_fanin_align_path,
                                            get_fanin_fill, stack_fanin,
                                            _k_bucket, _g_bucket)
from pagan2_tpu.graph import build_leaf_graph as j_leaf
from pagan2_tpu.graph.serialize import graph_to_npz
from pagan2_tpu.models import ModelFactory as JModelFactory
from pagan2_tpu.parallel import executor as J_EX

from pagan2_tpu_torch.align import AlignSettings
from pagan2_tpu_torch.align import viterbi_shardband as SB
from pagan2_tpu_torch.align import viterbi_fanin as PF
from pagan2_tpu_torch.align.oracle import PairAligner
from pagan2_tpu_torch.graph import build_leaf_graph as p_leaf
from pagan2_tpu_torch.graph.serialize import graph_from_npz
from pagan2_tpu_torch.models import ModelFactory, alphabets as alph
from pagan2_tpu_torch.parallel import executor as P_EX
from pagan2_tpu_torch.parallel.executor import JobsMesh

MODEL = ModelFactory(alph.DNA).alignment_model(0.3)
JMODEL = JModelFactory(alph.DNA).alignment_model(0.3)


def _mesh(n):
    return JobsMesh(["cpu"] * n)


def _band_mesh(n):
    return Mesh(np.array(jax.devices()[:n]), ("band",))


def _seqs(seed, n1, n2, sub=0.12):
    rng = np.random.default_rng(seed)
    base = rng.choice(list("ACGT"), size=max(n1, n2))
    mut = base[:n2].copy()
    idx = rng.random(n2) < sub
    mut[idx] = rng.choice(list("ACGT"), size=int(idx.sum()))
    return "".join(base[:n1]), "".join(mut)


def _pair(leaf, seed, n1, n2, sub=0.12):
    s1, s2 = _seqs(seed, n1, n2, sub)
    return leaf(s1, alph.DNA), leaf(s2, alph.DNA)


def _fanin_seqs(seed, n, sub=0.1):
    rng = np.random.default_rng(seed)
    base = rng.choice(list("AACCGGTT"), size=n)
    base[5:10] = "A"
    base[n // 2:n // 2 + 5] = "T"
    mut = base.copy()
    idx = rng.random(n) < sub
    mut[idx] = rng.choice(list("ACGT"), size=int(idx.sum()))
    return "".join(base), "".join(mut)


def _fanin_pair(leaf, seed, n):
    s1, s2 = _fanin_seqs(seed, n)
    return leaf(s1, alph.DNA, mode454=True), leaf(s2, alph.DNA, mode454=True)


def _bridge_pair(pkg, seed, n, lo, hi, tmp_path):
    """An ancestor with an indel bridge (the sites lo..hi deleted in one
    leaf), made by the JAX package, and a leaf of the full sequence, as
    pkg's graphs: the port reads the ancestor from the JAX package's
    .npz file, so both packages hold the same graph."""
    rng = np.random.default_rng(seed)
    base = "".join(rng.choice(list("ACGT"), size=n))
    anc, _ = j_align_pair(j_leaf(base, alph.DNA),
                          j_leaf(base[:lo] + base[hi:], alph.DNA), JMODEL,
                          JSettings(), use_anchors=False)
    if pkg == "jax":
        return anc, j_leaf(base, alph.DNA)
    path = str(tmp_path / ("anc%d.npz" % seed))
    graph_to_npz(anc, path)
    return graph_from_npz(path), p_leaf(base, alph.DNA)


def _steps(path):
    return [(p.mp.matrix, p.mp.x_ind, p.mp.y_ind) for p in path]


def _jax_scan_path(g1, g2, **kw):
    return JS.sheared_align_path(g1, g2, JMODEL, JSettings(),
                                 dtype=np.float32, **kw)


@pytest.mark.parametrize("ndev,n1,n2,H", [(8, 300, 290, 16),
                                          (4, 129, 257, 8),
                                          (2, 64, 64, 32)])
def test_bp_planes_bit_identical(ndev, n1, n2, H):
    s1, s2 = _seqs(0, n1, n2)
    shards, meta = SB.shardband_args(p_leaf(s1, alph.DNA),
                                     p_leaf(s2, alph.DNA), MODEL,
                                     AlignSettings(), ndev, H=H)
    codes, final = SB.shardband_fill(_mesh(ndev), shards, meta)
    L, R = meta["L"], meta["R"]
    assert codes.shape == (L + R - 1, meta["W"])

    inp = JS.prepare_sheared(j_leaf(s1, alph.DNA), j_leaf(s2, alph.DNA),
                             JMODEL, JSettings(), np.float32)
    bp1, final1 = JS.sheared_fill(*JS.shear_device_inputs(
        inp, Lp=JS._bucket(L), Rp=JS._bucket(R)))
    bp1 = np.asarray(bp1).astype(np.uint8)
    for d in range(1, L + R - 1):
        np.testing.assert_array_equal(codes[d, :L], bp1[d, :L],
                                      err_msg="diagonal %d" % d)
    assert np.array_equal(final.view(np.uint32),
                          np.asarray(final1, np.float32).view(np.uint32))
    if H <= 8:
        # the JAX package's shard_map fill itself, rows d = 1 ..
        args, _m = JSB.shardband_args(j_leaf(s1, alph.DNA),
                                      j_leaf(s2, alph.DNA), JMODEL,
                                      JSettings(), ndev, dtype=np.float32,
                                      H=H)
        bp_sh, final_sh = JSB.shardband_fill(_band_mesh(ndev), args, H=H)
        bp_sh = np.asarray(bp_sh).astype(np.uint8)
        assert np.array_equal(codes[1:L + R - 1, :L],
                              bp_sh[:L + R - 2, :L])
        assert np.array_equal(final.view(np.uint32),
                              np.asarray(final_sh).view(np.uint32))


def test_path_matches_oracle():
    path, end = SB.shardband_align_path(*_pair(p_leaf, 3, 150, 140), MODEL,
                                        AlignSettings(), _mesh(8))
    opath, oend = PairAligner(*_pair(p_leaf, 3, 150, 140), MODEL,
                              AlignSettings()).align()
    assert _steps(path) == _steps(opath)
    assert end.score == pytest.approx(oend.score, rel=1e-5)


def test_banded_path_and_fallback():
    """A generous band gives the path of the full fill; a band that
    cannot reach the corner is filled again over the full matrix."""
    g1, g2 = _pair(p_leaf, 5, 200, 200, sub=0.05)
    L, R = g1.num_sites() - 1, g2.num_sites() - 1
    band = (np.maximum(np.arange(L) - 25, 0),
            np.minimum(np.arange(L) + 25, R - 1))
    pb, eb = SB.shardband_align_path(g1, g2, MODEL, AlignSettings(),
                                     _mesh(8), band=band)
    pf, ef = SB.shardband_align_path(*_pair(p_leaf, 5, 200, 200, sub=0.05),
                                     MODEL, AlignSettings(), _mesh(8))
    assert _steps(pb) == _steps(pf) and eb.score == ef.score
    bad = (np.full(L, R - 1), np.full(L, R - 1))
    px, ex = SB.shardband_align_path(*_pair(p_leaf, 5, 200, 200, sub=0.05),
                                     MODEL, AlignSettings(), _mesh(8),
                                     band=bad)
    assert _steps(px) == _steps(pf) and ex.score == ef.score


@pytest.mark.parametrize("nd", [1, 3, 8])
def test_uneven_split_and_single_device(nd):
    """Lane counts that do not divide the shards evenly, and one shard:
    the JAX package's scan-core path, bit for bit."""
    path, end = SB.shardband_align_path(*_pair(p_leaf, 9, 77, 203), MODEL,
                                        AlignSettings(), _mesh(nd))
    jpath, jend = _jax_scan_path(*_pair(j_leaf, 9, 77, 203))
    assert _steps(path) == _steps(jpath)
    assert np.float32(end.score) == np.float32(jend.score)


def test_small_width_shards_clamp_halo():
    """An owned width below the halo (w 32 < H 64) stays exact: the entry
    point clamps H to the owned width."""
    path, end = SB.shardband_align_path(*_pair(p_leaf, 31, 129, 140),
                                        MODEL, AlignSettings(), _mesh(8),
                                        H=64)
    jpath, jend = _jax_scan_path(*_pair(j_leaf, 31, 129, 140))
    assert _steps(path) == _steps(jpath)
    assert np.float32(end.score) == np.float32(jend.score)


@pytest.mark.parametrize("ndev,n,H", [(4, 300, 32), (8, 260, 32)])
def test_fanin_shardband_matches_scan_core(ndev, n, H):
    """A 454 graph pair over the shards: the one-hot fan-in scan core's
    path and score (same candidate order, same codes)."""
    path, end = SB.shardband_fanin_align_path(
        *_fanin_pair(p_leaf, 3, n), MODEL, AlignSettings(), _mesh(ndev),
        H=H)
    jpath, jend = j_fanin_align_path(*_fanin_pair(j_leaf, 3, n), JMODEL,
                                     JSettings(), dtype=np.float32)
    assert _steps(path) == _steps(jpath)
    assert np.float32(end.score) == np.float32(jend.score)


def test_fanin_shardband_matches_jax_shardband():
    """The JAX package's shard_map fan-in fill itself (4 devices, halo
    8: 2 steps a block), path and score."""
    path, end = SB.shardband_fanin_align_path(
        *_fanin_pair(p_leaf, 3, 150), MODEL, AlignSettings(), _mesh(4), H=8)
    jpath, jend = JSB.shardband_fanin_align_path(
        *_fanin_pair(j_leaf, 3, 150), JMODEL, JSettings(), _band_mesh(4),
        H=8, dtype=np.float32)
    assert _steps(path) == _steps(jpath)
    assert np.float32(end.score) == np.float32(jend.score)


def test_fanin_shardband_codes_equal_kernel_b():
    """The fan-in fill's codes and corner rings equal kernel B's plain
    version at full width on every in-matrix cell."""
    g1, g2 = _fanin_pair(p_leaf, 7, 220)
    inp = PF.prepare_fanin(g1, g2, MODEL, AlignSettings(), np.float32)
    L, R = inp["L"], inp["R"]
    G = SB._g_bucket(max(inp["OL"], 1) + max(inp["OR"], 1))
    shards, meta = SB.shardband_fanin_args(inp, 4, H=16)
    bp, snaps = SB.shardband_fanin_fill(_mesh(4), shards, meta, G,
                                        16 // max(inp["OL"], 1))
    bpB, snapB = PF.fanin_fill(**PF.fanin_batch_args([inp], "cpu", G=G))
    assert np.array_equal(bp[:, :L], bpB[0].numpy().view(np.uint32)[:, :L])
    assert np.array_equal(snaps[:, :, :L].view(np.uint32),
                          snapB[0].numpy()[:, :, :L].view(np.uint32))


def test_fanin_shardband_ancestor_pair(tmp_path):
    """An ancestor with an indel bridge against a leaf, the post-gen-1
    progressive shape, left and right: the scan core's path."""
    for left in (True, False):
        anc, leaf = _bridge_pair("port", 8, 240, 80, 92, tmp_path)
        janc, jleaf = _bridge_pair("jax", 8, 240, 80, 92, tmp_path)
        pair, jpair = ((anc, leaf), (janc, jleaf)) if left else \
            ((leaf, anc), (jleaf, janc))
        path, end = SB.shardband_fanin_align_path(*pair, MODEL,
                                                  AlignSettings(), _mesh(4))
        jpath, jend = j_fanin_align_path(*jpair, JMODEL, JSettings(),
                                         dtype=np.float32)
        assert _steps(path) == _steps(jpath)
        assert np.float32(end.score) == np.float32(jend.score)


def test_fanin_shardband_large_halo():
    path, end = SB.shardband_fanin_align_path(
        *_fanin_pair(p_leaf, 7, 220), MODEL, AlignSettings(), _mesh(4), H=40)
    jpath, jend = j_fanin_align_path(*_fanin_pair(j_leaf, 7, 220), JMODEL,
                                     JSettings(), dtype=np.float32)
    assert _steps(path) == _steps(jpath)
    assert np.float32(end.score) == np.float32(jend.score)


def test_fanin_shardband_rejects_bridge_past_halo(tmp_path):
    """A left bridge spanning more lanes than the halo would read past
    the refreshed lanes: ValueError, as in the JAX package."""
    anc, leaf = _bridge_pair("port", 21, 240, 80, 100, tmp_path)
    assert PF.fanin_stats(anc)[1] > 8
    with pytest.raises(ValueError, match="halo budget"):
        SB.shardband_fanin_align_path(anc, leaf, MODEL, AlignSettings(),
                                      _mesh(4), H=8)


def test_fanin_shardband_right_bridge_past_halo_is_fine(tmp_path):
    """Right offsets select ring depth, not lanes: a right bridge wider
    than the halo shards and matches the scan core."""
    anc, leaf = _bridge_pair("port", 29, 240, 80, 92, tmp_path)
    janc, jleaf = _bridge_pair("jax", 29, 240, 80, 92, tmp_path)
    assert PF.fanin_stats(anc)[1] > 8
    path, end = SB.shardband_fanin_align_path(leaf, anc, MODEL,
                                              AlignSettings(), _mesh(4), H=8)
    jpath, jend = j_fanin_align_path(jleaf, janc, JMODEL, JSettings(),
                                     dtype=np.float32)
    assert _steps(path) == _steps(jpath)
    assert np.float32(end.score) == np.float32(jend.score)


def _anc_keys(results):
    return [([int(x) for x in anc.states[:anc.num_sites()]],
             np.float32(end.score)) for anc, end in results]


@pytest.mark.parametrize("fanin", [False, True])
def test_executor_routes_giant_pairs_to_shardband(monkeypatch, fanin):
    """A giant pair (SHARDBAND_MIN_L lowered to its 128 rows, 16 lanes a
    shard and a halo of 16; a fan-in pair to 64 rows, a halo of 8, to
    keep the JAX package's compile small) alone in its generation on 8
    shards is band-sharded in both packages, with the same ancestral
    graph and score."""
    n = 63 if fanin else 127
    monkeypatch.setattr(J_EX, "SHARDBAND_MIN_L", n + 1)
    monkeypatch.setattr(P_EX, "SHARDBAND_MIN_L", n + 1)

    def job(pkg):
        leaf = j_leaf if pkg == "jax" else p_leaf
        ex = J_EX if pkg == "jax" else P_EX
        g1, g2 = (_fanin_pair(leaf, 11, n) if fanin
                  else _pair(leaf, 21, n, 125))
        return [ex.PairJob(left=g1, right=g2,
                           model=JMODEL if pkg == "jax" else MODEL,
                           settings=JSettings() if pkg == "jax" else
                           AlignSettings())]
    J_EX.reset_stats()
    want = J_EX.execute_pair_jobs(job("jax"), mesh=J_EX.make_jobs_mesh(8),
                                  dtype=np.float32)
    assert J_EX.EXEC_STATS["shardband_fills"] == 1
    P_EX.reset_stats()
    got = P_EX.execute_pair_jobs(job("port"), device="cpu", mesh=_mesh(8))
    assert P_EX.EXEC_STATS["shardband_fills"] == 1, P_EX.EXEC_STATS
    assert SB.PLAIN_CALLS["shardband_fanin_block" if fanin else
                          "shardband_linear_block"] > 0
    assert _anc_keys(got) == _anc_keys(want)


def test_executor_falls_back_when_bridge_exceeds_halo(monkeypatch,
                                                      tmp_path):
    """A giant fan-in pair whose left bridge is wider than the halo runs
    unsharded (the ValueError route), with the scan core's score."""
    monkeypatch.setattr(P_EX, "SHARDBAND_MIN_L", 128)
    anc, leaf = _bridge_pair("port", 23, 300, 100, 160, tmp_path)
    assert PF.fanin_stats(anc)[1] > 32
    anc2 = copy.deepcopy(anc)
    P_EX.reset_stats()
    (res,) = P_EX.execute_pair_jobs(
        [P_EX.PairJob(left=anc, right=leaf, model=MODEL,
                      settings=AlignSettings())], device="cpu",
        mesh=_mesh(4))
    assert P_EX.EXEC_STATS["shardband_fills"] == 0, P_EX.EXEC_STATS
    assert P_EX.EXEC_STATS["single_jobs"] == 1
    _p, oend = PF.fanin_align_path(anc2, copy.deepcopy(leaf), MODEL,
                                   AlignSettings(), device="cpu")
    assert res[1].score == oend.score


def test_fanin_plain_matches_onehot_core_on_an_eligible_batch():
    """On a JAX mesh every fan-in batch fills on its one-hot scan core,
    Pallas-eligible or not: kernel B's plain version equals that core on
    a batch of 454 pairs within the Pallas caps (codes and corner rings
    bit-equal)."""
    jp = [_fanin_pair(j_leaf, s, 60) for s in (1, 2)]
    pp = [_fanin_pair(p_leaf, s, 60) for s in (1, 2)]
    from pagan2_tpu.align.viterbi_fanin import prepare_fanin
    jin = [prepare_fanin(*g, JMODEL, JSettings(), dtype=np.float32)
           for g in jp]
    pin = [PF.prepare_fanin(*g, MODEL, AlignSettings(), np.float32)
           for g in pp]
    Lp = JS._bucket(max(x["L"] for x in jin))
    Rp = JS._bucket(max(x["R"] for x in jin))
    KL = _k_bucket(max(x["KL"] for x in jin))
    KR = _k_bucket(max(x["KR"] for x in jin))
    G = _g_bucket(max(x["OL"] + x["OR"] for x in jin))
    OLm = _k_bucket(max(x["OL"] for x in jin))
    ORm = _k_bucket(max(x["OR"] for x in jin))
    assert OLm * ORm <= 64 and max(x["OL"] for x in jin) <= 7
    fill = get_fanin_fill(KL, KR, G, Lp, OLm=OLm, ORm=ORm)
    bp, sM, sX, sY = fill(*stack_fanin(jin, Lp, Rp, KL, KR, G,
                                       dtype=np.float32))
    bp = np.asarray(bp)
    tbp, tsnap = PF.fanin_fill(**PF.fanin_batch_args(
        pin, "cpu", W=Lp, G=G, KL=KL, KR=KR, D=Lp + Rp - 1))
    for b in range(2):
        assert np.array_equal(tbp[b].numpy().view(np.uint32), bp[:, b, :])
        for m, s in enumerate((sM, sX, sY)):
            assert np.array_equal(tsnap[b, m].numpy().view(np.uint32),
                                  np.asarray(s, np.float32)[b].view(
                                      np.uint32))


def test_block_wrappers_check_their_arguments():
    """Kernel G's and H's wrappers refuse wrong shapes and types before
    anything runs, and their launch plans leave owned lanes."""
    shards, meta = SB.shardband_args(*_pair(p_leaf, 1, 40, 40), MODEL,
                                     AlignSettings(), 2, H=8)
    import torch
    a = {k: torch.from_numpy(np.ascontiguousarray(v))
         for k, v in shards[0].items()}
    wloc = meta["H"] + meta["w"]
    cin = torch.full((6, wloc), -np.inf)
    kw = dict(cin=cin, cout=cin.clone(),
              codes=torch.zeros((80, meta["w"]), dtype=torch.uint8),
              corner=torch.zeros(3), lng=meta["lng"], lgo=meta["lgo"],
              L=meta["L"], R=meta["R"], base=-8, H=8, d0=1, nsteps=8, **a)
    SB.shardband_linear_block(**kw)
    with pytest.raises(ValueError, match="codes"):
        SB.shardband_linear_block(**dict(kw, d0=79))
    with pytest.raises(TypeError, match="vlo"):
        SB.shardband_linear_block(**dict(kw, vlo=a["vlo"].float()))
    with pytest.raises(ValueError, match="ms must"):
        SB.shardband_linear_block(**dict(kw, ms=a["ms"][:, :-1].clone()))
    assert SB.linear_block_plan(32) == dict(threads=256, lanes=512,
                                            tile=480)
    with pytest.raises(ValueError, match="nsteps|codes"):
        SB.shardband_linear_block(**dict(kw, nsteps=9))
    with pytest.raises(ValueError, match="tiles"):
        SB.shardband_linear_block(**dict(kw, tiles=(0, 1)))
    p = SB.fanin_block_plan(32, 64)
    assert p["threads"] > 32 and p["smem"] <= SB.SHARED_BYTES
    with pytest.raises(ValueError, match="no owned lane"):
        SB.fanin_block_plan(512, 64)
