"""The launch plans of the band-sharded fills (align/viterbi_shardband.py:
linear_launch_plan for kernel G, fanin_launch_plan for kernel H), here
with the kernels' plain versions on the CPU:

- a fill on the plan (only the shards and tile ranges that hold cells or
  a carry that can be finite, the halo passed or set to -inf) gives the
  codes, corner and snapshot rings of the fill that launches every shard
  and every tile on every block, bit for bit, on 2, 3 and 4 shards, at a
  halo of 32 and at the default, banded and unbanded, linear and fan-in,
  with small tiles so that many are skipped;
- at the default halo the fill equals the JAX package's shard_map fill
  (run at a halo of 4: its block body unrolls one step a lane of halo,
  and its output does not depend on the halo);
- the plan's launch counts at the sharding gate's shapes, from the plan
  alone.

Every mesh here is JobsMesh([cpu] * n): logical shards in one process."""
import numpy as np
import pytest
import torch
import jax
from jax.sharding import Mesh

from pagan2_tpu.align import AlignSettings as JSettings
from pagan2_tpu.align import viterbi_shardband as JSB
from pagan2_tpu.graph import build_leaf_graph as j_leaf
from pagan2_tpu.models import ModelFactory as JModelFactory

from pagan2_tpu_torch.align import AlignSettings
from pagan2_tpu_torch.align import viterbi_fanin as PF
from pagan2_tpu_torch.align import viterbi_shardband as SB
from pagan2_tpu_torch.graph import build_leaf_graph as p_leaf
from pagan2_tpu_torch.models import ModelFactory, alphabets as alph
from pagan2_tpu_torch.parallel.executor import JobsMesh

MODEL = ModelFactory(alph.DNA).alignment_model(0.3)
JMODEL = JModelFactory(alph.DNA).alignment_model(0.3)


@pytest.fixture(autouse=True)
def one_thread():
    """The plain versions' tensors are small: one intra-op thread a test
    keeps parallel test workers from contending for the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _seqs(seed, n1, n2, sub=0.1, alphabet="ACGT"):
    """A random left sequence and a read of its first n2 sites with
    `sub` of them redrawn."""
    rng = np.random.default_rng(seed)
    base = rng.choice(list(alphabet), size=n1)
    mut = base[:n2].copy()
    idx = rng.random(n2) < sub
    mut[idx] = rng.choice(list("ACGT"), size=int(idx.sum()))
    return "".join(base), "".join(mut)


def _full_plan(L, R, n_dev, w, H, T, K, d_start, tile, vlo=None,
               vhi=None):
    """Every shard and every tile on every block, every halo passed: the
    fill as it ran before the plan."""
    last = L + R - 2
    nt = -(-w // tile)
    blocks = [[d0, min(T, last + 1 - d0),
               {s: (0, nt - 1) for s in range(n_dev)},
               list(range(1, n_dev)), []]
              for d0 in range(d_start, last + 1, T)]
    blocks[-1][3] = []
    return blocks


def _band(L, R, half):
    c = np.arange(L) * R // max(L, 1)
    return (np.maximum(c - half, 0), np.minimum(c + half, R - 1))


def _linear(seed, n, n1, n2, H, band):
    s1, s2 = _seqs(seed, n1, n2)
    g1, g2 = p_leaf(s1, alph.DNA), p_leaf(s2, alph.DNA)
    L, R = g1.num_sites() - 1, g2.num_sites() - 1
    shards, meta = SB.shardband_args(g1, g2, MODEL, AlignSettings(), n,
                                     band=_band(L, R, 24) if band else None,
                                     H=H)
    assert meta["H"] == H <= meta["w"]

    def fill():
        out = SB.shardband_fill(JobsMesh(["cpu"] * n), shards, meta)
        return out, dict(SB.FILL_STATS)
    return fill, meta


def _fanin(seed, n, n1, n2, H, band):
    s1, s2 = _seqs(seed, n1, n2, alphabet="AACCGGTT")
    g1 = p_leaf(s1, alph.DNA, mode454=True)
    g2 = p_leaf(s2, alph.DNA, mode454=True)
    inp = PF.prepare_fanin(g1, g2, MODEL, AlignSettings(), np.float32)
    L, R = inp["L"], inp["R"]
    OLm = max(inp["OL"], 1)
    G = SB._g_bucket(OLm + max(inp["OR"], 1))
    shards, meta = SB.shardband_fanin_args(
        inp, n, band=_band(L, R, 24) if band else None, H=H)
    assert H <= meta["w"]

    def fill():
        out = SB.shardband_fanin_fill(JobsMesh(["cpu"] * n), shards, meta,
                                      G, H // OLm)
        return out, dict(SB.FILL_STATS)
    return fill, meta


# (kind, shards, halo, banded, left sites, right sites, tile geometry:
# kernel G's threads (G_THREADS, two lanes each) or kernel H's lanes
# (H_LANES)); the halo of 256 needs 256 owned lanes a shard (at least
# 385 rows on 2 shards)
CASES = [("linear", 2, 32, False, 200, 80, 32),
         ("linear", 3, 32, True, 220, 90, 32),
         ("linear", 4, 32, False, 129, 100, 32),
         ("linear", 2, SB.HALO, True, 390, 60, 192),
         ("fanin", 2, 32, True, 150, 40, 64),
         ("fanin", 3, 32, False, 150, 40, 64),
         ("fanin", 4, 32, False, 129, 40, 64),
         ("fanin", 2, SB.HALO, True, 386, 16, 384)]


@pytest.mark.parametrize("kind,n,H,band,n1,n2,geo", CASES)
def test_plan_fill_equals_full_fill(monkeypatch, kind, n, H, band, n1, n2,
                                    geo):
    if kind == "linear":
        monkeypatch.setattr(SB, "G_THREADS", geo)
    else:
        monkeypatch.setattr(SB, "H_LANES", geo)
    fill, meta = (_linear if kind == "linear" else _fanin)(
        n1, n, n1, n2, H, band)
    (got, stats) = fill()
    monkeypatch.setattr(SB, "launch_plan", _full_plan)
    (want, full) = fill()
    assert np.array_equal(got[0], want[0])
    assert np.array_equal(got[1].view(np.uint32), want[1].view(np.uint32))
    assert np.isfinite(got[1]).any()
    # the plan launched fewer shards and tiles than the full fill
    assert stats["launches"] < full["launches"]
    assert stats["tiles"] < full["tiles"]


@pytest.mark.parametrize("kind", ["linear", "fanin"])
def test_plan_skips_a_shard_and_crosses_shard_edges(monkeypatch, kind):
    """129 rows on 4 shards of 64 lanes: shard 3 owns no row and never
    launches; a block whose cells span two shards runs the last tile of
    the one and the first tile of the next; every tile range is whole
    and inside its shard."""
    L, R, n, w, H = 130, 101, 4, 64, 32
    assert SB._lane_split(L, n) == w
    monkeypatch.setattr(SB, "G_THREADS", 32)
    monkeypatch.setattr(SB, "H_LANES", 64)
    if kind == "linear":
        tile = SB.linear_block_plan(H)["tile"]
        blocks = SB.linear_launch_plan(L, R, n, w, H)
    else:
        tile = SB.fanin_block_plan(H, 8)["tile"]
        blocks = SB.fanin_launch_plan(L, R, n, w, H, 8, 10)
    nt = -(-w // tile)
    assert all(3 not in b[2] for b in blocks)
    assert all(0 <= t0 <= t1 < nt for b in blocks
               for t0, t1 in b[2].values())
    crossing = [b for b in blocks for s in b[2] if s + 1 in b[2]
                and b[2][s][1] == nt - 1 and b[2][s + 1][0] == 0]
    assert crossing
    # a halo is passed only into a shard that launches next, else set
    # to -inf
    for b, nxt in zip(blocks, blocks[1:]):
        assert sorted(b[3] + b[4]) == sorted(s for s in nxt[2] if s)
    assert SB.plan_launches(blocks) < len(blocks) * 3


def test_default_halo_fill_matches_jax_shardmap():
    """At the default halo (256 lanes, 256 owned a shard) the port's
    linear and fan-in fills equal the JAX package's shard_map fills on
    two virtual CPU devices (halo 4 there: its output is the same at any
    halo, and its compile time grows with it), codes and corner scores
    bit for bit."""
    mesh = Mesh(np.array(jax.devices()[:2]), ("band",))
    s1, s2 = _seqs(5, 400, 100)
    shards, meta = SB.shardband_args(p_leaf(s1, alph.DNA),
                                     p_leaf(s2, alph.DNA), MODEL,
                                     AlignSettings(), 2)
    assert meta["H"] == SB.HALO
    codes, final = SB.shardband_fill(JobsMesh(["cpu"] * 2), shards, meta)
    L, R = meta["L"], meta["R"]
    args, _m = JSB.shardband_args(j_leaf(s1, alph.DNA), j_leaf(s2, alph.DNA),
                                  JMODEL, JSettings(), 2, dtype=np.float32,
                                  H=4)
    bp, jfinal = JSB.shardband_fill(mesh, args, H=4)
    bp = np.asarray(bp).astype(np.uint8)
    assert np.array_equal(codes[1:L + R - 1, :L], bp[:L + R - 2, :L])
    assert np.array_equal(final.view(np.uint32),
                          np.asarray(jfinal).view(np.uint32))

    # fan-in: path and score of a 454 pair, 400 x 60 sites
    f1, f2 = _seqs(6, 400, 60, alphabet="AACCGGTT")
    path, end = SB.shardband_fanin_align_path(
        p_leaf(f1, alph.DNA, mode454=True), p_leaf(f2, alph.DNA,
                                                   mode454=True),
        MODEL, AlignSettings(), JobsMesh(["cpu"] * 2))
    jpath, jend = JSB.shardband_fanin_align_path(
        j_leaf(f1, alph.DNA, mode454=True), j_leaf(f2, alph.DNA,
                                                   mode454=True),
        JMODEL, JSettings(), mesh, H=4, dtype=np.float32)
    assert SB.FILL_STATS["launches"] > 0
    assert [(p.mp.matrix, p.mp.x_ind, p.mp.y_ind) for p in path] == \
        [(p.mp.matrix, p.mp.x_ind, p.mp.y_ind) for p in jpath]
    assert np.float32(end.score) == np.float32(jend.score)


def test_gate_plan_launch_counts():
    """At the sharding gate's shapes, from the plans alone: kernel G on
    65,536 x 1,024 cells over 4 shards launches at most 600 times (8,320
    with every shard on every block of 32 diagonals), kernel H on the
    454 pair's 8,192 x 1,024 cells (ring depth 8, left bridge 3) at most
    500 (3,688 at 10 steps a block)."""
    L, R, n = 65536, 1024, 4
    w = SB._lane_split(L, n)
    g = SB.linear_launch_plan(L, R, n, w, SB.HALO)
    assert SB.plan_launches(g) <= 600
    assert len(_full_plan(L, R, n, w, 32, 32, 2, 1, 480)) * n == 8320
    L = 8192
    w = SB._lane_split(L, n)
    H = SB.fanin_halo(SB.HALO, 8, w)
    f = SB.fanin_launch_plan(L, R, n, w, H, 8, H // 3)
    assert SB.plan_launches(f) <= 500
    assert len(_full_plan(L, R, n, w, 32, 10, 8, 0, 480)) * n == 3688
