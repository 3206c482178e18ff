"""Kernels D's and E's linear cluster build (csrc/fullprob_fwd.cu and
csrc/fullprob_bwd.cu, item 6), pinned on the CPU: its launch plan as a
pure function, and a plain PyTorch emulation of its schedule held bit
for bit against fullprob_fwd_plain / fullprob_bwd_plain and against the
JAX package's Pallas kernels in interpret mode.

The emulation runs each diagonal on C CTAs of `threads` threads x `rows`
lanes (lane k of a CTA is thread k % threads' lane k // threads), each
from its own lanes and from what the kernel hands over by parity: the
maximum each CTA (its warp 0, from its warps' maxima) stores into slot
`rank` of every CTA's row of its diagonal's parity, and the edge lane a
CTA stores into its neighbour's halo slot (D: its last lane into slot 0
of the next CTA's row; E: its first lane's X, and its q a step late,
into slot LC of the CTA before). Every handed
over value carries the diagonal it holds; a read that finds another
diagonal there reads NaN (a maximum read so raises), so a hand-over the
kernel's schedule does not make shows in the planes."""
import numpy as np
import pytest
import torch

from pagan2_tpu.align import fullprob as rfp
from pagan2_tpu.align import fullprob_pallas as fpp
from pagan2_tpu.graph import build_leaf_graph as ref_leaf
from pagan2_tpu.models import ModelFactory as RefModelFactory

from pagan2_tpu_torch.align import fullprob_fill as ff
from pagan2_tpu_torch.align.parity import inputs_from_reference
from pagan2_tpu_torch.models import alphabets as alph

REF_MODEL = RefModelFactory(alph.DNA).alignment_model(0.2)
NAN = float("nan")
# the Pallas kernels against the plain versions (tests/test_torch_
# fullprob.py: XLA's CPU log and its freedom to contract a multiply and
# an add make 0 unlikely)
PLANE_RTOL = 2e-5
PLANE_ATOL = 1e-30
CUM_RTOL = 1e-5


class Handed:
    """One CTA's slot (or row of slots) that peers store into: values
    and the diagonal each holds (None: never written)."""

    def __init__(self, shape, tag=None, value=0.0):
        self.v = torch.full(shape, value, dtype=torch.float32)
        self.tag = tag

    def put(self, v, tag):
        self.v = v.clone()
        self.tag = tag

    def get(self, tag):
        """The values, or NaN where they hold another diagonal."""
        if self.tag is None or (self.tag != "zero" and self.tag != tag):
            return torch.full_like(self.v, NAN)
        return self.v


class Maxima:
    """One CTA's row of CTA maxima of one parity: C slots, each with the
    diagonal it holds."""

    def __init__(self, B, n, tag=None):
        self.v = torch.zeros((B, n), dtype=torch.float32)
        self.tags = [tag] * n

    def put(self, slot, v, tag):
        self.v[:, slot] = v
        self.tags[slot] = tag

    def reduce(self, tag):
        """The maximum over the row, as every warp reduces it."""
        bad = [k for k, t in enumerate(self.tags) if t != tag]
        assert not bad, "maxima slots %s do not hold diagonal %d" % (bad,
                                                                     tag)
        s = self.v.amax(dim=1, keepdim=True)
        return torch.where(s > 0, s, torch.ones_like(s))


def _geometry(C, threads, rows, Lp):
    """The CTA's lanes LC and per CTA its lanes i (global)."""
    LC = threads * rows
    assert C * LC >= Lp and threads % 32 == 0
    k = torch.arange(LC)
    return LC, [c * LC + k for c in range(C)]


def _cta_max(M, X, Y, threads):
    """(B,) maximum of a CTA's raw cells, as its warp 0 gathers it: each
    warp's maximum (thread t owns lanes t, t + threads, ...), then the
    maximum of those."""
    v = torch.maximum(torch.maximum(M, X), Y)
    warp = (torch.arange(v.shape[1]) % threads) // 32
    return torch.stack([v[:, warp == w].amax(dim=1)
                        for w in range(threads // 32)], dim=1).amax(dim=1)


def emulate_fwd(C, threads, rows, ms2, consts, iscal):
    """Kernel D's cluster build, CTA by CTA (see the module's
    docstring). Returns (planes, cum) as fullprob_fwd_plain does."""
    B, D, Lp = ms2.shape
    LC, lanes = _geometry(C, threads, rows, Lp)
    ext, gcgo, nggo, ng2, gcng = (consts[:, k:k + 1] for k in range(5))
    L, R = iscal[:, 0:1].long(), iscal[:, 1:2].long()
    planes = torch.zeros((B, 3, D, Lp), dtype=torch.float32)
    cums = torch.zeros((B, D), dtype=torch.float32)
    z = torch.zeros((B, LC), dtype=torch.float32)
    # shared memory: own rows (slot k + 1 = lane k) a parity, the halo
    # slot 0 (lane -1: 0 in CTA 0, else handed over), the maxima rows
    own = [[torch.zeros((B, LC, 3)) for _p in range(2)] for _c in range(C)]
    halo = [[Handed((B, 3), "zero" if c == 0 else 0 if p == 0 else None)
             for p in range(2)] for c in range(C)]
    wmax = [[Maxima(B, C, 0 if p == 0 else None) for p in range(2)]
            for _c in range(C)]
    for c in range(C):
        wmax[c][0].put(0, torch.ones(B), 0)     # diagonal 0's maximum
    st = []
    for c in range(C):
        i = lanes[c][None, :]
        if c == 0:
            own[c][0][:, 0, 0] = 1.0                # raw M(0, 0)
        st.append(dict(M=torch.where(i == 0, 1.0, 0.0).expand(B, LC)
                       .clone(), X=z.clone(), Y=z.clone(), pm=z.clone(),
                       px=z.clone(), py=z.clone(), cum=torch.zeros((B, 1)),
                       inv1=torch.ones((B, 1)), inv2=torch.ones((B, 1))))

    def finish(c, e):
        s = st[c]
        sc = wmax[c][e & 1].reduce(e)
        inv = torch.reciprocal(sc)
        s["inv2"], s["inv1"] = s["inv1"], inv
        s["cum"] = s["cum"] + torch.log(sc)
        keep = lanes[c] < Lp
        idx = lanes[c][keep]
        for m, key in enumerate("MXY"):
            planes[:, m, e, idx] = (s[key] * inv)[:, keep]
        if c == 0:
            cums[:, e] = s["cum"][:, 0]

    for d in range(1, D):
        for c in range(C):
            finish(c, d - 1)
        for c in range(C):
            s = st[c]
            i = lanes[c][None, :]
            j = d - i
            valid = (j >= 0) & (j < R) & (i < L)
            prev = own[c][(d - 1) & 1]
            # lane i - 1 of d-1: the CTA's own rows, slot 0 its halo
            nb = torch.cat([halo[c][(d - 1) & 1].get(d - 1)[:, None],
                            prev[:, :LC - 1]], dim=1)
            nm, nx, ny = nb[..., 0], nb[..., 1], nb[..., 2]
            inv1, inv2 = s["inv1"], s["inv2"]
            X = ((ext * (nx * inv1)) + (gcgo * (ny * inv1))) + \
                (nggo * (nm * inv1))
            Y = ((ext * (s["Y"] * inv1)) + (gcgo * (s["X"] * inv1))) + \
                (nggo * (s["M"] * inv1))
            msd = ms2[:, d, lanes[c].clamp(max=Lp - 1)]
            M = msd * (((ng2 * ((s["pm"] * inv2) * inv1))
                        + (gcng * ((s["px"] * inv2) * inv1)))
                       + (gcng * ((s["py"] * inv2) * inv1)))
            s["pm"] = torch.where(valid, nm, s["pm"])
            s["px"] = torch.where(valid, nx, s["px"])
            s["py"] = torch.where(valid, ny, s["py"])
            X = torch.where(valid & (i > 0), X, z)
            Y = torch.where(valid & (j > 0), Y, z)
            M = torch.where(valid & (i > 0) & (j > 0), M, z)
            s["M"], s["X"], s["Y"] = M, X, Y
            row = torch.stack([M, X, Y], dim=2)
            keep = (i < Lp)[..., None]
            own[c][d & 1] = torch.where(keep, row, own[c][d & 1])
            if c + 1 < C and int(lanes[c][-1]) < Lp:
                halo[c + 1][d & 1].put(row[:, -1], d)
            lm = _cta_max(M, X, Y, threads)
            for p in range(C):
                wmax[p][d & 1].put(c, lm, d)
    for c in range(C):
        finish(c, D - 1)
    return planes, cums


def emulate_bwd(C, threads, rows, ms2, consts, iscal):
    """Kernel E's cluster build, CTA by CTA (see the module's
    docstring). Returns (planes, cum) as fullprob_bwd_plain does."""
    B, D, Lp = ms2.shape
    LC, lanes = _geometry(C, threads, rows, Lp)
    ext, gcgo, nggo, ng2, gcng = (consts[:, k:k + 1] for k in range(5))
    seed = consts[:, 5:6]
    L, R = iscal[:, 0:1].long(), iscal[:, 1:2].long()
    corner = L + R - 2
    planes = torch.zeros((B, 3, D, Lp), dtype=torch.float32)
    cums = torch.zeros((B, D), dtype=torch.float32)
    z = torch.zeros((B, LC), dtype=torch.float32)
    # own X and q rows a parity (lane k at k); the halo slot LC (lane
    # i + 1 of the CTA's last lane: 0 in the last CTA, else handed over);
    # before any hand-over the rows stand for diagonals D and D + 1,
    # outside the matrix: 0
    xrow = [[torch.zeros((B, LC)) for _p in range(2)] for _c in range(C)]
    qrow = [[torch.zeros((B, LC)) for _p in range(2)] for _c in range(C)]

    def start_tag(c, p, diagonals):
        if c == C - 1:
            return "zero"
        return next((e for e in diagonals if e & 1 == p), None)
    xhalo = [[Handed((B,), start_tag(c, p, [D])) for p in range(2)]
             for c in range(C)]
    qhalo = [[Handed((B,), start_tag(c, p, [D, D + 1])) for p in range(2)]
             for c in range(C)]
    wmax = [[Maxima(B, C) for _p in range(2)] for _c in range(C)]
    st = [dict(M=z.clone(), X=z.clone(), Y=z.clone(),
               ms=z.clone(), cum=torch.zeros((B, 1)),
               inv1=torch.ones((B, 1))) for _c in range(C)]

    def ms_row(c, e):
        return torch.where(lanes[c] < Lp,
                           ms2[:, e, lanes[c].clamp(max=Lp - 1)], 0.0)

    def finish(c, e, with_q):
        s = st[c]
        sc = wmax[c][e & 1].reduce(e)
        s["inv1"] = torch.reciprocal(sc)
        s["cum"] = s["cum"] + torch.log(sc)
        Ms, Xs, Ys = (s[k] * s["inv1"] for k in "MXY")
        keep = lanes[c] < Lp
        idx = lanes[c][keep]
        for m, v in enumerate((Ms, Xs, Ys)):
            planes[:, m, e, idx] = v[:, keep]
        if with_q:
            q = Ms * s["ms"]
            qrow[c][e & 1] = torch.where(keep, q, qrow[c][e & 1])
            if c > 0 and bool(keep[0]):
                qhalo[c - 1][e & 1].put(q[:, 0], e)
        s["Y"] = Ys
        if c == 0:
            cums[:, e] = s["cum"][:, 0]

    for d in range(D - 1, -1, -1):
        par = d & 1
        for c in range(C):
            if d + 1 < D:
                finish(c, d + 1, True)
            st[c]["ms"] = ms_row(c, d)
        for c in range(C):
            s = st[c]
            i = lanes[c][None, :]
            j = d - i
            valid = (j >= 0) & (j < R) & (i < L)
            inv1 = s["inv1"]
            # lane i + 1 of X of d+1 and of q of d+2: own rows, the last
            # slot the halo
            xn = torch.cat([xrow[c][par ^ 1][:, 1:],
                            xhalo[c][par ^ 1].get(d + 1)[:, None]], 1)
            qn = torch.cat([qrow[c][par][:, 1:],
                            qhalo[c][par].get(d + 2)[:, None]], 1)
            xn = xn * inv1
            T = qn * inv1
            yn = s["Y"]
            gt = gcng * T
            X = ((ext * xn) + (gcgo * yn)) + gt
            Y = ((ext * yn) + (gcgo * xn)) + gt
            M = ((nggo * xn) + (nggo * yn)) + (ng2 * T)
            M = torch.where((d == corner) & (i == L - 1), M + seed, M)
            X = torch.where(valid, X, z)
            Y = torch.where(valid, Y, z)
            M = torch.where(valid, M, z)
            keep = i < Lp
            xrow[c][par] = torch.where(keep, X, xrow[c][par])
            if c > 0 and bool(keep[0, 0]):
                xhalo[c - 1][par].put(X[:, 0], d)
            s["M"], s["X"], s["Y"] = M, X, Y
            lm = _cta_max(M, X, Y, threads)
            for p in range(C):
                wmax[p][par].put(c, lm, d)
    for c in range(C):
        finish(c, 0, False)
    return planes, cums


# ----------------------------------------------------------------------
def _pairs(sizes, seed):
    """Reference linear_fullprob_inputs dicts of (left, right) sites, a
    sequence and a copy with 10% of its sites redrawn, cut to size."""
    rng = np.random.default_rng(seed)
    seqs = []
    for n, m in sizes:
        base = rng.choice(list("ACGT"), size=max(n, m))
        mut = base.copy()
        idx = rng.random(len(base)) < 0.1
        mut[idx] = rng.choice(list("ACGT"), size=int(idx.sum()))
        seqs.append(("".join(base[:n]), "".join(mut[:m])))
    Lp = rfp._bucket(max(len(a) for a, _b in seqs) + 1)
    Rp = rfp._bucket(max(len(b) for _a, b in seqs) + 1)
    return [rfp.linear_fullprob_inputs(ref_leaf(a, alph.DNA),
                                       ref_leaf(b, alph.DNA), REF_MODEL,
                                       np.float32, Lp=Lp, Rp=Rp)
            for a, b in seqs]


# name: (pairs (left, right sites), C, threads, rows)
CASES = {
    # L > R; 8 CTAs of 64 lanes over 512, the last three past L
    "c8_long_left": ([(300, 120)], 8, 32, 2),
    # L < R on 2 CTAs of four lanes a thread, 160 lanes over 256
    "c2_long_right": ([(150, 200)], 2, 32, 4),
    # 3 CTAs of 192 lanes over 512: the last one ragged (128 in Lp)
    "c3_ragged_last": ([(400, 380)], 3, 96, 2),
    # L = 1: one left site, the second CTA past Lp
    "c2_one_site": ([(1, 60)], 2, 32, 2),
    # a mixed-length batch, two warps a CTA
    "c3_mixed_batch": ([(250, 240), (60, 90), (180, 30)], 3, 64, 2),
}


def _case(name):
    pairs, C, threads, rows = CASES[name]
    ds = _pairs(pairs, sorted(CASES).index(name))
    return ds, inputs_from_reference(ds, "cpu"), C, threads, rows


@pytest.mark.parametrize("name", sorted(CASES))
def test_cluster_emulation_equals_plain(name):
    """Both emulations bit-equal to the plain versions: planes and cum
    (the cluster's maxima are the one block's, max is exact)."""
    _ds, args, C, threads, rows = _case(name)
    for emulate, plain in ((emulate_fwd, ff.fullprob_fwd_plain),
                           (emulate_bwd, ff.fullprob_bwd_plain)):
        got = emulate(C, threads, rows, **args)
        want = plain(**args)
        assert not torch.isnan(got[0]).any()
        for g, w in zip(got, want):
            assert torch.equal(g.view(torch.int32), w.view(torch.int32)), \
                emulate.__name__


def _pallas_interpret(monkeypatch):
    """The reference's probability kernels in interpret mode, its lane
    roll by -1 wrapped as a roll by n - 1 (as tests/test_torch_
    fullprob.py runs them)."""
    monkeypatch.setattr(fpp, "INTERPRET", True)
    roll = fpp.pltpu.roll

    def roll_any_sign(x, shift, axis, **kw):
        return roll(x, shift % x.shape[axis], axis, **kw)
    monkeypatch.setattr(fpp.pltpu, "roll", roll_any_sign)


@pytest.mark.parametrize("name", ["c8_long_left", "c3_mixed_batch"])
def test_cluster_emulation_matches_pallas_interpret(name, monkeypatch):
    """Both emulations against fullprob_fwd_pallas / fullprob_bwd_pallas
    in interpret mode on the same numpy inputs, with the tolerances of
    the plain versions' own comparison (module docstring)."""
    ds, args, C, threads, rows = _case(name)
    _pallas_interpret(monkeypatch)
    jargs = [np.stack([d[k] for d in ds])
             for k in ("msp_sh", "wr_rext", "wl", "consts")]
    jargs += [np.array([d["L"] for d in ds], np.int32),
              np.array([d["R"] for d in ds], np.int32)]
    seeds = np.array([d["seed"] for d in ds], np.float32)
    for emulate, ref in ((emulate_fwd, fpp.fullprob_fwd_pallas(*jargs)),
                         (emulate_bwd, fpp.fullprob_bwd_pallas(*jargs,
                                                               seeds))):
        planes, cum = emulate(C, threads, rows, **args)
        for k in range(3):
            np.testing.assert_allclose(
                planes[:, k].numpy().astype(np.float64),
                np.asarray(ref[k], np.float64), rtol=PLANE_RTOL,
                atol=PLANE_ATOL, err_msg="%s plane %d" % (emulate.__name__,
                                                          k))
        want = np.asarray(ref[3], np.float64)
        err = np.abs(cum.numpy().astype(np.float64) - want).max()
        assert err <= CUM_RTOL * max(1.0, np.abs(want).max())


def test_emulation_reads_nan_where_nothing_was_handed_over():
    """The emulation's own guard: with D's hand-over of the edge lane
    dropped (the halo never written past diagonal 0) the planes read NaN
    where the next CTA's first lane needs its neighbour."""
    _ds, args, C, threads, rows = _case("c3_ragged_last")
    real = Handed.put

    def no_halo(self, v, tag):
        if self.v.dim() == 2:            # a halo slot of kernel D
            return
        real(self, v, tag)
    Handed.put = no_halo
    try:
        planes, _cum = emulate_fwd(C, threads, rows, **args)
    finally:
        Handed.put = real
    assert torch.isnan(planes).any()


# ----------------------------------------------------------------------
@pytest.mark.parametrize("Lp", [2049, 4097, 5024, 16384, 16385, 16576,
                                32768, 32769, 65536])
def test_cluster_plans(Lp):
    """Past the lane builds (2,048 lanes) both kernels take the cluster
    build: 8 CTAs (the largest portable cluster) of two lanes a thread
    up to 16,384 lanes, then 16 of two lanes, and of four past 32,768;
    every lane covered, each CTA's threads whole warps (at 2,049 lanes
    the eighth CTA holds none: it computes zeros and meets every
    barrier); D's rows 32 bytes a lane, E's 16."""
    for planner, cell in ((ff.fwd_linear_plan, 32), (ff.bwd_linear_plan,
                                                      16)):
        p = planner(Lp)
        C, t, rows = p["cluster"], p["threads"], p["rows"]
        assert C == (ff.CLUSTER_PORTABLE if Lp <= 16384 else
                     ff.CLUSTER_MAX) and C in ff.CLUSTER_SIZES
        assert rows == (2 if Lp <= 32768 else 4)
        assert t % 32 == 0 and t <= 1024
        assert C * t * rows >= Lp > C * (t - 32) * rows
        assert t == -(-(-(-Lp // C)) // (32 * rows)) * 32
        assert p["smem"] == cell * (rows * t + 1) <= ff.SHARED_BYTES - 4096
    assert ff.fwd_linear_plan(ff.CLUSTER_FROM - 1)["cluster"] == 0


def test_cluster_plan_past_65536_lanes_raises():
    with pytest.raises(ValueError, match="at most 65536 lanes"):
        ff.fwd_linear_plan(65537)
    with pytest.raises(ValueError, match="at most 65536 lanes"):
        ff.bwd_linear_plan(100000)


@pytest.mark.parametrize("C", [2, 3, 4, 5, 6, 7, 8, 16])
def test_cluster_build_for_every_size(C):
    """cluster_build: the sizes the plan picks (CLUSTER_SIZES, which
    chip_smoke.py forces) and the smaller ones that
    tools/bench_fullprob.py --giant --clusters may force, two and four
    lanes a thread, on a 4,300-lane call."""
    for rows in (2, 4):
        p = ff.cluster_build(4300, C, rows, 32)
        if p is None:
            assert -(-4300 // C) > 1024 * rows
            continue
        assert p["cluster"] == C and p["rows"] == rows
        assert C * p["threads"] * rows >= 4300
