"""Kernels D and E: the scaled forward and backward probability plane
fills (csrc/fullprob_fwd.cu, csrc/fullprob_bwd.cu), their plain PyTorch
versions, and the functions that stack the arguments of both.

Replaces pagan2_tpu/align/fullprob_pallas.py (`_fwd_kernel`,
`_bwd_kernel` via `fullprob_fwd_pallas` / `fullprob_bwd_pallas`, and
`_fold_ms2`) for linear-chain pairs, AND the XLA scan cores of
pagan2_tpu/align/fullprob.py for fan-in graph pairs
(`_build_fwd_fanin_gather` / `_build_bwd_fanin_gather` and the one-hot
`_build_fwd_fanin` / `_build_bwd_fanin`): each source holds a linear and
a fan-in entry point with edge slots K, ring depth G and seed depth
Gs, launched as its launch plan (fwd_/bwd_linear_plan,
fwd_/bwd_fanin_plan) says.

Every diagonal of the three matrices is divided by its maximum and the
logarithm of that maximum accumulated, so a plane value times
exp(cum[d]) is the true probability. The arithmetic keeps the Pallas
kernels' expression order, one IEEE f32 operation at a time (the CUDA
sources are built without FMA contraction), sums over edge slots run in
slot order (k, then kl-major over pairs), and the ring of earlier
diagonals is rescaled by every later diagonal's 1/max in turn.

Layouts (row d = anti-diagonal d = i + j, lane i = left site):
  planes (B, 3, D, Lp) f32: M, X, Y;  cum (B, D) f32
  consts (B, 8) f32: ext, gc*go, ng*go, ng*ng, gc*ng, corner seed
         (linear backward), exp clip limit (fan-in backward)
  iscal  (B, 2) int32: L, R (sites without the stop site)

Device rule: a CPU tensor takes the plain version; a CUDA tensor
launches the kernel or raises.
"""
from __future__ import annotations

import ctypes

import numpy as np
import torch

from .. import kernels
from ..kernels import SHARED_BYTES
from .viterbi_linear import _block, batch_rows, shear_table

# kernel launches and plain-version calls made by each wrapper
LAUNCHES = {"fullprob_fwd": 0, "fullprob_bwd": 0,
            "fullprob_fwd_fanin": 0, "fullprob_bwd_fanin": 0}
PLAIN_CALLS = dict(LAUNCHES)
# the linear entry points' launches of their cluster build (counted in
# LAUNCHES as well)
CLUSTER_LAUNCHES = {"fullprob_fwd": 0, "fullprob_bwd": 0}

# kernels D's and E's launch plans: the fewest ring diagonals worth
# keeping on chip in a split ring (the two newest make almost every
# read), and the largest fan-in with a templated build
MIN_HOT = 3
TEMPLATE_K = 4

# kernels D's and E's linear cluster build (csrc/fullprob_fwd.cu and
# fullprob_bwd.cu, item 6): the first width it takes from the lane
# builds, the largest cluster the H100 schedules portably and the
# largest with the non-portable opt-in: the two cluster sizes a plan
# picks (the kernels take any size from 2 to 16;
# tools/bench_fullprob.py --giant --clusters forces the others)
CLUSTER_FROM = 2049
CLUSTER_PORTABLE = 8
CLUSTER_MAX = 16
CLUSTER_SIZES = (CLUSTER_PORTABLE, CLUSTER_MAX)

# exp() argument clip of the fan-in backward seed (the reference's
# log(f32 max) - 2, rounded to f32)
EXP_CLIP = float(np.float32(np.log(np.finfo(np.float32).max) - 2.0))


def _match_table(inp, dev):
    """(L, R) f32 match probabilities of one job on `dev`, gathered from
    the model's score table by the two state vectors."""
    score = torch.from_numpy(np.ascontiguousarray(inp["score"],
                                                  np.float32)).to(dev)
    nf = score.shape[0]
    # the start site's state is -1: index the table as numpy does
    ls = torch.from_numpy(np.mod(inp["lstates"], nf).astype(np.int64))
    rs = torch.from_numpy(np.mod(inp["rstates"], nf).astype(np.int64))
    return score[ls.to(dev)][:, rs.to(dev)]


def _consts(inputs, dev, seed_key=None):
    c = np.zeros((len(inputs), 8), np.float32)
    for b, inp in enumerate(inputs):
        c[b, :5] = inp["consts"]
        if seed_key is not None:
            c[b, 5] = inp[seed_key]
        c[b, 6] = EXP_CLIP
    return torch.from_numpy(c).to(dev)


def _iscal(inputs, dev):
    return torch.from_numpy(np.array([[p["L"], p["R"]] for p in inputs],
                                     np.int32)).to(dev)


def linear_batch_args(inputs: list, device, Lp: int | None = None,
                      D: int | None = None):
    """Arguments of the linear entry points for a batch of
    fullprob.linear_fullprob_inputs dicts: the match probabilities
    folded once for both fills as (msp * wl[i]) * wr[j] and sheared on
    the device."""
    dev = torch.device(device)
    Lp = Lp or batch_rows(inputs)
    D = max(D or max(p["L"] + p["R"] - 1 for p in inputs), 2)
    ms2 = torch.empty((len(inputs), D, Lp), dtype=torch.float32, device=dev)
    for b, inp in enumerate(inputs):
        wl = torch.from_numpy(np.asarray(inp["wl"], np.float32)).to(dev)
        wr = torch.from_numpy(np.asarray(inp["wr"], np.float32)).to(dev)
        tab = (_match_table(inp, dev) * wl[:, None]) * wr[None, :]
        ms2[b] = shear_table(tab, Lp, D)
    return dict(ms2=ms2, consts=_consts(inputs, dev, "seed"),
                iscal=_iscal(inputs, dev))


def fanin_batch_args(inputs: list, device, Lp: int | None = None,
                     D: int | None = None, G: int | None = None):
    """(forward kwargs, backward kwargs) of the fan-in entry points for a
    batch of fullprob.fanin_fullprob_inputs dicts. Edge-slot axes, the
    seed depth and the ring depth pad to the batch maxima with inert
    zero slots. The right side's slot arrays stay indexed by site j: the
    fills read them at j = d - i. A dict that already holds its sheared
    match table as "msp_sh" (D, Lp) is taken as it is."""
    dev = torch.device(device)
    B = len(inputs)
    Lp = Lp or batch_rows(inputs)
    Rr = max(p["R"] for p in inputs)
    D = max(D or max(p["L"] + p["R"] - 1 for p in inputs), 2)
    G = G or max(p["OLm"] + p["ORm"] for p in inputs)
    Gs = max(p["seed_block"].shape[0] for p in inputs)

    def slots(off_key, w_key, n_key, rows):
        K = max(p[off_key].shape[1] for p in inputs)
        off = np.zeros((B, rows, K), np.int32)
        w = np.zeros((B, rows, K), np.float32)
        for b, p in enumerate(inputs):
            n, k = p[n_key], p[off_key].shape[1]
            off[b, :n, :k] = p[off_key][:n]
            w[b, :n, :k] = p[w_key][:n]
        return torch.from_numpy(off).to(dev), torch.from_numpy(w).to(dev)

    msp = torch.empty((B, D, Lp), dtype=torch.float32, device=dev)
    seed = np.zeros((B, Gs, Lp), np.float32)
    for b, p in enumerate(inputs):
        msp[b] = torch.from_numpy(np.asarray(p["msp_sh"], np.float32)) \
            if "msp_sh" in p else shear_table(_match_table(p, dev), Lp, D)
        sb = p["seed_block"]
        seed[b, :sb.shape[0], :sb.shape[1]] = sb
    consts = _consts(inputs, dev)
    iscal = _iscal(inputs, dev)
    loff, lw = slots("loffp", "lwp", "L", Lp)
    roff, rw = slots("roffp", "rwp", "R", Rr)
    lfoff, lfw = slots("lfoff", "lfw", "L", Lp)
    rfoff, rfw = slots("rfoff", "rfw", "R", Rr)
    fwd = dict(msp=msp, loff=loff, lw=lw, roff=roff, rw=rw, consts=consts,
               iscal=iscal, G=int(G))
    bwd = dict(msp=msp, lfoff=lfoff, lfw=lfw, rfoff=rfoff, rfw=rfw,
               consts=consts, iscal=iscal,
               seed=torch.from_numpy(seed).to(dev), G=int(G))
    return fwd, bwd


# ----------------------------------------------------------------------
def _check(named, ref_name):
    """dtype, shape, contiguity and device of every argument; named is
    [(name, tensor, dtype, shape)]."""
    ref = dict((n, t) for n, t, _d, _s in named)[ref_name]
    for name, t, dt, shape in named:
        if t.dtype != dt:
            raise TypeError("%s must be %s, got %s" % (name, dt, t.dtype))
        if tuple(t.shape) != tuple(shape):
            raise ValueError("%s must have shape %s, got %s"
                             % (name, tuple(shape), tuple(t.shape)))
        if not t.is_contiguous():
            raise ValueError("%s must be contiguous" % name)
        if t.device != ref.device:
            raise ValueError("%s is on %s, %s on %s"
                             % (name, t.device, ref_name, ref.device))
    if ref.device.type not in ("cpu", "cuda"):
        raise ValueError("unsupported device %s" % ref.device)


def _check_linear(ms2, consts, iscal):
    if ms2.dim() != 3:
        raise ValueError("ms2 must be (B, D, Lp)")
    B, D, Lp = ms2.shape
    _check([("ms2", ms2, torch.float32, (B, D, Lp)),
            ("consts", consts, torch.float32, (B, 8)),
            ("iscal", iscal, torch.int32, (B, 2))], "ms2")
    return B, D, Lp


def _check_fanin(msp, loff, lw, roff, rw, consts, iscal, G, seed=None):
    if msp.dim() != 3 or loff.dim() != 3 or roff.dim() != 3:
        raise ValueError("msp must be (B, D, Lp), the slot arrays "
                         "(B, rows, K)")
    B, D, Lp = msp.shape
    KL, Rr, KR = loff.shape[2], roff.shape[1], roff.shape[2]
    named = [("msp", msp, torch.float32, (B, D, Lp)),
             ("loff", loff, torch.int32, (B, Lp, KL)),
             ("lw", lw, torch.float32, (B, Lp, KL)),
             ("roff", roff, torch.int32, (B, Rr, KR)),
             ("rw", rw, torch.float32, (B, Rr, KR)),
             ("consts", consts, torch.float32, (B, 8)),
             ("iscal", iscal, torch.int32, (B, 2))]
    if seed is not None:
        if seed.dim() != 3:
            raise ValueError("seed must be (B, Gs, Lp)")
        named.append(("seed", seed, torch.float32,
                      (B, seed.shape[1], Lp)))
    _check(named, "msp")
    if G < 1:
        raise ValueError("G must be positive (G=%d)" % G)
    return B, D, Lp, Rr, KL, KR


def cluster_build(Lp: int, C: int, rows: int, cell: int):
    """Kernel D's or E's cluster build of C CTAs of `rows` lanes a
    thread on Lp lanes (`cell`: shared bytes a lane, D 32, E 16): the
    lanes split evenly, each CTA's threads whole warps; None where a
    CTA would pass 1024 threads."""
    threads = _block(-(-Lp // C), rows)
    if threads > 1024:
        return None
    return dict(rows=rows, threads=threads, cluster=C,
                smem=cell * (rows * threads + 1))


def _linear_plan(Lp: int, one: int, cell: int) -> dict:
    """How kernel D's or E's linear entry point is launched on Lp lanes
    (`one`: the widest lane build of one lane a thread; `cell`: shared
    bytes a lane of the two diagonals' rows, D 32, E 16):

    - up to CLUSTER_FROM - 1 (2,048) lanes a lane build: one block a
      pair of whole warps, one lane a thread up to `one` lanes, else
      two, each lane's raw M, X, Y in registers; cluster 0;
    - past that the cluster build: one thread block cluster of
      `cluster` CTAs a pair (grid cluster B), the lanes split into
      `cluster` ranges of `threads` x `rows` lanes: 8 CTAs (the largest
      portable cluster) of two lanes a thread up to 16,384 lanes, then
      16 (the non-portable size, which the kernel asks the card to
      schedule and refuses where it cannot) of two lanes up to 32,768
      and of four up to 65,536. Past 65,536 lanes no build holds the
      lanes in registers: ValueError (the planes of such a pair, about
      56 L^2 bytes with both fills and the match values, pass any
      card's memory anyway);
    - smem: the rows of the two newest diagonals, `cell` bytes a lane of
      the block or CTA and one more (the slot of the neighbour's lane
      in a cluster).

    On the H100 (tools/bench_fullprob.py --lanes, --giant --clusters;
    PERF.md) the cluster build beat the lane builds at 2,016 lanes
    (2-5%) and four lanes a thread on one block at 2,112 to 4,032 lanes
    (7-40%), and lost at 1,536 (11-14%); two lanes a thread beat four
    but for D at 16 CTAs (by 1.5%), and 8 CTAs came within 3-5% of 16
    where both hold two lanes a thread."""
    if Lp < CLUSTER_FROM:
        rows = 1 if Lp <= one else 2
        return dict(rows=rows, threads=_block(Lp, rows), cluster=0,
                    smem=cell * (Lp + 1))
    C = CLUSTER_PORTABLE if Lp <= CLUSTER_PORTABLE * 2048 else CLUSTER_MAX
    plan = cluster_build(Lp, C, 2 if Lp <= C * 2048 else 4, cell)
    if plan is None:
        raise ValueError("kernels D and E take at most %d lanes (%d x 1024 "
                         "threads x 4 lanes), not %d"
                         % (CLUSTER_MAX * 4096, CLUSTER_MAX, Lp))
    return plan


def bwd_linear_plan(Lp: int) -> dict:
    """How kernel E's linear entry point is launched on Lp lanes
    (_linear_plan: one lane a thread up to 512 lanes; shared memory
    holds the X and q rows of two diagonals, 16 bytes a lane)."""
    return _linear_plan(Lp, 512, 16)


def fwd_linear_plan(Lp: int) -> dict:
    """How kernel D's linear entry point is launched on Lp lanes
    (_linear_plan; shared memory holds the raw (M, X, Y) rows of the two
    newest diagonals, 32 bytes a lane). One lane a thread only up to 128
    lanes, unlike E: on the H100 (tools/bench_fullprob.py --lanes) D's
    step took 9-12% longer with two lanes a thread than with one at 128
    lanes, but 9% less at 256, 3-7% less at 512 (two calls) and 18-42%
    less at 544 and 1,024, and two beat four by 7% at 2,016 lanes."""
    return _linear_plan(Lp, 128, 32)


def _fanin_plan(Lp: int, G: int, KL: int, KR: int, Rr: int,
                cell: int) -> dict:
    """How kernel D's or E's fan-in entry point is launched on Lp lanes,
    ring depth G, fan-in KL x KR (the slots each kernel reads: D the
    backward edges, E the forward edges), Rr right-site rows and `cell`
    ring bytes a lane and diagonal (D 16, E 12):

    - rtab: the right-site slot table (8 KR Rr bytes) is copied to
      shared memory when it fits beside MIN_HOT ring diagonals, or
      alone where not even those fit (else it is read from device
      memory; on the H100 the copy took 0.4 us off E's 3 us step);
    - placement and hot: "shared" keeps all G + 1 ring diagonals of
      three matrices (cell Lp bytes each) in shared memory (hot = G + 1);
      "hot" keeps the newest hot >= MIN_HOT there and every diagonal
      also in a global ring; "global" keeps none on chip (hot = 0). On
      the H100 a ring of 3 hot diagonals took the same time as one of
      11 for E: offsets 1 and 2 make almost every read;
    - KL, KR: the templated build (the fan-in itself up to TEMPLATE_K on
      both sides, else 0, 0: runtime K);
    - rows: lanes a thread, raw values in registers: 2 in blocks of up
      to 768 threads (384 for a templated fan-in past 2 x 2, whose
      unrolled slot loops spilled registers at 512 in E); for a
      templated fan-in up to 2 x 2 then 4 in blocks of up to 512; past
      that 0, the runtime-K build for any count, whose raw values wait
      in the ring (blocks of up to 1024 threads). On the H100 both
      kernels' lane builds were timed: E's four lanes 1.35-1.5x faster
      than the build for any count at 2,016 and 2,048 lanes; D's
      (tools/bench_fullprob.py --lanes, K 1/2 and 2/2) 1.18-1.25x at
      2,016, and D's two lanes templated 1.3-1.45x faster than four or
      than either runtime-K build from 128 to 1,536 lanes;
    - threads: ceil(Lp / rows) rounded up to a warp;
    - smem: dynamic shared bytes (two rows of 32 warp maxima, G + 1
      inverse scales, the hot ring, the table), at most SHARED_BYTES."""
    GR = G + 1
    fixed = 4 * (64 + GR)
    table = 8 * KR * Rr
    least = cell * Lp * min(GR, MIN_HOT)
    if fixed + least > SHARED_BYTES:
        least = 0
    rtab = fixed + table + least <= SHARED_BYTES
    if rtab:
        fixed += table
    hot = min(GR, max(SHARED_BYTES - fixed, 0) // (cell * Lp))
    if hot < min(GR, MIN_HOT):
        hot = 0
    placement = "shared" if hot == GR else "hot" if hot else "global"
    kl, kr = (KL, KR) if max(KL, KR) <= TEMPLATE_K else (0, 0)
    small_k = kl > 0 and max(kl, kr) <= 2
    two = 768 if max(kl, kr) <= 2 else 384
    if Lp <= 2 * two:
        rows, threads = 2, _block(Lp, 2)
    elif small_k and Lp <= 4 * 512:
        rows, threads = 4, _block(Lp, 4)
    else:
        kl = kr = rows = 0
        threads = min(1024, _block(Lp, 1))
    return dict(KL=kl, KR=kr, rows=rows, threads=threads,
                placement=placement, hot=hot, rtab=rtab,
                smem=fixed + cell * Lp * hot)


def bwd_fanin_plan(Lp: int, G: int, KL: int, KR: int, Rr: int) -> dict:
    """How kernel E's fan-in entry point is launched on Lp lanes, ring
    depth G (its ring: rows of q, X, Y, 12 bytes a lane), forward-edge
    fan-in KL x KR and Rr right-site rows (_fanin_plan)."""
    return _fanin_plan(Lp, G, KL, KR, Rr, 12)


def fwd_fanin_plan(Lp: int, G: int, KL: int, KR: int, Rr: int) -> dict:
    """How kernel D's fan-in entry point is launched on Lp lanes, ring
    depth G (its ring: raw (M, X, Y, 0), 16 bytes a lane), backward-edge
    fan-in KL x KR and Rr right-site rows (_fanin_plan)."""
    return _fanin_plan(Lp, G, KL, KR, Rr, 16)


def _launch_linear(name, plan, ms2, consts, iscal):
    """One launch of kernel D's or E's linear entry point (`name`) as
    `plan` (fwd_linear_plan, bwd_linear_plan) says. A cluster build is
    launched only where the card can schedule one such cluster (the
    kernel asks cudaOccupancyMaxActiveClusters first); any refusal
    raises."""
    B, D, Lp = ms2.shape
    fn = getattr(kernels.load(name), name + "_linear_launch")
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 7 + \
        [ctypes.c_void_p]
    planes = torch.empty((B, 3, D, Lp), dtype=torch.float32,
                         device=ms2.device)
    cum = torch.empty((B, D), dtype=torch.float32, device=ms2.device)
    with torch.cuda.device(ms2.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(ms2.data_ptr(), consts.data_ptr(), iscal.data_ptr(),
                 planes.data_ptr(), cum.data_ptr(), B, D, Lp, plan["rows"],
                 plan["cluster"], plan["threads"], plan["smem"], stream)
    kernels.check(err, name if not plan["cluster"] else
                  "%s (cluster of %d CTAs x %d threads x %d lanes)"
                  % (name, plan["cluster"], plan["threads"], plan["rows"]))
    if plan["cluster"]:
        CLUSTER_LAUNCHES[name] += 1
    return planes, cum


def linear_clusters(name: str, plan: dict) -> int:
    """How many clusters of `plan`'s cluster build of kernel D
    ("fullprob_fwd") or E ("fullprob_bwd") the card holds at once
    (cudaOccupancyMaxActiveClusters; 0: it cannot schedule one). Raises
    on a refused query."""
    fn = getattr(kernels.load(name), name + "_linear_clusters")
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_int] * 4
    n = fn(plan["rows"], plan["cluster"], plan["threads"], plan["smem"])
    if n < 0:
        kernels.check(-n, name + " (cluster query)")
    return n


def fullprob_fwd(ms2, consts, iscal):
    """Scaled forward planes of a batch of linear-chain pairs. ms2
    (B, D, Lp) f32: (msp * wl) * wr on diagonal d at row d. Returns
    (planes (B, 3, D, Lp), cum (B, D)).

    On a CUDA tensor it launches kernel D as fwd_linear_plan(Lp) says:
    one block a pair (a lane build) or, past CLUSTER_FROM - 1 lanes, one
    thread block cluster a pair, each thread owning `rows` lanes in
    registers and the rows of the two newest diagonals in shared memory.
    The kernel refuses a plan it has no build for or a cluster the card
    cannot schedule, and the wrapper raises on any launch error."""
    _check_linear(ms2, consts, iscal)
    if ms2.device.type == "cpu":
        PLAIN_CALLS["fullprob_fwd"] += 1
        return fullprob_fwd_plain(ms2, consts, iscal)
    out = _launch_linear("fullprob_fwd", fwd_linear_plan(ms2.shape[2]), ms2,
                         consts, iscal)
    LAUNCHES["fullprob_fwd"] += 1
    return out


def fullprob_bwd(ms2, consts, iscal):
    """Scaled backward planes of a batch of linear-chain pairs; the
    corner seed consts[:, 5] enters M at diagonal L + R - 2, lane L - 1.
    Returns (planes (B, 3, D, Lp), cum (B, D)).

    On a CUDA tensor it launches kernel E as bwd_linear_plan(Lp) says:
    one block a pair (a lane build) or, past CLUSTER_FROM - 1 lanes, one
    thread block cluster a pair, each thread owning `rows` lanes in
    registers and the X and q rows of two diagonals in shared memory.
    The kernel refuses a plan it has no build for or a cluster the card
    cannot schedule, and the wrapper raises on any launch error."""
    _check_linear(ms2, consts, iscal)
    if ms2.device.type == "cpu":
        PLAIN_CALLS["fullprob_bwd"] += 1
        return fullprob_bwd_plain(ms2, consts, iscal)
    out = _launch_linear("fullprob_bwd", bwd_linear_plan(ms2.shape[2]), ms2,
                         consts, iscal)
    LAUNCHES["fullprob_bwd"] += 1
    return out


def _launch_fanin(name, plan, ring, msp, loff, lw, roff, rw, consts,
                  iscal, G, seed=None):
    """One launch of kernel D's or E's fan-in entry point (`name`) as
    `plan` (fwd_fanin_plan, bwd_fanin_plan) says; loff/lw, roff/rw: the
    slots the kernel reads (D the backward edges, E the forward ones);
    `ring`: the shape of a pair's global ring where the plan keeps not
    all of it on chip; `seed` (kernel E): the seed block."""
    B, D, Lp = msp.shape
    Rr, KL, KR = roff.shape[1], loff.shape[2], roff.shape[2]
    ins = [msp, loff, lw, roff, rw, consts, iscal]
    depth = []
    if seed is not None:
        ins.append(seed)
        depth.append(seed.shape[1])
    fn = getattr(kernels.load(name), name + "_fanin_launch")
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * (len(ins) + 3) + \
        [ctypes.c_int] * (14 + len(depth)) + [ctypes.c_void_p]
    planes = torch.empty((B, 3, D, Lp), dtype=torch.float32,
                         device=msp.device)
    cum = torch.empty((B, D), dtype=torch.float32, device=msp.device)
    gring = None if plan["placement"] == "shared" else torch.empty(
        (B,) + ring, dtype=torch.float32, device=msp.device)
    with torch.cuda.device(msp.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(*[t.data_ptr() for t in ins], planes.data_ptr(),
                 cum.data_ptr(), 0 if gring is None else gring.data_ptr(),
                 B, D, Lp, Rr, KL, KR, G, *depth, plan["hot"],
                 int(plan["rtab"]), plan["KL"], plan["KR"], plan["rows"],
                 plan["threads"], plan["smem"], stream)
    kernels.check(err, name + " (fan-in)")
    return planes, cum


def fullprob_fwd_fanin(msp, loff, lw, roff, rw, consts, iscal, G: int):
    """Scaled forward planes of a batch of fan-in graph pairs. msp
    (B, D, Lp) sheared match probabilities; loff/lw (B, Lp, KL) and
    roff/rw (B, Rr, KR): per site the offsets (0 = empty slot) and
    weights of its backward edges; G the ring depth (no offset sum past
    it is followed). Returns (planes (B, 3, D, Lp), cum (B, D)).

    On a CUDA tensor it launches kernel D as fwd_fanin_plan(Lp, G, KL,
    KR, Rr) says: the (KL, KR) build up to 4 x 4, else the runtime-K
    one; the right-slot table in shared memory when it fits; the ring of
    G + 1 diagonals in shared memory, its newest diagonals there and all
    of it in a global scratch (B, G + 1, Lp, 4), or all of it there; one
    block a pair of the plan's threads, each owning `rows` lanes. The
    kernel refuses a plan it has no build for, and the wrapper raises on
    any launch error."""
    _check_fanin(msp, loff, lw, roff, rw, consts, iscal, G)
    if msp.device.type == "cpu":
        PLAIN_CALLS["fullprob_fwd_fanin"] += 1
        return fullprob_fwd_fanin_plain(msp, loff, lw, roff, rw, consts,
                                        iscal, G)
    Lp = msp.shape[2]
    plan = fwd_fanin_plan(Lp, G, loff.shape[2], roff.shape[2], roff.shape[1])
    out = _launch_fanin("fullprob_fwd", plan, (G + 1, Lp, 4), msp, loff, lw,
                        roff, rw, consts, iscal, G)
    LAUNCHES["fullprob_fwd_fanin"] += 1
    return out


def fullprob_bwd_fanin(msp, lfoff, lfw, rfoff, rfw, consts, iscal, seed,
                       G: int):
    """Scaled backward planes of a batch of fan-in graph pairs.
    lfoff/lfw (B, Lp, KFL) and rfoff/rfw (B, Rr, KFR): per site the
    offsets and weights of its FORWARD edges (those into the stop site
    left out); seed (B, Gs, Lp): row g holds the corner seeds of
    diagonal L + R - 2 - g in true units. Returns (planes, cum).

    On a CUDA tensor it launches kernel E as bwd_fanin_plan(Lp, G, KFL,
    KFR, Rr) says: the (KFL, KFR) build up to 4 x 4, else the runtime-K
    one; the right-slot table in shared memory when it fits; the ring of
    G + 1 diagonals in shared memory, its newest diagonals there and all
    of it in a global scratch (B, 3, G + 1, Lp), or all of it there; one
    block a pair of the plan's threads, each owning `rows` lanes. The
    kernel refuses a plan it has no build for, and the wrapper raises on
    any launch error."""
    _check_fanin(msp, lfoff, lfw, rfoff, rfw, consts, iscal, G, seed)
    if msp.device.type == "cpu":
        PLAIN_CALLS["fullprob_bwd_fanin"] += 1
        return fullprob_bwd_fanin_plain(msp, lfoff, lfw, rfoff, rfw,
                                        consts, iscal, seed, G)
    Lp = msp.shape[2]
    plan = bwd_fanin_plan(Lp, G, lfoff.shape[2], rfoff.shape[2],
                          rfoff.shape[1])
    out = _launch_fanin("fullprob_bwd", plan, (3, G + 1, Lp), msp, lfoff,
                        lfw, rfoff, rfw, consts, iscal, G, seed)
    LAUNCHES["fullprob_bwd_fanin"] += 1
    return out


# ----------------------------------------------------------------------
# plain PyTorch versions: a loop over diagonals of (B, Lp) operations
# ----------------------------------------------------------------------
def _setup(t, consts, iscal):
    B, D, Lp = t.shape
    dev = t.device
    c = [consts[:, k:k + 1] for k in range(5)]
    L = iscal[:, 0:1].long()
    R = iscal[:, 1:2].long()
    ii = torch.arange(Lp, device=dev)[None, :]
    planes = torch.zeros((B, 3, D, Lp), dtype=torch.float32, device=dev)
    cums = torch.zeros((B, D), dtype=torch.float32, device=dev)
    zero = torch.zeros((B, Lp), dtype=torch.float32, device=dev)
    return B, D, Lp, c, L, R, ii, planes, cums, zero


def _rescale(M, X, Y):
    """Divide a diagonal by its maximum (1 where that is 0); returns the
    scaled rows, 1/max and log(max)."""
    sc = torch.maximum(torch.maximum(M, X), Y).amax(dim=1, keepdim=True)
    sc = torch.where(sc > 0, sc, torch.ones_like(sc))
    inv = torch.reciprocal(sc)
    return M * inv, X * inv, Y * inv, inv, torch.log(sc)


def _shift_r(v):
    """Lane i reads lane i - 1; lane 0 reads 0."""
    return torch.cat([torch.zeros_like(v[:, :1]), v[:, :-1]], dim=1)


def _shift_l(v):
    """Lane i reads lane i + 1; the last lane reads 0."""
    return torch.cat([v[:, 1:], torch.zeros_like(v[:, :1])], dim=1)


def fullprob_fwd_plain(ms2, consts, iscal):
    """Plain PyTorch version of kernel D's linear entry point."""
    B, D, Lp, (ext, gcgo, nggo, ng2, gcng), L, R, ii, planes, cums, zero \
        = _setup(ms2, consts, iscal)
    m1 = zero.clone()
    m1[:, 0] = 1.0
    x1, y1, m2, x2, y2 = zero, zero, zero, zero, zero
    planes[:, 0, 0] = m1
    cum = torch.zeros((B, 1), dtype=torch.float32, device=ms2.device)
    for d in range(1, D):
        jj = d - ii
        valid = (jj >= 0) & (jj < R) & (ii < L)
        X = ext * _shift_r(x1) + gcgo * _shift_r(y1) + nggo * _shift_r(m1)
        X = torch.where(valid & (ii > 0), X, zero)
        Y = ext * y1 + gcgo * x1 + nggo * m1
        Y = torch.where(valid & (jj > 0), Y, zero)
        M = ms2[:, d] * (ng2 * _shift_r(m2) + gcng * _shift_r(x2)
                         + gcng * _shift_r(y2))
        M = torch.where(valid & (ii > 0) & (jj > 0), M, zero)
        M, X, Y, inv, lg = _rescale(M, X, Y)
        cum = cum + lg
        planes[:, 0, d], planes[:, 1, d], planes[:, 2, d] = M, X, Y
        cums[:, d] = cum[:, 0]
        m2, x2, y2 = m1 * inv, x1 * inv, y1 * inv
        m1, x1, y1 = M, X, Y
    return planes, cums


def fullprob_bwd_plain(ms2, consts, iscal):
    """Plain PyTorch version of kernel E's linear entry point."""
    B, D, Lp, (ext, gcgo, nggo, ng2, gcng), L, R, ii, planes, cums, zero \
        = _setup(ms2, consts, iscal)
    seed = consts[:, 5:6]
    corner_d = L + R - 2
    x1, y1, q1, q2 = zero, zero, zero, zero
    cum = torch.zeros((B, 1), dtype=torch.float32, device=ms2.device)
    for d in range(D - 1, -1, -1):
        jj = d - ii
        valid = (jj >= 0) & (jj < R) & (ii < L)
        xnb = _shift_l(x1)                 # bX at (i + 1, j)
        ynb = y1                           # bY at (i, j + 1)
        T = _shift_l(q2)                   # bM * ms2 at (i + 1, j + 1)
        X = ext * xnb + gcgo * ynb + gcng * T
        Y = ext * ynb + gcgo * xnb + gcng * T
        M = nggo * xnb + nggo * ynb + ng2 * T
        # corner seed in true units: cum is exactly 0 above the corner
        M = M + torch.where((corner_d == d) & (ii == L - 1), seed, zero)
        X = torch.where(valid, X, zero)
        Y = torch.where(valid, Y, zero)
        M = torch.where(valid, M, zero)
        M, X, Y, inv, lg = _rescale(M, X, Y)
        q = M * ms2[:, d]
        cum = cum + lg
        planes[:, 0, d], planes[:, 1, d], planes[:, 2, d] = M, X, Y
        cums[:, d] = cum[:, 0]
        q2 = q1 * inv
        q1 = q
        x1, y1 = X, Y
    return planes, cums


def _ring_read(ring, g, lane, ok):
    """Rows (B, 3, Lp) of a (B, 3, G, Lp) ring at ring slot g, lane
    `lane` (both (B, Lp), read where ok; 0 elsewhere)."""
    B, _three, G, Lp = ring.shape
    flat = g.clamp(0, G - 1) * Lp + lane.clamp(0, Lp - 1)
    vals = ring.reshape(B, 3, G * Lp).gather(
        2, flat[:, None, :].expand(B, 3, Lp))
    return torch.where(ok[:, None, :], vals, torch.zeros_like(vals))


def _ring_push(ring, rows, inv):
    """The newest diagonal enters slot 0; the older ones move back one
    slot, rescaled to the newest one's units."""
    return torch.cat([torch.stack(rows, dim=1)[:, :, None],
                      ring[:, :, :-1] * inv[:, :, None, None]], dim=2)


def _site_slots(off, w, rows):
    """Per-lane slot arrays (B, Lp, K) of the right side on one
    diagonal: site j = rows (B, Lp), clamped (callers mask)."""
    bidx = torch.arange(off.shape[0], device=off.device)[:, None]
    jc = rows.clamp(0, off.shape[1] - 1)
    return off[bidx, jc].long(), w[bidx, jc]


def fullprob_fwd_fanin_plain(msp, loff, lw, roff, rw, consts, iscal,
                             G: int):
    """Plain PyTorch version of kernel D's fan-in entry point: ring[g]
    holds diagonal d - 1 - g in the units of diagonal d - 1."""
    B, D, Lp, (ext, gcgo, nggo, ng2, gcng), L, R, ii, planes, cums, zero \
        = _setup(msp, consts, iscal)
    KL, KR = loff.shape[2], roff.shape[2]
    oL = loff.long()
    ring = torch.zeros((B, 3, G, Lp), dtype=torch.float32,
                       device=msp.device)
    ring[:, 0, 0, 0] = 1.0
    planes[:, 0, 0, 0] = 1.0
    cum = torch.zeros((B, 1), dtype=torch.float32, device=msp.device)
    for d in range(1, D):
        jj = d - ii
        inside = (jj >= 0) & (jj < R)
        valid = inside & (ii < L)
        oR, wR = _site_slots(roff, rw, jj)
        X = zero
        for k in range(KL):
            o = oL[:, :, k]
            ok = (o > 0) & (o <= G) & (ii - o >= 0)
            v = _ring_read(ring, o - 1, ii - o, ok)
            X = X + (ext * v[:, 1] + gcgo * v[:, 2] + nggo * v[:, 0])
        Y = zero
        for k in range(KR):
            o = oR[:, :, k]
            ok = inside & (o > 0) & (o <= G)
            v = _ring_read(ring, o - 1, ii.expand(B, Lp), ok)
            Y = Y + (ext * v[:, 2] + gcgo * v[:, 1] + nggo * v[:, 0])
        S = zero
        for kl in range(KL):
            ol = oL[:, :, kl]
            for kr in range(KR):
                ot = ol + oR[:, :, kr]
                ok = inside & (ol > 0) & (oR[:, :, kr] > 0) & (ot <= G) \
                    & (ii - ol >= 0)
                v = _ring_read(ring, ot - 1, ii - ol, ok)
                combo = ng2 * v[:, 0] + gcng * v[:, 1] + gcng * v[:, 2]
                S = S + combo * lw[:, :, kl] * wR[:, :, kr]
        M = msp[:, d] * S
        X = torch.where(valid & (ii > 0), X, zero)
        Y = torch.where(valid & (jj > 0), Y, zero)
        M = torch.where(valid & (ii > 0) & (jj > 0), M, zero)
        M, X, Y, inv, lg = _rescale(M, X, Y)
        ring = _ring_push(ring, (M, X, Y), inv)
        cum = cum + lg
        planes[:, 0, d], planes[:, 1, d], planes[:, 2, d] = M, X, Y
        cums[:, d] = cum[:, 0]
    return planes, cums


def fullprob_bwd_fanin_plain(msp, lfoff, lfw, rfoff, rfw, consts, iscal,
                             seed, G: int):
    """Plain PyTorch version of kernel E's fan-in entry point: ring[g]
    holds (q = bM * msp, bX, bY) of diagonal d + 1 + g in the units of
    diagonal d + 1."""
    B, D, Lp, (ext, gcgo, nggo, ng2, gcng), L, R, ii, planes, cums, zero \
        = _setup(msp, consts, iscal)
    KFL, KFR = lfoff.shape[2], rfoff.shape[2]
    Gs = seed.shape[1]
    clim = consts[:, 6:7]
    corner_d = L + R - 2
    oL = lfoff.long()
    bidx = torch.arange(B, device=msp.device)[:, None]
    ring = torch.zeros((B, 3, G, Lp), dtype=torch.float32,
                       device=msp.device)
    cum = torch.zeros((B, 1), dtype=torch.float32, device=msp.device)
    for d in range(D - 1, -1, -1):
        jj = d - ii
        inside = (jj >= 0) & (jj < R)
        valid = inside & (ii < L)
        oR, wR = _site_slots(rfoff, rfw, jj)
        A = zero                           # bX at (i + o, j)
        for k in range(KFL):
            o = oL[:, :, k]
            ok = (o > 0) & (o <= G) & (ii + o < Lp)
            A = A + _ring_read(ring, o - 1, ii + o, ok)[:, 1]
        Bs = zero                          # bY at (i, j + o)
        for k in range(KFR):
            o = oR[:, :, k]
            ok = inside & (o > 0) & (o <= G)
            Bs = Bs + _ring_read(ring, o - 1, ii.expand(B, Lp), ok)[:, 2]
        T = zero                           # q at (i + s, j + r), weighted
        for kl in range(KFL):
            ol = oL[:, :, kl]
            for kr in range(KFR):
                ot = ol + oR[:, :, kr]
                ok = inside & (ol > 0) & (oR[:, :, kr] > 0) & (ot <= G) \
                    & (ii + ol < Lp)
                v = _ring_read(ring, ot - 1, ii + ol, ok)[:, 0]
                T = T + v * lfw[:, :, kl] * wR[:, :, kr]
        X = ext * A + gcgo * Bs + gcng * T
        Y = ext * Bs + gcgo * A + gcng * T
        M = nggo * A + nggo * Bs + ng2 * T
        # seeds are in true units; below the corner diagonal the running
        # scale is no longer 0, so convert
        idx = corner_d - d                                   # (B, 1)
        srow = seed[bidx, idx.clamp(0, Gs - 1)][:, 0]        # (B, Lp)
        srow = torch.where((idx >= 0) & (idx < Gs), srow, zero)
        M = M + srow * torch.exp(-torch.minimum(torch.maximum(cum, -clim),
                                                clim))
        X = torch.where(valid, X, zero)
        Y = torch.where(valid, Y, zero)
        M = torch.where(valid, M, zero)
        M, X, Y, inv, lg = _rescale(M, X, Y)
        ring = _ring_push(ring, (M * msp[:, d], X, Y), inv)
        cum = cum + lg
        planes[:, 0, d], planes[:, 1, d], planes[:, 2, d] = M, X, Y
        cums[:, d] = cum[:, 0]
    return planes, cums


# ----------------------------------------------------------------------
def linear_plane_fills(ms2, consts, iscal):
    """Forward and backward fills of one linear batch:
    ((f_planes, fcum), (b_planes, bcum))."""
    kw = dict(ms2=ms2, consts=consts, iscal=iscal)
    return fullprob_fwd(**kw), fullprob_bwd(**kw)


def fanin_plane_fills(fwd_kw, bwd_kw):
    """Forward and backward fills of one fan-in batch."""
    return fullprob_fwd_fanin(**fwd_kw), fullprob_bwd_fanin(**bwd_kw)
