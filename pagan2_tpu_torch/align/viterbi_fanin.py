"""Kernel B: the fan-in (graph-vs-graph) Viterbi wavefront
(csrc/viterbi_fanin.cu), its plain PyTorch version, the prep that feeds
both, and the host finish (end corner + backtrack).

Replaces pagan2_tpu/align/viterbi_pallas_fanin.py (`_kernel` via
`pallas_fanin_run`) AND the XLA scan cores of
pagan2_tpu/align/viterbi_fanin.py (`_build_core_onehot`, `_build_core`):
one kernel with runtime edge offsets, log-weights, fan-in K and ring
depth G, windowed (anchored pairs) or at full width. Candidate order,
f32 add order and codes are the reference's (module docstring of
csrc/viterbi_fanin.cu), so codes and corner snapshots are bit-identical
to the Pallas kernel and to the f32 gather core.

The routing constants below (K_CAP, G_CAP, the Pallas caps inside
scan_core_bound, SCAN_ANCHOR_MIN_SITES) are the JAX package's: they
decide which pairs are anchored, so the port keeps them whatever limits
its own kernel has.

Device rule: a CPU tensor takes `fanin_fill_plain`; a CUDA tensor
launches the kernel or raises.
"""
from __future__ import annotations

import ctypes

import numpy as np
import torch

from .. import kernels
from ..kernels import SHARED_BYTES
from ..graph.sequence_graph import SequenceGraph
from ..models.evol_model import EvolModel
from .settings import AlignSettings, X_MAT, Y_MAT, M_MAT
from .oracle import MatrixPtr, PathPtr
from .viterbi_sheared import _bucket

NEG = -np.inf
_BM_NONE = 65535   # packed uint32 layout: bm | bx<<16 | by<<24
_BX_NONE = 255
_BY_NONE = 255

# routing caps of the JAX package (viterbi_fanin.K_CAP/G_CAP: pairs past
# them run one by one instead of in a batched launch)
K_CAP = 8
G_CAP = 64

# the JAX Pallas fan-in kernel's static caps
# (viterbi_pallas_fanin.OFF_CAP, K_CAP_R, _P_NONE); scan_core_bound
# reads them to lower the anchoring gate exactly as the reference does
OFF_CAP = 7
K_CAP_R = 4
_P_NONE = 255

LAUNCHES = 0          # kernel B launches (one per fanin_fill on CUDA)
PLAIN_CALLS = 0       # fanin_fill_plain calls made by fanin_fill

# kernel B is templated on the fan-in (KL, KR) up to this; a larger
# fan-in launches its runtime-K instantiation
TEMPLATE_K = 4
# the fewest diagonals kept in shared memory when the whole ring does
# not fit: d itself, d - 1 (offset-1 gaps) and d - 2 (offset-2 matches)
MIN_HOT = 3

# anchoring gate for scan-core-bound fan-in pairs (the global
# anchor_min_sites=3000 assumes cheap linear cells); matches the JAX
# package's PileupConfig.anchor_reads_min_sites
SCAN_ANCHOR_MIN_SITES = 200


def scan_core_bound(KL: int, OL: int, KR: int, OR: int) -> bool:
    """True when the JAX package would fill a fan-in pair with these
    stats on its windowed gather scan core instead of its Pallas kernel
    (the Pallas kernel's static caps: 4-bit packed offsets, right slots
    sharing one int32, 8-bit code fields). The reference anchors such
    pairs from SCAN_ANCHOR_MIN_SITES instead of anchor_min_sites; the
    port keeps the predicate as it is, whatever its own kernel can take,
    so it anchors the same pairs and produces the same alignment. A
    function of the graph alone, never of the backend or batch width."""
    return (OL > OFF_CAP or OR > OFF_CAP or KR > K_CAP_R
            or KL * KR * 3 >= _P_NONE or KL * 3 >= _P_NONE
            or KR * 3 >= _P_NONE)


def effective_anchor_gate(left, right, gate: int) -> int:
    """Per-pair anchoring size gate: `gate` (anchor_min_sites), lowered
    to SCAN_ANCHOR_MIN_SITES when this fan-in pair is statically bound
    to the scan core.  The fanin_stats walks are pure Python, so they
    only run when the lowered gate could actually change the decision
    (SCAN_ANCHOR_MIN_SITES < min(sites) <= gate)."""
    n = min(left.num_sites(), right.num_sites())
    if not (SCAN_ANCHOR_MIN_SITES < n <= gate):
        return gate
    KL, OL = fanin_stats(left)
    KR, OR = fanin_stats(right)
    if scan_core_bound(KL, OL, KR, OR):
        return SCAN_ANCHOR_MIN_SITES
    return gate


def fanin_stats(g: SequenceGraph):
    """(max fan-in K, max bwd-edge offset) over sites 1..N-1 — the
    device-eligibility numbers for this graph."""
    K = 1
    O = 1
    starts = g.edges.start
    for i in range(1, g.num_sites()):
        b = g.bwd[i]
        if len(b) > K:
            K = len(b)
        for e in b:
            o = i - starts[e]
            if o > O:
                O = o
    return K, O


# ----------------------------------------------------------------------
def prepare_fanin(left: SequenceGraph, right: SequenceGraph,
                  model: EvolModel, settings: AlignSettings,
                  dtype=np.float64):
    """Host-side per-job arrays (unpadded; stacking pads to buckets)."""
    L = left.num_sites() - 1
    R = right.num_sites() - 1
    la = left.padded_bwd_arrays()
    ra = right.padded_bwd_arrays()

    m = model
    gext = m.log_gap_ext()
    gend = gext if settings.no_terminal_edges else m.log_gap_end_ext()
    lgo = m.log_gap_open()

    pair_end = bool(settings.pair_end_reads)
    xr1 = settings.x_read1_length if pair_end else -2
    yr1 = settings.y_read1_length if pair_end else -2

    def side(arr, n, read1):
        prev = arr["prev"][:n]
        mask = arr["mask"][:n] & (prev >= 0) & \
            (prev < np.arange(n)[:, None])
        off = np.where(mask, np.arange(n)[:, None] - prev, 0
                       ).astype(np.int32)
        lw = np.where(mask, arr["logw"][:n], 0.0).astype(dtype)
        # open penalty at the predecessor site (basic_alignment.h:490-513)
        op = np.full(prev.shape, lgo, dtype)
        if settings.reduced_terminal_gap_penalties:
            op[prev == 0] = 0.0
            if pair_end and read1 >= 0:
                op[prev == read1] = 0.0
        op = np.where(mask, op, 0.0)
        return off, lw, op

    loff, llw, lopen = side(la, L, xr1)
    roff, rlw, ropen = side(ra, R, yr1)

    gext_i = np.full(L, gext, dtype)
    gext_i[0] = gend
    gext_i[L - 1] = gend
    gext_j = np.full(R, gext, dtype)
    gext_j[0] = gend
    gext_j[R - 1] = gend
    # pair-end break extension overrides the terminal rule at the read1
    # boundary (compute_fwd_scores gap-type priority, oracle.py:267-280)
    if pair_end:
        gbrk = dtype(m.log_gap_break_ext())
        if 0 <= xr1 < L:
            gext_i[xr1] = gbrk
        if 0 <= yr1 < R:
            gext_j[yr1] = gbrk

    lstates = np.asarray(left.states[:L], np.int32)
    rstates = np.asarray(right.states[:R], np.int32)

    KLg, OL = fanin_stats(left)
    KRg, OR = fanin_stats(right)
    return dict(
        L=L, R=R, KL=loff.shape[1], KR=roff.shape[1],
        OL=OL, OR=OR,
        loff=loff, llw=llw, lopen=lopen,
        roff=roff, rlw=rlw, ropen=ropen,
        gext_i=gext_i, gext_j=gext_j,
        lstates=lstates, rstates=rstates,
        leid=la["eid"][:L + 1], lprev=la["prev"][:L + 1],
        reid=ra["eid"][:R + 1], rprev=ra["prev"][:R + 1],
        lng=dtype(m.log_non_gap()), lgo=dtype(lgo),
        gext=dtype(gext), gend=dtype(gend),
        pair_end=pair_end and (xr1 >= 0 or yr1 >= 0),
        log_score=model.log_score.astype(dtype),
    )



# ----------------------------------------------------------------------
def fanin_batch_args(inputs: list, device, W: int | None = None,
                     ilo=None, G: int | None = None, KL: int | None = None,
                     KR: int | None = None, D: int | None = None):
    """Kernel B arguments for a batch of prepare_fanin dicts (f32) on
    `device`. W/ilo: optional band window (shared (D,) starts); default
    full width (W = the longest left side, ilo = 0). G defaults to the
    largest OL + OR, KL/KR to the largest fan-in, D to the largest
    L + R - 1. A prep dict's optional band_upper/band_lower (per left
    row, clipped to [0, R-1]) mask out-of-band cells."""
    dev = torch.device(device)
    B = len(inputs)
    Lr = max(inp["L"] for inp in inputs)
    Rr = max(inp["R"] for inp in inputs)
    KL = KL or max(inp["KL"] for inp in inputs)
    KR = KR or max(inp["KR"] for inp in inputs)
    G = G or max(inp["OL"] + inp["OR"] for inp in inputs)
    D = D or max(inp["L"] + inp["R"] - 1 for inp in inputs)
    W = W or Lr
    nf = inputs[0]["log_score"].shape[0]
    f = np.float32

    lstate = np.zeros((B, Lr), np.int32)
    rstate = np.zeros((B, Rr), np.int32)
    table = np.zeros((B, nf, nf), f)
    loff = np.zeros((B, Lr, KL), np.int32)
    llw = np.zeros((B, Lr, KL), f)
    lopen = np.zeros((B, Lr, KL), f)
    gexti = np.zeros((B, Lr), f)
    bup = np.zeros((B, Lr), np.int32)
    blo = np.zeros((B, Lr), np.int32)
    roff = np.zeros((B, Rr, KR), np.int32)
    rlw = np.zeros((B, Rr, KR), f)
    ropen = np.zeros((B, Rr, KR), f)
    gextj = np.zeros((B, Rr), f)
    ilo_b = np.zeros((B, D), np.int32)
    fscal = np.zeros((B, 2), f)
    iscal = np.zeros((B, 2), np.int32)
    for b, inp in enumerate(inputs):
        L, R = inp["L"], inp["R"]
        kl = inp["loff"].shape[1]
        kr = inp["roff"].shape[1]
        # the start site's state is -1: index the table as numpy does
        # (the reference's TL rows), the value is never used
        lstate[b, :L] = np.mod(inp["lstates"], nf)
        rstate[b, :R] = np.mod(inp["rstates"], nf)
        table[b] = inp["log_score"]
        loff[b, :L, :kl] = inp["loff"]
        llw[b, :L, :kl] = inp["llw"]
        lopen[b, :L, :kl] = inp["lopen"]
        gexti[b, :L] = inp["gext_i"]
        bup[b, :L] = inp.get("band_upper", np.zeros(L))[:L]
        blo[b, :L] = inp.get("band_lower", np.full(L, R - 1))[:L]
        roff[b, :R, :kr] = inp["roff"]
        rlw[b, :R, :kr] = inp["rlw"]
        ropen[b, :R, :kr] = inp["ropen"]
        gextj[b, :R] = inp["gext_j"]
        if ilo is not None:
            ilo_b[b] = np.asarray(ilo, np.int32)[:D]
        fscal[b] = [inp["lng"], inp["lgo"]]
        iscal[b] = [L, R]

    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev)
    return dict(lstate=t(lstate), rstate=t(rstate), table=t(table),
                loff=t(loff), llw=t(llw), lopen=t(lopen), gexti=t(gexti),
                bup=t(bup), blo=t(blo), roff=t(roff), rlw=t(rlw),
                ropen=t(ropen), gextj=t(gextj), ilo=t(ilo_b),
                fscal=t(fscal), iscal=t(iscal), G=int(G), W=int(W))


_ARG_SPEC = [("lstate", torch.int32, 2), ("rstate", torch.int32, 2),
             ("table", torch.float32, 3), ("loff", torch.int32, 3),
             ("llw", torch.float32, 3), ("lopen", torch.float32, 3),
             ("gexti", torch.float32, 2), ("bup", torch.int32, 2),
             ("blo", torch.int32, 2), ("roff", torch.int32, 3),
             ("rlw", torch.float32, 3), ("ropen", torch.float32, 3),
             ("gextj", torch.float32, 2), ("ilo", torch.int32, 2),
             ("fscal", torch.float32, 2), ("iscal", torch.int32, 2)]


def _check_args(args: dict, G: int, W: int):
    ref = args["ilo"]
    for name, dt, nd in _ARG_SPEC:
        t = args[name]
        if t.dtype != dt:
            raise TypeError("%s must be %s, got %s" % (name, dt, t.dtype))
        if t.dim() != nd:
            raise ValueError("%s must have %d dims, got %s"
                             % (name, nd, tuple(t.shape)))
        if not t.is_contiguous():
            raise ValueError("%s must be contiguous" % name)
        if t.device != ref.device:
            raise ValueError("%s is on %s, ilo on %s"
                             % (name, t.device, ref.device))
    if ref.device.type not in ("cpu", "cuda"):
        raise ValueError("unsupported device %s" % ref.device)
    B, D = ref.shape
    Lr = args["lstate"].shape[1]
    Rr = args["rstate"].shape[1]
    KL = args["loff"].shape[2]
    KR = args["roff"].shape[2]
    nf = args["table"].shape[1]
    shapes = dict(lstate=(B, Lr), rstate=(B, Rr), table=(B, nf, nf),
                  loff=(B, Lr, KL), llw=(B, Lr, KL), lopen=(B, Lr, KL),
                  gexti=(B, Lr), bup=(B, Lr), blo=(B, Lr),
                  roff=(B, Rr, KR), rlw=(B, Rr, KR), ropen=(B, Rr, KR),
                  gextj=(B, Rr), ilo=(B, D), fscal=(B, 2), iscal=(B, 2))
    for name, shape in shapes.items():
        if tuple(args[name].shape) != shape:
            raise ValueError("%s must have shape %s, got %s"
                             % (name, shape, tuple(args[name].shape)))
    if G < 1 or W < 1:
        raise ValueError("G and W must be positive (G=%d, W=%d)" % (G, W))
    return B, D, Lr, Rr, KL, KR, nf


def launch_plan(W: int, G: int, KL: int, KR: int, nf: int) -> dict:
    """How kernel B is launched for a window of W rows, ring depth G,
    fan-in KL x KR and an nf x nf match table:

    - KL, KR: the templated instantiation (the fan-in itself up to
      TEMPLATE_K on both sides, else 0, 0: the runtime-K one);
    - placement and hot: "shared" keeps all G + 1 ring diagonals in
      shared memory (hot = G + 1); "hot" keeps the newest hot >= MIN_HOT
      there and every diagonal also in a global ring; "global" keeps
      none on chip (hot = 0);
    - threads: a block of ceil(W / rows) threads rounded up to a warp,
      rows = the window positions per thread: 1 up to W = 512, else at
      least 2, and at most 1024 threads (512 for a templated fan-in
      past 2 x 2, whose staged edge words need the registers);
    - ahead: how many cells ahead a thread stages its inputs (2 in a
      block of at most 256 threads, else 1; the kernel has each of
      these built for its block sizes only, and refuses another plan);
    - smem: dynamic shared bytes (hot ring, table, window-start ring),
      at most SHARED_BYTES."""
    GR = G + 1
    fixed = 4 * (nf * nf + GR)
    if fixed > SHARED_BYTES:
        raise ValueError("kernel B: a %d x %d table and a ring of %d "
                         "diagonals leave no shared memory" % (nf, nf, GR))
    hot = min(GR, (SHARED_BYTES - fixed) // (12 * W))
    if hot < min(GR, MIN_HOT):
        hot = 0
    placement = "shared" if hot == GR else "hot" if hot else "global"
    if KL <= TEMPLATE_K and KR <= TEMPLATE_K:
        kl, kr = KL, KR
    else:
        kl = kr = 0
    max_threads = 1024 if kl <= 2 and kr <= 2 else 512
    # one window position a thread up to 512 rows, at least two beyond
    # (on the H100 the W 640-1024 calls ran faster with two than one)
    rows = 1 if W <= 512 else max(2, -(-W // max_threads))
    threads = -(-W // (rows * 32)) * 32
    return dict(KL=kl, KR=kr, placement=placement, hot=hot,
                threads=threads, rows=rows, ahead=2 if threads <= 256 else 1,
                smem=fixed + 12 * W * hot)


def fanin_fill(lstate, rstate, table, loff, llw, lopen, gexti, bup, blo,
               roff, rlw, ropen, gextj, ilo, fscal, iscal, G: int, W: int):
    """Fill a batch of fan-in pairs (argument layout: fanin_batch_args).
    Returns (bp (B, D, W) int32 holding the uint32 codes
    bm | bx << 16 | by << 24 of cell (ilo[b, d] + t, d - ilo[b, d] - t)
    at [b, d, t], and snaps (B, 3, G, W) f32: M, X, Y of diagonal
    L + R - 2 - g at [b, :, g]).

    On a CUDA tensor it launches kernel B as launch_plan(W, G, KL, KR,
    nf) says: the (KL, KR) instantiation up to 4 x 4, else the runtime-K
    one; the ring in shared memory, its newest diagonals there and all
    of it in a global scratch (B, 3, G + 1, W), or all of it there; a
    block of the plan's threads, each staging its inputs the plan's
    `ahead` cells ahead. The kernel refuses a plan it has no build for,
    and the wrapper raises on any launch error."""
    global LAUNCHES, PLAIN_CALLS
    args = dict(lstate=lstate, rstate=rstate, table=table, loff=loff,
                llw=llw, lopen=lopen, gexti=gexti, bup=bup, blo=blo,
                roff=roff, rlw=rlw, ropen=ropen, gextj=gextj, ilo=ilo,
                fscal=fscal, iscal=iscal)
    B, D, Lr, Rr, KL, KR, nf = _check_args(args, G, W)
    dev = ilo.device
    if dev.type == "cpu":
        PLAIN_CALLS += 1
        return fanin_fill_plain(G=G, W=W, **args)
    lib = kernels.load("viterbi_fanin")
    fn = lib.viterbi_fanin_launch
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * 19 + [ctypes.c_int] * 15 + \
        [ctypes.c_void_p]
    plan = launch_plan(W, G, KL, KR, nf)
    bp = torch.empty((B, D, W), dtype=torch.int32, device=dev)
    snap = torch.empty((B, 3, G, W), dtype=torch.float32, device=dev)
    gring = None if plan["placement"] == "shared" else torch.empty(
        (B, 3, G + 1, W), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(*[args[n].data_ptr() for n, _, _ in _ARG_SPEC],
                 bp.data_ptr(), snap.data_ptr(),
                 0 if gring is None else gring.data_ptr(),
                 B, D, W, G, Lr, Rr, KL, KR, nf, plan["hot"], plan["KL"],
                 plan["KR"], plan["threads"], plan["ahead"], plan["smem"],
                 stream)
    kernels.check(err, "viterbi_fanin")
    LAUNCHES += 1
    return bp, snap


def fanin_fill_plain(lstate, rstate, table, loff, llw, lopen, gexti, bup,
                     blo, roff, rlw, ropen, gextj, ilo, fscal, iscal,
                     G: int, W: int):
    """Plain PyTorch version of kernel B: a loop over diagonals; every
    edge source is gathered from the ring, the candidates are stacked
    in the reference's order and reduced with max + argmax (argmax
    returns the FIRST maximum: the strict-greater first-wins rule), as
    the reference's gather core does."""
    B, D = ilo.shape
    dev = ilo.device
    f = torch.float32
    Lr, Rr = lstate.shape[1], rstate.shape[1]
    KL, KR = loff.shape[2], roff.shape[2]
    nf = table.shape[1]
    GR = G + 1
    neg = torch.tensor(NEG, dtype=f, device=dev)
    ring = torch.full((B, 3, GR * W), NEG, dtype=f, device=dev)
    bp = torch.empty((B, D, W), dtype=torch.int32, device=dev)
    snap = torch.full((B, 3, G, W), NEG, dtype=f, device=dev)
    tt = torch.arange(W, device=dev)[None, :]
    bidx = torch.arange(B, device=dev)[:, None]
    lng2, lgo2 = fscal[:, 0:1], fscal[:, 1:2]
    lng3, lgo3 = lng2[:, :, None], lgo2[:, :, None]
    lng4 = lng3[:, :, :, None]
    L = iscal[:, 0:1].long()
    R = iscal[:, 1:2].long()
    ilo_l = ilo.long()
    tab = table.reshape(B, nf * nf)
    corners = (iscal[:, 0] + iscal[:, 1] - 2).cpu().tolist()

    def src(e, r, ok):
        """(M, X, Y) at diagonal e, global row r (B, W, ...) and the
        mask of sources that exist (ok, in the matrix, in e's window)."""
        shape = e.shape
        e = e.reshape(B, -1)
        r = r.reshape(B, -1)
        rel = r - ilo_l.gather(1, e.clamp(0, D - 1))
        good = ok.reshape(B, -1) & (e >= 0) & (rel >= 0) & (rel < W)
        flat = e.remainder(GR) * W + rel.clamp(0, W - 1)
        vals = ring.gather(2, flat[:, None, :].expand(B, 3, -1))
        vals = torch.where(good[:, None, :], vals, neg)
        vals = vals.reshape((B, 3) + tuple(shape[1:]))
        return vals[:, 0], vals[:, 1], vals[:, 2]

    def best_first(cand):
        # max and the index of its FIRST occurrence (first-wins)
        return cand.amax(-1), cand.argmax(-1)

    for d in range(D):
        ii = ilo_l[:, d:d + 1] + tt                    # (B, W) rows
        jj = d - ii
        ic = ii.clamp(0, Lr - 1)
        jc = jj.clamp(0, Rr - 1)
        valid = (jj >= 0) & (jj < R) & (ii < L) & \
            (jj >= bup[bidx, ic]) & (jj <= blo[bidx, ic])

        # ---- X: per left edge slot ext, double, open ----
        o = loff[bidx, ic].long()                      # (B, W, KL)
        okX = (o > 0) & (o <= G)
        vM, vX, vY = src(d - o, ii[:, :, None] - o, okX)
        candX = torch.stack(
            [vX + gextj[bidx, jc][:, :, None],
             vY + lgo3,
             (vM + lng3) + lopen[bidx, ic]], dim=-1)   # (B, W, KL, 3)
        candX = torch.where(okX[..., None], candX, neg)
        bestX, codeX = best_first(candX.reshape(B, W, KL * 3))

        # ---- Y: per right edge slot ext, double, open ----
        o = roff[bidx, jc].long()                      # (B, W, KR)
        okY = (o > 0) & (o <= G)
        vM, vX, vY = src(d - o, ii[:, :, None].expand(-1, -1, KR), okY)
        candY = torch.stack(
            [vY + gexti[bidx, ic][:, :, None],
             vX + lgo3,
             (vM + lng3) + ropen[bidx, jc]], dim=-1)   # (B, W, KR, 3)
        candY = torch.where(okY[..., None], candY, neg)
        bestY, codeY = best_first(candY.reshape(B, W, KR * 3))

        # ---- M: left slot outer, right slot inner; m, x, y ----
        ol = loff[bidx, ic].long()[:, :, :, None]      # (B, W, KL, 1)
        orr = roff[bidx, jc].long()[:, :, None, :]     # (B, W, 1, KR)
        okM = (ol > 0) & (orr > 0) & (ol + orr <= G)
        e = (d - ol - orr).expand(-1, -1, KL, KR)
        r = (ii[:, :, None, None] - ol).expand(-1, -1, KL, KR)
        vM, vX, vY = src(e, r, okM)
        ms = tab.gather(1, lstate[bidx, ic].long() * nf
                        + rstate[bidx, jc].long())     # (B, W)
        mbase = lng2 + ms
        base = ((mbase[:, :, None, None] + llw[bidx, ic][:, :, :, None])
                + rlw[bidx, jc][:, :, None, :])        # (B, W, KL, KR)
        candM = torch.stack([(vM + lng4) + base, vX + base, vY + base],
                            dim=-1)                    # (B, W, KL, KR, 3)
        candM = torch.where(okM[..., None], candM, neg)
        bestM, codeM = best_first(candM.reshape(B, W, KL * KR * 3))

        okx = valid & (ii > 0) & torch.isfinite(bestX)
        oky = valid & (jj > 0) & torch.isfinite(bestY)
        okm = valid & (ii > 0) & (jj > 0) & torch.isfinite(bestM)
        X = torch.where(okx, bestX, neg)
        Y = torch.where(oky, bestY, neg)
        M = torch.where(okm, bestM, neg)
        M = torch.where((ii == 0) & (jj == 0),
                        torch.zeros((), dtype=f, device=dev), M)
        code = (torch.where(okm, codeM, _BM_NONE)
                | (torch.where(okx, codeX, _BX_NONE) << 16)
                | (torch.where(oky, codeY, _BY_NONE) << 24))
        # uint32 bit pattern held in int32
        bp[:, d] = torch.where(code >= 2 ** 31, code - 2 ** 32,
                               code).to(torch.int32)
        slot = (d % GR) * W
        ring[:, 0, slot:slot + W] = M
        ring[:, 1, slot:slot + W] = X
        ring[:, 2, slot:slot + W] = Y
        for b, cd in enumerate(corners):
            if cd == d:
                for g in range(min(G, d + 1)):
                    s = ((d - g) % GR) * W
                    snap[b, :, g] = ring[b, :, s:s + W]
    return bp, snap


# ----------------------------------------------------------------------
class _SnapScores:
    """Score plane view over a job's corner-ring snapshot: snap[g] holds
    diagonal (L+R-2) - g."""

    def __init__(self, snap, ilo, Dlast, W):
        self.snap = np.asarray(snap)
        self.ilo = ilo
        self.Dlast = Dlast   # diagonal held by snap[0]
        self.W = W
        self.G = self.snap.shape[0]

    def __getitem__(self, ij):
        i, j = ij
        g = self.Dlast - (i + j)
        if g < 0 or g >= self.G:
            return NEG
        t = i - int(self.ilo[i + j])
        if t < 0 or t >= self.W:
            return NEG
        return float(self.snap[g, t])


class _FaninCells:
    """Oracle-style cell accessor over the packed uint32 stripe."""

    def __init__(self, bp, ilo, inp, left, right, snaps=None,
                 kr_decode=None):
        self.bp = np.asarray(bp)
        self.ilo = ilo
        self.W = self.bp.shape[1]
        self.inp = inp
        self.left = left
        self.right = right
        # M codes were packed with the launch bucket's KR, which may
        # exceed this job's true fan-in
        self.KR = kr_decode or inp["KR"]
        if snaps is not None:
            Dlast = inp["L"] + inp["R"] - 2
            self.score = {w: _SnapScores(s, ilo, Dlast, self.W)
                          for w, s in zip((M_MAT, X_MAT, Y_MAT), snaps)}

    def _code(self, i, j):
        d = i + j
        t = i - int(self.ilo[d])
        if t < 0 or t >= self.W or d >= self.bp.shape[0]:
            return _BM_NONE + (_BX_NONE << 16) + (_BY_NONE << 24)
        return int(self.bp[d, t])

    def cell(self, which, i, j) -> MatrixPtr:
        code = self._code(i, j)
        inp = self.inp
        mp = MatrixPtr()
        if which == M_MAT:
            c = code & 65535
            if c == _BM_NONE:
                return mp
            pair, move = divmod(c, 3)
            kl, kr = divmod(pair, self.KR)
            mp.matrix = (M_MAT, X_MAT, Y_MAT)[move]
            mp.x_ind = int(inp["lprev"][i, kl])
            mp.y_ind = int(inp["rprev"][j, kr])
            mp.x_edge_ind = int(inp["leid"][i, kl])
            mp.y_edge_ind = int(inp["reid"][j, kr])
        elif which == X_MAT:
            c = (code >> 16) & 255
            if c == _BX_NONE:
                mp.y_ind = j
                return mp
            k, move = divmod(c, 3)
            mp.matrix = (X_MAT, Y_MAT, M_MAT)[move]
            mp.x_ind = int(inp["lprev"][i, k])
            mp.y_ind = j
            mp.x_edge_ind = int(inp["leid"][i, k])
        else:
            c = (code >> 24) & 255
            if c == _BY_NONE:
                mp.x_ind = i
                return mp
            k, move = divmod(c, 3)
            mp.matrix = (Y_MAT, X_MAT, M_MAT)[move]
            mp.x_ind = i
            mp.y_ind = int(inp["rprev"][j, k])
            mp.y_edge_ind = int(inp["reid"][j, k])
        return mp


def finish_fanin(job_inp, bp, snaps, ilo, left, right, model, settings,
                 lbl, rbl, kr_decode=None):
    """Host end-corner + backtrack over a filled job."""
    from .backtrack import _backtrack_arrays, _end_corner_arrays

    cells = _FaninCells(bp, ilo, job_inp, left, right, snaps=snaps,
                        kr_decode=kr_decode)
    end = _end_corner_arrays(cells, left, right, model, settings, job_inp)
    if not np.isfinite(end.score):
        return None, None
    end.bwd_score = 1.0
    end.full_score = 1.0
    path = _backtrack_arrays(cells, left, right, PathPtr(end, True),
                             job_inp["L"], job_inp["R"], lbl, rbl)
    return path, end


def band_window(band, L: int, R: int):
    """(W, ilo) of kernel B's windowed fill for an anchor band over an
    L x R matrix: W the bucketed window width, ilo (L + R - 1,) its
    first row per diagonal. (None, None) when the window would not be
    narrower than the (bucketed) left side: the band is then masked at
    full width."""
    from .viterbi_banded import band_windows
    ilo_r, Wreal = band_windows(band[0], band[1], L, R)
    if _bucket(Wreal) >= _bucket(L):
        return None, None
    ilo = np.zeros(L + R - 1, np.int32)
    ilo[:len(ilo_r)] = ilo_r
    ilo[len(ilo_r):] = ilo_r[-1] if len(ilo_r) else 0
    return _bucket(Wreal), ilo


def fanin_align_path(left: SequenceGraph, right: SequenceGraph,
                     model: EvolModel, settings: AlignSettings,
                     left_branch_length: float = 0.0,
                     right_branch_length: float = 0.0, band=None,
                     device="cuda"):
    """Single-pair kernel B fill + host backtrack for fan-in graphs,
    windowed when an anchor band is given and its window is narrower
    than the (bucketed) left side, masked at full width otherwise
    (band_window). Falls back to the full matrix if the banded DP
    dead-ends (viterbi_alignment.cpp:298-317)."""
    inp = prepare_fanin(left, right, model, settings, np.float32)
    L, R = inp["L"], inp["R"]
    D = L + R - 1

    def run(bnd):
        W = ilo = None
        if bnd is not None:
            upper, lower = bnd
            W, ilo = band_window(bnd, L, R)
            inp["band_upper"] = np.clip(np.asarray(upper[:L], np.int64),
                                        0, R - 1).astype(np.int32)
            inp["band_lower"] = np.clip(np.asarray(lower[:L], np.int64),
                                        0, R - 1).astype(np.int32)
        else:
            inp.pop("band_upper", None)
            inp.pop("band_lower", None)
        args = fanin_batch_args([inp], device, W=W, ilo=ilo)
        bp, snap = fanin_fill(**args)
        snap = snap[0].cpu().numpy()
        return (bp[0].cpu().numpy().view(np.uint32),
                (snap[0], snap[1], snap[2]),
                ilo if ilo is not None else np.zeros(D, np.int32))

    bp, snaps, ilo = run(band)
    path, end = finish_fanin(inp, bp, snaps, ilo, left, right, model,
                             settings, left_branch_length,
                             right_branch_length)
    if path is None and band is not None:
        bp, snaps, ilo = run(None)
        path, end = finish_fanin(inp, bp, snaps, ilo, left, right, model,
                                 settings, left_branch_length,
                                 right_branch_length)
    if path is None:
        raise RuntimeError("fan-in fill could not reach the end corner")
    return path, end
