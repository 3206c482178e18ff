"""Band-axis sharding of ONE pairwise DP over the shards of a jobs mesh:
kernels G (linear) and H (fan-in) in csrc/viterbi_shardband.cu, their
plain PyTorch versions, the host prep and the block loop.

Ported from pagan2_tpu/align/viterbi_shardband.py, whose fills are
`shard_map` scans with no Pallas kernel (`_build_fill`, :83, and
`_build_fanin_fill`, :362). The lane axis of the wavefront (the left
sequence's rows) splits over the shards: shard k owns lanes
[k*w, (k+1)*w) and keeps an H-lane halo on its left. A step reads at
most one lane to the left (a fan-in step OLm lanes), so the halo decays
by one lane (OLm lanes) a diagonal, and one exchange of the wavefront
edges every H diagonals (every max(1, H // OLm) steps) keeps every
owned lane exact: the codes and corner scores are bit-identical to the
one-device fill. The exchange is a device-to-device copy between shards
of one process and a gloo send/recv of host tensors between ranks
(parallel/multihost.py).

The linear fill is the reference's scan core (batched_sheared_core:
candidate order ext, double, open for the gaps and m, x, y for the
match, strict-greater first-wins, M's candidates compared after the
match score is added, folded as ((lng + ms) + lw[i]) + rw[j]); the
fan-in fill is its one-hot fan-in scan core (_build_core_onehot), whose
codes `finish_fanin` backtracks unchanged. Both store the reference's
masked codes: 3 (linear) or 65535 / 255 / 255 (fan-in) where a cell's
value is not finite or outside the matrix or band.

One launch of G or H runs one block of diagonals of one shard from its
carry (the six wavefront vectors, or the three rings of the last G
diagonals, over halo and owned lanes): CUDA blocks tile the shard's
owned lanes, each loading its tile plus an H-lane halo from the carry,
so the halo decays inside a tile exactly as it does across shards and
no grid-wide sync is needed, only one __syncthreads a diagonal.

Device rule: a CPU tensor takes the plain version; a CUDA tensor
launches the kernel or raises.
"""
from __future__ import annotations

import ctypes

import numpy as np
import torch

from .. import kernels
from ..kernels import SHARED_BYTES
from .oracle import PathPtr
from .viterbi_sheared import (NEG, _NONE, prepare_sheared, _bucket,
                              _end_corner_linear, _ShearedCells)

# halo width = diagonals between exchanges; any positive value is exact,
# larger trades duplicated lanes for fewer exchanges
HALO = 32

# launches of kernels G and H, and the plain-version calls the wrappers
# made, by wrapper name
LAUNCHES = {"shardband_linear_block": 0, "shardband_fanin_block": 0}
PLAIN_CALLS = {"shardband_linear_block": 0, "shardband_fanin_block": 0}

_BM_NONE, _BX_NONE, _BY_NONE = 65535, 255, 255


def _lane_split(L: int, n_dev: int) -> int:
    """Owned lanes per shard: the bucketed total split evenly, kept a
    multiple of 8."""
    W = _bucket(L)
    w = -(-W // n_dev)
    return -(-w // 8) * 8


def _overlap_shard(vec: np.ndarray, n_dev: int, w: int, H: int, fill):
    """(W,) -> (n_dev, H + w): row k is lanes [k*w - H, k*w + w) of the
    global lane axis (halo + owned), `fill` outside it."""
    out = np.full((n_dev, H + w), fill, vec.dtype)
    for k in range(n_dev):
        lo = k * w - H
        src_lo = max(lo, 0)
        src_hi = min(k * w + w, len(vec))
        if src_hi > src_lo:
            out[k, src_lo - lo:src_hi - lo] = vec[src_lo:src_hi]
    return out


def _overlap_shard2(arr: np.ndarray, n_dev: int, w: int, H: int, fill):
    """(W, C) -> (n_dev, H + w, C): the row-sharded _overlap_shard."""
    out = np.full((n_dev, H + w, arr.shape[1]), fill, arr.dtype)
    for k in range(n_dev):
        lo = k * w - H
        src_lo = max(lo, 0)
        src_hi = min(k * w + w, arr.shape[0])
        if src_hi > src_lo:
            out[k, src_lo - lo:src_hi - lo] = arr[src_lo:src_hi]
    return out


# ----------------------------------------------------------------------
# launch plans
def linear_block_plan(H: int) -> dict:
    """How kernel G is launched with halo H: a block of `threads` lanes,
    one a thread, the first H of them the tile's halo and the other
    `tile` owned; three diagonals of M, X, Y in shared memory."""
    threads = 512 if H < 256 else 1024
    if H >= threads:
        raise ValueError("kernel G: halo %d leaves no owned lane in a "
                         "block of %d" % (H, threads))
    return dict(threads=threads, tile=threads - H, smem=36 * threads)


def fanin_block_plan(H: int, G: int) -> dict:
    """How kernel H is launched with halo H and ring depth G: a block of
    `threads` lanes (whole warps, at most 512, as many as the G + 1
    diagonals of M, X, Y fit in shared memory), the first H the tile's
    halo and the other `tile` owned."""
    threads = min(512, SHARED_BYTES // (12 * (G + 1)) // 32 * 32)
    if threads <= H:
        raise ValueError("kernel H: a ring of %d diagonals and a halo of "
                         "%d lanes leave no owned lane in shared memory"
                         % (G + 1, H))
    return dict(threads=threads, tile=threads - H,
                smem=12 * (G + 1) * threads)


# ----------------------------------------------------------------------
# kernel G: one block of diagonals of one shard of a linear pair
_LIN_TENSORS = [("cin", torch.float32), ("cout", torch.float32),
                ("codes", torch.uint8), ("corner", torch.float32),
                ("ms", torch.float32), ("gexti", torch.float32),
                ("olp", torch.float32), ("lw", torch.float32),
                ("vlo", torch.int32), ("vhi", torch.int32),
                ("gj", torch.float32), ("orp", torch.float32),
                ("rw", torch.float32)]


def _check(named, ref):
    for name, t, dt in named:
        if t.dtype != dt:
            raise TypeError("%s must be %s, got %s" % (name, dt, t.dtype))
        if not t.is_contiguous():
            raise ValueError("%s must be contiguous" % name)
        if t.device != ref.device:
            raise ValueError("%s is on %s, cin on %s"
                             % (name, t.device, ref.device))
    if ref.device.type not in ("cpu", "cuda"):
        raise ValueError("unsupported device %s" % ref.device)


def _check_linear(a: dict, H: int, d0: int, nsteps: int):
    _check([(n, a[n], dt) for n, dt in _LIN_TENSORS], a["cin"])
    wloc = a["cin"].shape[1]
    w = wloc - H
    R = a["gj"].shape[0]
    want = dict(cin=(6, wloc), cout=(6, wloc), corner=(3,), ms=(wloc, R),
                gexti=(wloc,), olp=(wloc,), lw=(wloc,), vlo=(wloc,),
                vhi=(wloc,), orp=(R,), rw=(R,))
    for name, shape in want.items():
        if tuple(a[name].shape) != shape:
            raise ValueError("%s must have shape %s, got %s"
                             % (name, shape, tuple(a[name].shape)))
    if a["codes"].dim() != 2 or a["codes"].shape[1] != w or \
            a["codes"].shape[0] < d0 + nsteps or w < 1 or H < 1 or \
            d0 < 1 or nsteps < 1:
        raise ValueError("codes %s for H %d, %d lanes, diagonals %d + %d"
                         % (tuple(a["codes"].shape), H, wloc, d0, nsteps))


def shardband_linear_block(cin, cout, codes, corner, ms, gexti, olp, lw,
                           vlo, vhi, gj, orp, rw, lng: float, lgo: float,
                           L: int, R: int, base: int, H: int, d0: int,
                           nsteps: int):
    """Kernel G: `nsteps` diagonals d0, d0 + 1, ... of one shard of a
    band-sharded linear fill. cin (6, H + w) f32: M, X, Y of diagonal
    d0 - 1 and of d0 - 2 on the shard's local lanes (global lane
    base + l); the halo lanes [0, H) hold the left neighbour's values
    (shard 0: -inf). Writes cout's owned lanes [H, H + w) (the same six
    vectors after the block; its halo lanes are left as they are), the
    owned lanes' codes of each diagonal d at codes[d] ((rows, w) uint8,
    bm | bx << 2 | by << 4, 3 where masked), and corner (3,) (M, X, Y of
    cell (L - 1, R - 1)) when the block reaches diagonal L + R - 2 and
    the shard owns lane L - 1. Per local lane: ms (H + w, R) the match
    scores of the lane's row, gexti, olp (open_l of the row above), lw,
    and the band vlo/vhi (1 and 0 on lanes outside the matrix); per
    column: gj (gext_j), orp (open_r of the column before) and rw.

    On a CUDA tensor it launches kernel G as linear_block_plan(H) says;
    a launch error raises."""
    a = dict(cin=cin, cout=cout, codes=codes, corner=corner, ms=ms,
             gexti=gexti, olp=olp, lw=lw, vlo=vlo, vhi=vhi, gj=gj, orp=orp,
             rw=rw)
    _check_linear(a, H, d0, nsteps)
    scal = dict(lng=lng, lgo=lgo, L=L, R=R, base=base, H=H, d0=d0,
                nsteps=nsteps)
    if cin.device.type == "cpu":
        PLAIN_CALLS["shardband_linear_block"] += 1
        return shardband_linear_block_plain(**a, **scal)
    plan = linear_block_plan(H)
    wloc = cin.shape[1]
    lib = kernels.load("viterbi_shardband")
    fn = lib.shardband_linear_launch
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * 13 + [ctypes.c_float] * 2 + \
        [ctypes.c_int] * 9 + [ctypes.c_void_p]
    with torch.cuda.device(cin.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(*[a[n].data_ptr() for n, _ in _LIN_TENSORS],
                 lng, lgo, L, R, base, H, d0, nsteps, wloc,
                 plan["threads"], plan["smem"], stream)
    kernels.check(err, "viterbi_shardband (kernel G)")
    LAUNCHES["shardband_linear_block"] += 1


def shardband_linear_block_plain(cin, cout, codes, corner, ms, gexti, olp,
                                 lw, vlo, vhi, gj, orp, rw, lng, lgo, L, R,
                                 base, H, d0, nsteps):
    """Plain PyTorch version of kernel G: the reference's shard step
    (pagan2_tpu/align/viterbi_shardband.py:119-184) on the whole shard,
    one diagonal at a time."""
    dev = cin.device
    f = torch.float32
    neg = torch.tensor(NEG, dtype=f, device=dev)
    lng = torch.tensor(lng, dtype=f, device=dev)
    lgo = torch.tensor(lgo, dtype=f, device=dev)
    wloc = cin.shape[1]
    li = torch.arange(wloc, device=dev)
    ii = base + li
    m1, x1, y1, m2, x2, y2 = cin.clone()

    def shift(v):
        return torch.cat([neg.reshape(1), v[:-1]])

    def first_max(c0, c1, c2):
        v01 = torch.maximum(c0, c1)
        return torch.maximum(v01, c2), \
            torch.where(c2 > v01, 2, torch.where(c1 > c0, 1, 0))

    for d in range(d0, d0 + nsteps):
        j = d - ii
        inr = (j >= 0) & (j < R)
        jc = j.clamp(0, R - 1)
        valid = inr & (ii < L) & (j >= vlo) & (j <= vhi)
        zero = torch.zeros((), dtype=f, device=dev)
        gjv = torch.where(inr, gj[jc], zero)
        orv = torch.where(inr, orp[jc], zero)
        rwv = torch.where(inr, rw[jc], zero)
        msv = torch.where(valid, ms[li, jc], zero)
        vx, bx = first_max(shift(x1) + gjv, shift(y1) + lgo,
                           (shift(m1) + lng) + olp)
        okx = valid & (ii > 0) & torch.isfinite(vx)
        vy, by = first_max(y1 + gexti, x1 + lgo, (m1 + lng) + orv)
        oky = valid & (j > 0) & torch.isfinite(vy)
        wadd = ((lng + msv) + lw) + rwv
        vm, bm = first_max((shift(m2) + lng) + wadd, shift(x2) + wadd,
                           shift(y2) + wadd)
        okm = valid & (ii > 0) & (j > 0) & torch.isfinite(vm)
        X = torch.where(okx, vx, neg)
        Y = torch.where(oky, vy, neg)
        M = torch.where(okm, vm, neg)
        code = torch.where(okm, bm, _NONE) | \
            (torch.where(okx, bx, _NONE) << 2) | \
            (torch.where(oky, by, _NONE) << 4)
        codes[d] = code[H:].to(torch.uint8)
        if d == L + R - 2 and H <= L - 1 - base < wloc:
            k = L - 1 - base
            corner.copy_(torch.stack([M[k], X[k], Y[k]]))
        m2, x2, y2 = m1, x1, y1
        m1, x1, y1 = M, X, Y
    cout[:, H:] = torch.stack([m1, x1, y1, m2, x2, y2])[:, H:]


# ----------------------------------------------------------------------
# kernel H: one block of steps of one shard of a fan-in pair
_FAN_TENSORS = [("cin", torch.float32), ("cout", torch.float32),
                ("codes", torch.int32), ("snap", torch.float32),
                ("lstate", torch.int32), ("table", torch.float32),
                ("loff", torch.int32), ("llw", torch.float32),
                ("lopen", torch.float32), ("gexti", torch.float32),
                ("vlo", torch.int32), ("vhi", torch.int32),
                ("rstate", torch.int32), ("gextj", torch.float32),
                ("roff", torch.int32), ("rlw", torch.float32),
                ("ropen", torch.float32)]


def _check_fanin(a: dict, H: int, d0: int, nsteps: int):
    _check([(n, a[n], dt) for n, dt in _FAN_TENSORS], a["cin"])
    if a["cin"].dim() != 3 or a["cin"].shape[0] != 3:
        raise ValueError("cin must be (3, G, H + w)")
    G, wloc = a["cin"].shape[1:]
    w = wloc - H
    R = a["rstate"].shape[0]
    KL = a["loff"].shape[1] if a["loff"].dim() == 2 else -1
    KR = a["roff"].shape[1] if a["roff"].dim() == 2 else -1
    nf = a["table"].shape[0]
    want = dict(cout=(3, G, wloc), snap=(3, G, w), lstate=(wloc,),
                table=(nf, nf), loff=(wloc, KL), llw=(wloc, KL),
                lopen=(wloc, KL), gexti=(wloc,), vlo=(wloc,), vhi=(wloc,),
                gextj=(R,), roff=(R, KR), rlw=(R, KR), ropen=(R, KR))
    for name, shape in want.items():
        if tuple(a[name].shape) != shape:
            raise ValueError("%s must have shape %s, got %s"
                             % (name, shape, tuple(a[name].shape)))
    if a["codes"].dim() != 2 or a["codes"].shape[1] != w or \
            a["codes"].shape[0] < d0 + nsteps or w < 1 or H < 1 or \
            d0 < 0 or nsteps < 1 or KL < 1 or KR < 1:
        raise ValueError("codes %s for H %d, %d lanes, steps %d + %d"
                         % (tuple(a["codes"].shape), H, wloc, d0, nsteps))


def shardband_fanin_block(cin, cout, codes, snap, lstate, table, loff, llw,
                          lopen, gexti, vlo, vhi, rstate, gextj, roff, rlw,
                          ropen, lng: float, lgo: float, L: int, R: int,
                          base: int, H: int, d0: int, nsteps: int):
    """Kernel H: `nsteps` diagonals d0, d0 + 1, ... of one shard of a
    band-sharded fan-in fill. cin (3, G, H + w) f32: M, X, Y of diagonal
    d0 - 1 - g at [:, g] on the shard's local lanes (global lane
    base + l), the halo lanes [0, H) the left neighbour's. Writes cout's
    owned lanes (the same rings after the block), the owned lanes' codes
    of diagonal d at codes[d] ((rows, w) int32 holding the uint32
    bm | bx << 16 | by << 24 of kernel B and the one-hot scan core), and
    snap (3, G, w) (the rings at diagonal L + R - 2) when the block
    reaches it. Per local lane: lstate (the row's state, an index into
    the nf x nf log-score table), loff/llw/lopen (H + w, KL) its bwd
    edges' offsets (0: no edge), log weights and open penalties, gexti,
    and the band vlo/vhi; per column: rstate, gextj and roff/rlw/ropen
    (R, KR).

    On a CUDA tensor it launches kernel H as fanin_block_plan(H, G)
    says; a launch error raises."""
    a = dict(cin=cin, cout=cout, codes=codes, snap=snap, lstate=lstate,
             table=table, loff=loff, llw=llw, lopen=lopen, gexti=gexti,
             vlo=vlo, vhi=vhi, rstate=rstate, gextj=gextj, roff=roff,
             rlw=rlw, ropen=ropen)
    _check_fanin(a, H, d0, nsteps)
    scal = dict(lng=lng, lgo=lgo, L=L, R=R, base=base, H=H, d0=d0,
                nsteps=nsteps)
    if cin.device.type == "cpu":
        PLAIN_CALLS["shardband_fanin_block"] += 1
        return shardband_fanin_block_plain(**a, **scal)
    G, wloc = cin.shape[1:]
    plan = fanin_block_plan(H, G)
    lib = kernels.load("viterbi_shardband")
    fn = lib.shardband_fanin_launch
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * 17 + [ctypes.c_float] * 2 + \
        [ctypes.c_int] * 13 + [ctypes.c_void_p]
    with torch.cuda.device(cin.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(*[a[n].data_ptr() for n, _ in _FAN_TENSORS],
                 lng, lgo, L, R, base, H, d0, nsteps, wloc, G,
                 loff.shape[1], roff.shape[1], table.shape[0],
                 plan["threads"], plan["smem"], stream)
    kernels.check(err, "viterbi_shardband (kernel H)")
    LAUNCHES["shardband_fanin_block"] += 1


def shardband_fanin_block_plain(cin, cout, codes, snap, lstate, table, loff,
                                llw, lopen, gexti, vlo, vhi, rstate, gextj,
                                roff, rlw, ropen, lng, lgo, L, R, base, H,
                                d0, nsteps):
    """Plain PyTorch version of kernel H: the reference's fan-in shard
    step (pagan2_tpu/align/viterbi_shardband.py:400-521) on the whole
    shard, one diagonal at a time."""
    dev = cin.device
    f = torch.float32
    neg = torch.tensor(NEG, dtype=f, device=dev)
    zero = torch.zeros((), dtype=f, device=dev)
    lng = torch.tensor(lng, dtype=f, device=dev)
    lgo = torch.tensor(lgo, dtype=f, device=dev)
    G, wloc = cin.shape[1:]
    KL, KR = loff.shape[1], roff.shape[1]
    nf = table.shape[0]
    li = torch.arange(wloc, device=dev)
    ii = base + li
    ring = cin.clone()                   # ring[:, g]: diagonal d - 1 - g
    loff = loff.long()

    lanes = li[:, None]

    def src(g, sh, ok):
        """(M, X, Y) of ring depth g (1 = the last diagonal) on lane
        li - sh, each (wloc, ...) like g; -inf where not `ok`, outside
        the ring or off the shard's left edge."""
        lane = lanes.reshape((wloc,) + (1,) * (g.dim() - 1)) - sh
        ok = ok & (g >= 1) & (g <= G) & (lane >= 0)
        v = ring[:, (g - 1).clamp(0, G - 1), lane.clamp(0, wloc - 1)]
        return torch.where(ok, v, neg)

    def first_max(cand):
        # the strict-greater first-wins updates over the candidates in
        # their order: the maximum and its first index (a cell whose
        # maximum is -inf is masked below)
        flat = cand.reshape(wloc, -1)
        return flat.amax(1), flat.argmax(1)

    for d in range(d0, d0 + nsteps):
        jj = d - ii
        inr = (jj >= 0) & (jj < R)
        jc = jj.clamp(0, R - 1)
        valid = inr & (ii >= 0) & (ii < L) & (jj >= vlo) & (jj <= vhi)
        rs = torch.where(inr, rstate[jc].long(), nf - 1)
        ms = table[lstate.long(), rs]
        gjx = torch.where(inr, gextj[jc], zero)
        ro = torch.where(inr[:, None], roff[jc].long(), 0)     # (wloc, KR)
        rop = torch.where(inr[:, None], ropen[jc], zero)
        rlwp = torch.where(inr[:, None], rlw[jc], zero)
        true = torch.ones((wloc, 1), dtype=torch.bool, device=dev)

        # X: per left edge slot ext, double, open
        vM, vX, vY = src(loff, loff, true)                     # (wloc, KL)
        bestX, codeX = first_max(torch.stack(
            [vX + gjx[:, None], vY + lgo, (vM + lng) + lopen], dim=-1))
        # Y: per right edge slot ext, double, open (no lane shift)
        vM, vX, vY = src(ro, 0, true)                          # (wloc, KR)
        bestY, codeY = first_max(torch.stack(
            [vY + gexti[:, None], vX + lgo, (vM + lng) + rop], dim=-1))
        # M: left slot outer, right slot inner; m, x, y
        sl = loff[:, :, None]
        rr = ro[:, None, :]
        vM, vX, vY = src(sl + rr, sl, (sl >= 1) & (rr >= 1))   # (wloc,KL,KR)
        base_ = ((lng + ms)[:, None] + llw)[:, :, None] + rlwp[:, None, :]
        bestM, codeM = first_max(torch.stack(
            [(vM + lng) + base_, vX + base_, vY + base_], dim=-1))

        okx = valid & (ii > 0) & torch.isfinite(bestX)
        oky = valid & (jj > 0) & torch.isfinite(bestY)
        okm = valid & (ii > 0) & (jj > 0) & torch.isfinite(bestM)
        X = torch.where(okx, bestX, neg)
        Y = torch.where(oky, bestY, neg)
        M = torch.where(okm, bestM, neg)
        M = torch.where((ii == 0) & (jj == 0), zero, M)
        code = torch.where(okm, codeM, _BM_NONE) + \
            (torch.where(okx, codeX, _BX_NONE) << 16) + \
            (torch.where(oky, codeY, _BY_NONE) << 24)
        codes[d] = torch.where(code >= 2 ** 31, code - 2 ** 32,
                               code)[H:].to(torch.int32)
        ring = torch.cat([torch.stack([M, X, Y])[:, None], ring[:, :-1]],
                         dim=1)
        if d == L + R - 2:
            snap.copy_(ring[:, :, H:])
    cout[:, :, H:] = ring[:, :, H:]


# ----------------------------------------------------------------------
# host prep and the block loop
def shardband_args(left, right, model, settings, n_dev: int, band=None,
                   H: int = HALO):
    """Host prep of a linear pair for n_dev shards (f32): per shard its
    overlapped (halo + owned) lane arrays, the column vectors every
    shard reads, and the scalars. Returns (per-shard dicts, meta)."""
    dtype = np.float32
    inp = prepare_sheared(left, right, model, settings, dtype)
    L, R = inp["L"], inp["R"]
    w = _lane_split(L, n_dev)
    W = w * n_dev

    def ov(vec, fill):
        v = np.full(W, fill, np.asarray(vec).dtype)
        v[:len(vec)] = vec
        return _overlap_shard(v, n_dev, w, H, v.dtype.type(fill))

    if band is None:
        vlo = np.zeros(L, np.int32)
        vhi = np.full(L, R - 1, np.int32)
    else:
        vlo = np.asarray(band[0][:L], np.int32)
        vhi = np.asarray(band[1][:L], np.int32)
    lanes = dict(
        ms=_overlap_shard2(np.asarray(inp["ms"], dtype), n_dev, w, H, 0.0),
        gexti=ov(inp["gext_i"], 0.0),
        olp=ov(np.concatenate([[0.0], inp["open_l"][:-1]]).astype(dtype),
               0.0),
        lw=ov(inp["lw"], 0.0),
        # lanes outside the matrix: an empty interval
        vlo=ov(vlo, 1), vhi=ov(vhi, 0))
    cols = dict(gj=np.asarray(inp["gext_j"], dtype),
                orp=np.asarray(inp["open_r_shifted"], dtype),
                rw=np.asarray(inp["rw"], dtype))
    shards = [dict({k: v[s] for k, v in lanes.items()}, **cols)
              for s in range(n_dev)]
    meta = dict(L=L, R=R, w=w, W=W, H=H, inp=inp,
                lng=float(inp["lng"]), lgo=float(inp["lgo"]))
    return shards, meta


def _to(arrays: dict, dev) -> dict:
    return {k: torch.from_numpy(np.ascontiguousarray(v)).to(dev)
            for k, v in arrays.items()}


def _gather_lanes(mesh, parts: dict):
    """Each shard's [arrays] -> per array the lane-wise concatenation
    over shards (numpy, on every rank)."""
    from ..parallel.multihost import gather_to_host
    host = gather_to_host(mesh, {s: [t.cpu().numpy() for t in ts]
                                 for s, ts in parts.items()})
    return [np.concatenate([host[s][k] for s in range(mesh.size)],
                           axis=-1) for k in range(len(host[0]))]


def shardband_fill(mesh, shards, meta):
    """The band-sharded linear fill of shardband_args' prep over the
    mesh's shards: one kernel G launch a shard and block of H diagonals,
    the halo edges passed on after each block. Returns (codes (L + R - 1,
    W) uint8 in the sheared layout, row 0 all 3s; corner (3,) f32), the
    same on every rank."""
    from ..parallel.multihost import pass_edges
    L, R, w, H = meta["L"], meta["R"], meta["w"], meta["H"]
    n = mesh.size
    wloc = H + w
    last = L + R - 2
    st = {}
    for s in range(n):
        if not mesh.is_local(s):
            continue
        dev = mesh.devices[s]
        base = s * w - H
        c0 = torch.full((6, wloc), NEG, dtype=torch.float32, device=dev)
        if 0 <= -base < wloc:
            c0[0, -base] = 0.0           # M of cell (0, 0), diagonal 0
        st[s] = dict(cin=c0, cout=torch.full_like(c0, NEG),
                     codes=torch.full((last + 1, w), 0x3F,
                                      dtype=torch.uint8, device=dev),
                     corner=torch.full((3,), NEG, dtype=torch.float32,
                                       device=dev),
                     args=_to(shards[s], dev), base=base)
    for d0 in range(1, last + 1, H):
        nsteps = min(H, last + 1 - d0)
        for s, t in st.items():
            shardband_linear_block(cin=t["cin"], cout=t["cout"],
                                   codes=t["codes"], corner=t["corner"],
                                   **t["args"], lng=meta["lng"],
                                   lgo=meta["lgo"], L=L, R=R,
                                   base=t["base"], H=H, d0=d0,
                                   nsteps=nsteps)
        pass_edges(mesh, {s: t["cout"][:, w:w + H] for s, t in st.items()},
                   {s: t["cout"][:, :H] for s, t in st.items()})
        for t in st.values():
            t["cin"], t["cout"] = t["cout"], t["cin"]
    codes, corners = _gather_lanes(
        mesh, {s: [t["codes"], t["corner"][:, None]]
               for s, t in st.items()})
    return codes, corners[:, (L - 1) // w]


def shardband_align_path(left, right, model, settings, mesh,
                         left_branch_length: float = 0.0,
                         right_branch_length: float = 0.0, band=None,
                         H: int = HALO):
    """Band-sharded fill + host backtrack of one giant linear pair over
    the mesh's shards, bit-identical to the one-device fill; a band that
    cannot reach the end corner is filled again over the full matrix
    (viterbi_alignment.cpp:298-317)."""
    from .backtrack import _backtrack_arrays
    n = mesh.size
    # the halo refresh pulls the neighbour's last H lanes, which are only
    # exact when every shard owns at least H lanes
    H = min(H, _lane_split(left.num_sites() - 1, n))

    def run(bnd):
        shards, meta = shardband_args(left, right, model, settings, n,
                                      band=bnd, H=H)
        codes, final = shardband_fill(mesh, shards, meta)
        return codes, final, meta

    codes, final, meta = run(band)
    if band is not None and not np.isfinite(final).any():
        codes, final, meta = run(None)
    L, R = meta["L"], meta["R"]
    cells = _ShearedCells(codes, left, right)
    end = _end_corner_linear(final, left, right, model, L, R)
    end.bwd_score = 1.0
    end.full_score = 1.0
    path = _backtrack_arrays(cells, left, right, PathPtr(end, True), L, R,
                             left_branch_length, right_branch_length)
    return path, end


def shardband_fanin_args(inp: dict, n_dev: int, band=None, H: int = HALO):
    """Host prep of a fan-in pair (a prepare_fanin dict, f32) for n_dev
    shards: per shard its overlapped lane arrays and the column arrays
    every shard reads. Returns (per-shard dicts, meta)."""
    dtype = np.float32
    L, R = inp["L"], inp["R"]
    w = _lane_split(L, n_dev)
    Wt = w * n_dev
    nf = inp["log_score"].shape[0]

    def pad(a, fill, dt):
        out = np.full((Wt,) + np.shape(a)[1:], fill, dt)
        out[:L] = a
        return out

    if band is None:
        vlo = np.zeros(L, np.int32)
        vhi = np.full(L, R - 1, np.int32)
    else:
        vlo = np.clip(np.asarray(band[0][:L], np.int64), 0,
                      R - 1).astype(np.int32)
        vhi = np.clip(np.asarray(band[1][:L], np.int64), 0,
                      R - 1).astype(np.int32)
    lanes = dict(
        lstate=_overlap_shard(pad(np.mod(inp["lstates"], nf), 0, np.int32),
                              n_dev, w, H, np.int32(0)),
        loff=_overlap_shard2(pad(inp["loff"], 0, np.int32), n_dev, w, H,
                             np.int32(0)),
        llw=_overlap_shard2(pad(inp["llw"], 0.0, dtype), n_dev, w, H, 0.0),
        lopen=_overlap_shard2(pad(inp["lopen"], 0.0, dtype), n_dev, w, H,
                              0.0),
        gexti=_overlap_shard(pad(inp["gext_i"], 0.0, dtype), n_dev, w, H,
                             0.0),
        vlo=_overlap_shard(pad(vlo, 1, np.int32), n_dev, w, H, np.int32(1)),
        vhi=_overlap_shard(pad(vhi, 0, np.int32), n_dev, w, H, np.int32(0)))
    cols = dict(table=np.asarray(inp["log_score"], dtype),
                rstate=np.mod(np.asarray(inp["rstates"], np.int32), nf
                              ).astype(np.int32),
                gextj=np.asarray(inp["gext_j"], dtype),
                roff=np.asarray(inp["roff"], np.int32),
                rlw=np.asarray(inp["rlw"], dtype),
                ropen=np.asarray(inp["ropen"], dtype))
    shards = [dict({k: v[s] for k, v in lanes.items()}, **cols)
              for s in range(n_dev)]
    return shards, dict(L=L, R=R, w=w, W=Wt, H=H, lng=float(inp["lng"]),
                        lgo=float(inp["lgo"]))


def shardband_fanin_fill(mesh, shards, meta, G: int, T: int):
    """The band-sharded fan-in fill over the mesh's shards: one kernel H
    launch a shard and block of T steps, the halo edges of every ring
    plane passed on after each block. Returns (codes (L + R - 1, W)
    uint32, snaps (3, G, W) f32), the same on every rank."""
    from ..parallel.multihost import pass_edges
    L, R, w, H = meta["L"], meta["R"], meta["w"], meta["H"]
    wloc = H + w
    last = L + R - 2
    st = {}
    for s in range(mesh.size):
        if not mesh.is_local(s):
            continue
        dev = mesh.devices[s]
        c0 = torch.full((3, G, wloc), NEG, dtype=torch.float32, device=dev)
        st[s] = dict(cin=c0, cout=torch.full_like(c0, NEG),
                     codes=torch.empty((last + 1, w), dtype=torch.int32,
                                       device=dev),
                     snap=torch.full((3, G, w), NEG, dtype=torch.float32,
                                     device=dev),
                     args=_to(shards[s], dev), base=s * w - H)
    for d0 in range(0, last + 1, T):
        nsteps = min(T, last + 1 - d0)
        for s, t in st.items():
            shardband_fanin_block(cin=t["cin"], cout=t["cout"],
                                  codes=t["codes"], snap=t["snap"],
                                  **t["args"], lng=meta["lng"],
                                  lgo=meta["lgo"], L=L, R=R, base=t["base"],
                                  H=H, d0=d0, nsteps=nsteps)
        pass_edges(mesh,
                   {s: t["cout"][:, :, w:w + H] for s, t in st.items()},
                   {s: t["cout"][:, :, :H] for s, t in st.items()})
        for t in st.values():
            t["cin"], t["cout"] = t["cout"], t["cin"]
    codes, snaps = _gather_lanes(mesh, {s: [t["codes"], t["snap"]]
                                        for s, t in st.items()})
    return codes.view(np.uint32), snaps


def shardband_fanin_align_path(left, right, model, settings, mesh,
                               left_branch_length: float = 0.0,
                               right_branch_length: float = 0.0, band=None,
                               H: int = HALO):
    """Band-sharded fill + host backtrack of one giant FAN-IN pair over
    the mesh's shards, bit-identical to the one-hot fan-in scan core;
    a band that dead-ends is filled again over the full matrix. Raises
    ValueError past the one-hot caps, and when a left bridge edge spans
    more lanes than the halo (the executor then runs the pair
    unsharded)."""
    from .viterbi_fanin import prepare_fanin, finish_fanin, K_CAP
    n = mesh.size
    inp = prepare_fanin(left, right, model, settings, np.float32)
    L, R = inp["L"], inp["R"]
    H = min(H, _lane_split(L, n))
    KL, KR = inp["KL"], inp["KR"]
    OLm, ORm = max(inp["OL"], 1), max(inp["OR"], 1)
    G = _g_bucket(OLm + ORm)
    if KL > K_CAP or KR > K_CAP:
        raise ValueError("fan-in beyond the one-hot caps")
    # a step reads at most OLm lanes to the left, so T = H // OLm steps
    # consume the halo; a LEFT bridge wider than H would read past it.
    # Right offsets only select ring depth: ORm needs no lane budget.
    if OLm > H:
        raise ValueError("left bridge offset %d exceeds the %d-lane halo "
                         "budget" % (OLm, H))
    T = max(1, H // OLm)

    def run(bnd):
        shards, meta = shardband_fanin_args(inp, n, band=bnd, H=H)
        bp, snaps = shardband_fanin_fill(mesh, shards, meta, G, T)
        return bp, (snaps[0], snaps[1], snaps[2])

    ilo = np.zeros(L + R - 1, np.int32)
    bp, snaps = run(band)
    path, end = finish_fanin(inp, bp, snaps, ilo, left, right, model,
                             settings, left_branch_length,
                             right_branch_length, kr_decode=KR)
    if path is None and band is not None:
        bp, snaps = run(None)
        path, end = finish_fanin(inp, bp, snaps, ilo, left, right, model,
                                 settings, left_branch_length,
                                 right_branch_length, kr_decode=KR)
    if path is None:
        raise RuntimeError("fan-in fill could not reach the end corner")
    return path, end


def _g_bucket(n: int) -> int:
    """The reference's ring-depth bucket (viterbi_fanin._g_bucket): the
    ring holds G diagonals, the next power of two from 2."""
    g = 2
    while g < n:
        g *= 2
    return g
