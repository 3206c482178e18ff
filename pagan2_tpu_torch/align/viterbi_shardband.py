"""Band-axis sharding of ONE pairwise DP over the shards of a jobs mesh:
kernels G (linear) and H (fan-in) in csrc/viterbi_shardband.cu, their
plain PyTorch versions, the host prep, the launch plans and the block
loop.

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

The launch plan (linear_launch_plan, fanin_launch_plan) launches only
the shards, and within a shard only the range of tiles, whose lanes
hold a cell of the block or a carry that can be finite. The codes start
filled with the masked code and the carries at -inf, and a launch
writes the code of a cell only where the cell lies in the matrix and
band, so a lane left out already holds what the kernel would write.

Device rule: a CPU tensor takes the plain version; a CUDA tensor
launches the kernel or raises.
"""
from __future__ import annotations

import contextlib
import ctypes
import time

import numpy as np
import torch

from .. import kernels
from ..kernels import SHARED_BYTES
from .oracle import PathPtr
from .viterbi_sheared import (NEG, _NONE, prepare_sheared, _bucket,
                              _end_corner_linear, _ShearedCells)

# halo width = diagonals between exchanges (kernel G) or lanes a fan-in
# block of steps may consume (kernel H); any positive value is exact,
# larger trades duplicated lanes for fewer launches and exchanges
HALO = 256
# the widest left bridge a band-sharded fan-in pair may have (the JAX
# package's halo): a wider one runs unsharded, as it does there
BRIDGE_LANES = 32
# kernel G's CUDA block, two lanes a thread; kernel H's widest block,
# one lane a thread. A tile's diagonal takes longer the more warps it
# holds, and the tiles of a launch run side by side on their own SMs, so
# small tiles win even at a halo of half their lanes (bench_shardband
# --geometry on an H100: G 0.50 us a diagonal at 256 threads, 1.08 at
# 1,024; H 1.27 at 256 lanes, 2.38 at 1,024)
G_THREADS = 256
H_LANES = 256

# launches of kernels G and H, and the plain-version calls the wrappers
# made, by wrapper name
LAUNCHES = {"shardband_linear_block": 0, "shardband_fanin_block": 0}
PLAIN_CALLS = {"shardband_linear_block": 0, "shardband_fanin_block": 0}
# the last fill's plan and host walls: blocks, launches, tiles run,
# edges passed, the launch loop's seconds (ending in a synchronize) and
# the gather's
FILL_STATS: dict = {}

_BM_NONE, _BX_NONE, _BY_NONE = 65535, 255, 255
_G_MASKED = 0x3F                 # 3 | 3 << 2 | 3 << 4
_H_MASKED = -1                   # 65535 | 255 << 16 | 255 << 24 as int32
_FAR = 1 << 40


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


def _shear_rows(a: np.ndarray, base: int, wloc: int) -> np.ndarray:
    """(L, R) row-major -> (wloc + R - 1, R) sheared for one shard:
    entry [d - base][j] holds a[d - j, j] for the rows base .. base +
    wloc - 1 that exist, 0 elsewhere. A diagonal of the shard is then
    one row, its lanes' columns side by side."""
    L, R = a.shape
    out = np.zeros((wloc + R - 1, R), a.dtype)
    lo, hi = max(base, 0), min(base + wloc, L)
    if hi > lo:
        st = out.strides
        np.lib.stride_tricks.as_strided(
            out[lo - base:], shape=(hi - lo, R),
            strides=(st[0], st[0] + st[1]))[...] = a[lo:hi]
    return out


# ----------------------------------------------------------------------
# launch plans
def linear_block_plan(H: int) -> dict:
    """How kernel G is launched with halo H: a CUDA block of G_THREADS
    threads, two consecutive lanes a thread, so a tile of `lanes` lanes
    whose first H are its halo and the other `tile` owned."""
    threads = G_THREADS
    if threads % 32 or not 32 <= threads <= 1024:
        raise ValueError("kernel G: %d threads is not 1 to 32 warps"
                         % threads)
    lanes = 2 * threads
    if not 1 <= H < lanes:
        raise ValueError("kernel G: halo %d leaves no owned lane in a "
                         "block of %d lanes" % (H, lanes))
    return dict(threads=threads, lanes=lanes, tile=lanes - H)


def fanin_block_plan(H: int, G: int) -> dict:
    """How kernel H is launched with halo H and ring depth G: a CUDA
    block of fanin_lanes(G) threads, one lane each, the first H the
    tile's halo and the other `tile` owned."""
    lanes = fanin_lanes(G)
    if lanes % 32 or not 32 <= lanes <= 1024 or \
            12 * (G + 1) * lanes > SHARED_BYTES:
        raise ValueError("kernel H: %d lanes with a ring of %d diagonals "
                         "do not fit a block" % (lanes, G + 1))
    if not 1 <= H < lanes:
        raise ValueError("kernel H: a ring of %d diagonals and a halo of "
                         "%d lanes leave no owned lane in shared memory"
                         % (G + 1, H))
    return dict(threads=lanes, lanes=lanes, tile=lanes - H,
                smem=12 * (G + 1) * lanes)


def fanin_lanes(G: int) -> int:
    """Kernel H's tile for ring depth G: whole warps, at most H_LANES
    (at most 1,024), whose rings fit in shared memory."""
    return min(H_LANES, SHARED_BYTES // (12 * (G + 1)) // 32 * 32)


def _row_hulls(L: int, R: int, vlo, vhi):
    """Per row i < L the diagonals [lo, hi] on which it holds a cell in
    the matrix and band (lo > hi: none); row 0 also diagonal 0, where
    M(0, 0) = 0 starts the fill."""
    i = np.arange(L, dtype=np.int64)
    if vlo is None:
        lo, hi = i.copy(), i + (R - 1)
    else:
        lo = i + np.maximum(np.asarray(vlo[:L], np.int64), 0)
        hi = i + np.minimum(np.asarray(vhi[:L], np.int64), R - 1)
    empty = lo > hi
    lo[empty], hi[empty] = _FAR, -_FAR
    lo[0], hi[0] = min(lo[0], 0), max(hi[0], 0)
    return lo, hi


def launch_plan(L: int, R: int, n_dev: int, w: int, H: int, T: int,
                K: int, d_start: int, tile: int, vlo=None, vhi=None):
    """The blocks of a band-sharded fill: diagonals d_start .. L + R - 2
    in blocks of T, each [d0, nsteps, {shard: (first tile, last tile)},
    passes, clears]. A tile (`tile` owned lanes of a shard) runs in a
    block when its lanes hold a cell there or a carry (the K diagonals
    before the block's end) that can be finite, and in the two blocks
    after that, which set both carry buffers of its lanes back to -inf
    (a shard's last tile, read by no other tile, skips them when its
    owned lanes hold the whole H-lane edge). A shard
    launches its range of running tiles. After the block, shard s >= 1
    that launches in the next one takes shard s - 1's edge lanes as its
    halo (`passes`) when the edge's carry can be finite, else -inf
    (`clears`). The plan depends on nothing but its arguments, so every
    rank of a multi-process run computes the same one."""
    last = L + R - 2
    lo, hi = _row_hulls(L, R, vlo, vhi)
    nt = -(-w // tile)
    plo = np.full(n_dev * nt * tile, _FAR, np.int64)
    phi = np.full(n_dev * nt * tile, -_FAR, np.int64)
    rows = np.arange(n_dev * w)
    keep = rows < L
    shard, own = rows[keep] // w, rows[keep] % w
    plo[shard * nt * tile + own] = lo[rows[keep]]
    phi[shard * nt * tile + own] = hi[rows[keep]]
    tlo = plo.reshape(n_dev, nt, tile).min(-1)
    thi = phi.reshape(n_dev, nt, tile).max(-1)
    nb = -(-(last + 1 - d_start) // T)
    live = tlo <= thi
    first = np.maximum((tlo - d_start) // T, 0)
    end = (thi + K - d_start) // T
    # the clearing blocks; a last tile that holds the whole edge is read
    # only through the edge, which the plan passes while it can be finite
    end[:, :-1 if w - (nt - 1) * tile >= H else None] += 2
    end = np.minimum(end, nb - 1)
    elo = np.full(n_dev, _FAR, np.int64)
    ehi = np.full(n_dev, -_FAR, np.int64)
    for s in range(1, n_dev):
        a, b = max(s * w - H, 0), min(s * w, L)
        if b > a:
            elo[s], ehi[s] = lo[a:b].min(), hi[a:b].max()
    runs = [dict() for _ in range(nb)]
    for s in range(n_dev):
        for t in map(int, np.nonzero(live[s])[0]):
            for b in range(int(first[s, t]), int(end[s, t]) + 1):
                t0, t1 = runs[b].get(s, (t, t))
                runs[b][s] = (min(t0, t), max(t1, t))
    blocks = []
    for b in range(nb):
        d0 = d_start + b * T
        d1 = min(d0 + T, last + 1)
        passes, clears = [], []
        if b + 1 < nb:
            for s in sorted(runs[b + 1]):
                if s == 0:
                    continue
                if d1 - K <= ehi[s] and d1 - 1 >= elo[s]:
                    passes.append(s)
                else:
                    clears.append(s)
        blocks.append([d0, d1 - d0, dict(sorted(runs[b].items())), passes,
                       clears])
    return blocks


def linear_launch_plan(L: int, R: int, n_dev: int, w: int, H: int,
                       band=None, tile: int | None = None):
    """launch_plan of kernel G: blocks of H diagonals from diagonal 1,
    a carry of two diagonals; `band` (vlo, vhi) per row or None, `tile`
    linear_block_plan(H)'s by default."""
    if tile is None:
        tile = linear_block_plan(H)["tile"]
    vlo, vhi = (None, None) if band is None else band
    return launch_plan(L, R, n_dev, w, H, H, 2, 1, tile, vlo, vhi)


def fanin_launch_plan(L: int, R: int, n_dev: int, w: int, H: int, G: int,
                      T: int, band=None, tile: int | None = None):
    """launch_plan of kernel H: blocks of T steps from diagonal 0, a
    carry of the ring's G diagonals."""
    if tile is None:
        tile = fanin_block_plan(H, G)["tile"]
    vlo, vhi = (None, None) if band is None else band
    return launch_plan(L, R, n_dev, w, H, T, G, 0, tile, vlo, vhi)


def plan_launches(blocks) -> int:
    """The launches of a launch plan (one a shard and block)."""
    return sum(len(b[2]) for b in blocks)


def _tiles(wloc: int, H: int, lanes: int, tiles):
    """The local lane ranges [lo, hi) of tiles t0 .. t1 (all when tiles
    is None), each cut at the shard's last lane."""
    tt = lanes - H
    nt = -(-(wloc - H) // tt)
    t0, t1 = (0, nt - 1) if tiles is None else tiles
    return [(t * tt, min(t * tt + lanes, wloc)) for t in range(t0, t1 + 1)]


# ----------------------------------------------------------------------
# kernel G: one block of diagonals of one shard of a linear pair
_LIN_TENSORS = [("cin", torch.float32), ("cout", torch.float32),
                ("codes", torch.uint8), ("corner", torch.float32),
                ("ms", torch.float32), ("gexti", torch.float32),
                ("olp", torch.float32), ("vlo", torch.int32),
                ("vhi", torch.int32), ("gj", torch.float32),
                ("orp", torch.float32)]


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


def _check_tiles(tiles, wloc: int, H: int, tile: int):
    nt = -(-(wloc - H) // tile)
    if tiles is not None and not 0 <= tiles[0] <= tiles[1] < nt:
        raise ValueError("tiles %s of a shard of %d tiles"
                         % (tuple(tiles), nt))


def _check_linear(a: dict, H: int, d0: int, nsteps: int, tiles):
    _check([(n, a[n], dt) for n, dt in _LIN_TENSORS], a["cin"])
    wloc = a["cin"].shape[1]
    w = wloc - H
    R = a["gj"].shape[0]
    want = dict(cin=(6, wloc), cout=(6, wloc), corner=(3,),
                ms=(wloc + R - 1, R), gexti=(wloc,), olp=(wloc,),
                vlo=(wloc,), vhi=(wloc,), orp=(R,))
    for name, shape in want.items():
        if tuple(a[name].shape) != shape:
            raise ValueError("%s must have shape %s, got %s"
                             % (name, shape, tuple(a[name].shape)))
    if a["codes"].dim() != 2 or a["codes"].shape[1] != w or \
            a["codes"].shape[0] < d0 + nsteps or w < 1 or H < 1 or \
            d0 < 1 or nsteps < 1 or nsteps > H:
        raise ValueError("codes %s for H %d, %d lanes, diagonals %d + %d"
                         % (tuple(a["codes"].shape), H, wloc, d0, nsteps))
    _check_tiles(tiles, wloc, H, linear_block_plan(H)["tile"])


def shardband_linear_block(cin, cout, codes, corner, ms, gexti, olp, vlo,
                           vhi, gj, orp, lng: float, lgo: float, L: int,
                           R: int, base: int, H: int, d0: int, nsteps: int,
                           tiles=None):
    """Kernel G: `nsteps` (at most H) diagonals d0, d0 + 1, ... of tiles
    tiles[0] .. tiles[1] (all when None) of one shard of a band-sharded
    linear fill, each tile linear_block_plan(H)'s `tile` owned lanes.
    cin (6, H + w) f32: M, X, Y of diagonal d0 - 1 and of d0 - 2 on the
    shard's local lanes (global lane base + l); the halo lanes [0, H)
    hold the left neighbour's values (shard 0: -inf). Writes the tiles'
    owned lanes of cout (the same six vectors after the block), the code
    of each cell in the matrix and band at codes[d] ((rows, w) uint8, bm
    | bx << 2 | by << 4, 3 where masked; other cells are left as they
    are, so codes start filled with 0x3F), and corner (3,) (M, X, Y of
    cell (L - 1, R - 1)) when the block reaches diagonal L + R - 2 on a
    tile that owns lane L - 1. Per local lane: gexti, olp (open_l of the
    row above) and the band vlo/vhi (1 and 0 on lanes outside the
    matrix); ms (wloc + R - 1, R) the folded match scores ((lng + ms) +
    lw[i]) + rw[j] sheared, entry [d - base][j] for cell (d - j, j)
    (shardband_args); per column gj (gext_j) and orp (open_r of the
    column before).

    On a CUDA tensor it launches kernel G; a launch error raises."""
    a = dict(cin=cin, cout=cout, codes=codes, corner=corner, ms=ms,
             gexti=gexti, olp=olp, vlo=vlo, vhi=vhi, gj=gj, orp=orp)
    _check_linear(a, H, d0, nsteps, tiles)
    scal = dict(lng=lng, lgo=lgo, L=L, R=R, base=base, H=H, d0=d0,
                nsteps=nsteps, tiles=tiles)
    if cin.device.type == "cpu":
        PLAIN_CALLS["shardband_linear_block"] += 1
        return shardband_linear_block_plain(**a, **scal)
    plan = linear_block_plan(H)
    t0, t1 = tiles if tiles is not None else \
        (0, -(-(cin.shape[1] - H) // plan["tile"]) - 1)
    with torch.cuda.device(cin.device):
        _launch_linear(_bind("shardband_linear_launch", 11, 10),
                       [a[n].data_ptr() for n, _ in _LIN_TENSORS],
                       lng, lgo, L, R, base, H, d0, nsteps, cin.shape[1],
                       t0, t1, plan["threads"],
                       torch.cuda.current_stream().cuda_stream)


_BOUND: dict = {}


def _bind(name: str, n_ptr: int, n_int: int):
    """A launch function of the kernels' library with its ctypes
    signature set, once a process: n_ptr pointers, lng and lgo, n_int
    ints and the stream."""
    fn = _BOUND.get(name)
    if fn is None:
        fn = getattr(kernels.load("viterbi_shardband"), name)
        fn.restype = ctypes.c_int
        fn.argtypes = [ctypes.c_void_p] * n_ptr + [ctypes.c_float] * 2 + \
            [ctypes.c_int] * n_int + [ctypes.c_void_p]
        _BOUND[name] = fn
    return fn


def _launch_linear(fn, ptrs, *scal):
    kernels.check(fn(*ptrs, *scal), "viterbi_shardband (kernel G)")
    LAUNCHES["shardband_linear_block"] += 1


def shardband_linear_block_plain(cin, cout, codes, corner, ms, gexti, olp,
                                 vlo, vhi, gj, orp, lng, lgo, L, R, base, H,
                                 d0, nsteps, tiles=None):
    """Plain PyTorch version of kernel G: the reference's shard step
    (pagan2_tpu/align/viterbi_shardband.py:119-184) on each tile of the
    block, the tile's lanes from the carry with the tile's first lane
    reading -inf on its left, one diagonal at a time."""
    lanes = linear_block_plan(H)["lanes"]
    for lo, hi in _tiles(cin.shape[1], H, lanes, tiles):
        _linear_tile(cin[:, lo:hi], cout[:, lo:hi], codes[:, lo:hi - H],
                     corner, ms[lo:], gexti[lo:hi], olp[lo:hi], vlo[lo:hi],
                     vhi[lo:hi], gj, orp, lng, lgo, L, R, base + lo, H, d0,
                     nsteps)


def _linear_tile(cin, cout, codes, corner, ms, gexti, olp, vlo, vhi, gj,
                 orp, lng, lgo, L, R, base, H, d0, nsteps):
    """One tile of shardband_linear_block_plain: cin/cout and the lane
    vectors the tile's lanes, codes its owned lanes' columns, ms the
    sheared rows from the tile's first lane on."""
    dev = cin.device
    f = torch.float32
    neg = torch.tensor(NEG, dtype=f, device=dev)
    zero = torch.zeros((), dtype=f, device=dev)
    lng = torch.tensor(lng, dtype=f, device=dev)
    lgo = torch.tensor(lgo, dtype=f, device=dev)
    ii = base + torch.arange(cin.shape[1], device=dev)
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
        gjv = torch.where(inr, gj[jc], zero)
        orv = torch.where(inr, orp[jc], zero)
        # row d - base of the sheared scores: lane l's cell is column j
        row = d - base
        wadd = ms[row, jc] if 0 <= row < ms.shape[0] else zero
        wadd = torch.where(valid, wadd, zero)
        vx, bx = first_max(shift(x1) + gjv, shift(y1) + lgo,
                           (shift(m1) + lng) + olp)
        okx = valid & (ii > 0) & torch.isfinite(vx)
        vy, by = first_max(y1 + gexti, x1 + lgo, (m1 + lng) + orv)
        oky = valid & (j > 0) & torch.isfinite(vy)
        vm, bm = first_max((shift(m2) + lng) + wadd, shift(x2) + wadd,
                           shift(y2) + wadd)
        okm = valid & (ii > 0) & (j > 0) & torch.isfinite(vm)
        X = torch.where(okx, vx, neg)
        Y = torch.where(oky, vy, neg)
        M = torch.where(okm, vm, neg)
        code = torch.where(okm, bm, _NONE) | \
            (torch.where(okx, bx, _NONE) << 2) | \
            (torch.where(oky, by, _NONE) << 4)
        codes[d] = torch.where(valid[H:], code[H:].to(torch.uint8),
                               codes[d])
        k = L - 1 - base
        if d == L + R - 2 and H <= k < cin.shape[1] and valid[k]:
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


def _check_fanin(a: dict, H: int, d0: int, nsteps: int, tiles):
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
    _check_tiles(tiles, wloc, H, fanin_block_plan(H, G)["tile"])


def shardband_fanin_block(cin, cout, codes, snap, lstate, table, loff, llw,
                          lopen, gexti, vlo, vhi, rstate, gextj, roff, rlw,
                          ropen, lng: float, lgo: float, L: int, R: int,
                          base: int, H: int, d0: int, nsteps: int,
                          tiles=None):
    """Kernel H: `nsteps` diagonals d0, d0 + 1, ... of tiles tiles[0] ..
    tiles[1] (all when None) of one shard of a band-sharded fan-in fill,
    each tile fanin_block_plan(H, G)'s `tile` owned lanes. cin
    (3, G, H + w) f32: M, X, Y of diagonal d0 - 1 - g at [:, g] on the
    shard's local lanes (global lane base + l), the halo lanes [0, H)
    the left neighbour's. Writes the tiles' owned lanes of cout (the
    same rings after the block), the code of each cell in the matrix and
    band at codes[d] ((rows, w) int32 holding the uint32 bm | bx << 16 |
    by << 24 of kernel B and the one-hot scan core; other cells are left
    as they are, so codes start filled with -1, every field masked), and
    snap (3, G, w) (the rings at diagonal L + R - 2) when the block
    reaches it. Per local lane: lstate (the row's state, an index into
    the nf x nf log-score table), loff/llw/lopen (H + w, KL) its bwd
    edges' offsets (0: no edge), log weights and open penalties, gexti,
    and the band vlo/vhi; per column: rstate, gextj and roff/rlw/ropen
    (R, KR).

    On a CUDA tensor it launches kernel H; a launch error raises."""
    a = dict(cin=cin, cout=cout, codes=codes, snap=snap, lstate=lstate,
             table=table, loff=loff, llw=llw, lopen=lopen, gexti=gexti,
             vlo=vlo, vhi=vhi, rstate=rstate, gextj=gextj, roff=roff,
             rlw=rlw, ropen=ropen)
    _check_fanin(a, H, d0, nsteps, tiles)
    scal = dict(lng=lng, lgo=lgo, L=L, R=R, base=base, H=H, d0=d0,
                nsteps=nsteps, tiles=tiles)
    if cin.device.type == "cpu":
        PLAIN_CALLS["shardband_fanin_block"] += 1
        return shardband_fanin_block_plain(**a, **scal)
    G, wloc = cin.shape[1:]
    plan = fanin_block_plan(H, G)
    t0, t1 = tiles if tiles is not None else \
        (0, -(-(wloc - H) // plan["tile"]) - 1)
    with torch.cuda.device(cin.device):
        _launch_fanin(_bind("shardband_fanin_launch", 17, 15),
                      [a[n].data_ptr() for n, _ in _FAN_TENSORS],
                      lng, lgo, L, R, base, H, d0, nsteps, wloc, G,
                      loff.shape[1], roff.shape[1], table.shape[0], t0, t1,
                      plan["threads"], plan["smem"],
                      torch.cuda.current_stream().cuda_stream)


def _launch_fanin(fn, ptrs, *scal):
    kernels.check(fn(*ptrs, *scal), "viterbi_shardband (kernel H)")
    LAUNCHES["shardband_fanin_block"] += 1


def shardband_fanin_block_plain(cin, cout, codes, snap, lstate, table, loff,
                                llw, lopen, gexti, vlo, vhi, rstate, gextj,
                                roff, rlw, ropen, lng, lgo, L, R, base, H,
                                d0, nsteps, tiles=None):
    """Plain PyTorch version of kernel H: the reference's fan-in shard
    step (pagan2_tpu/align/viterbi_shardband.py:400-521) on each tile of
    the block, a tile's lanes reading -inf left of its first lane, one
    diagonal at a time."""
    G, wloc = cin.shape[1:]
    lanes = fanin_block_plan(H, G)["lanes"]
    for lo, hi in _tiles(wloc, H, lanes, tiles):
        _fanin_tile(cin[:, :, lo:hi], cout[:, :, lo:hi],
                    codes[:, lo:hi - H], snap[:, :, lo:hi - H],
                    lstate[lo:hi], table, loff[lo:hi], llw[lo:hi],
                    lopen[lo:hi], gexti[lo:hi], vlo[lo:hi], vhi[lo:hi],
                    rstate, gextj, roff, rlw, ropen, lng, lgo, L, R,
                    base + lo, H, d0, nsteps)


def _fanin_tile(cin, cout, codes, snap, lstate, table, loff, llw, lopen,
                gexti, vlo, vhi, rstate, gextj, roff, rlw, ropen, lng, lgo,
                L, R, base, H, d0, nsteps):
    """One tile of shardband_fanin_block_plain (its lanes' slices)."""
    dev = cin.device
    f = torch.float32
    neg = torch.tensor(NEG, dtype=f, device=dev)
    zero = torch.zeros((), dtype=f, device=dev)
    lng = torch.tensor(lng, dtype=f, device=dev)
    lgo = torch.tensor(lgo, dtype=f, device=dev)
    G, wloc = cin.shape[1:]
    nf = table.shape[0]
    li = torch.arange(wloc, device=dev)
    ii = base + li
    ring = cin.clone()                   # ring[:, g]: diagonal d - 1 - g
    loff = loff.long()

    lanes = li[:, None]

    def src(g, sh, ok):
        """(M, X, Y) of ring depth g (1 = the last diagonal) on lane
        li - sh, each (wloc, ...) like g; -inf where not `ok`, outside
        the ring or off the tile's left edge."""
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
        code = torch.where(code >= 2 ** 31, code - 2 ** 32, code)
        codes[d] = torch.where(valid[H:], code[H:].to(torch.int32),
                               codes[d])
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
    overlapped (halo + owned) lane arrays and its sheared folded match
    scores, the column vectors every shard reads, and the scalars.
    Returns (per-shard dicts, meta)."""
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
    # the scan core's fold, in its order, at f32: ((lng + ms) + lw) + rw
    lw = np.asarray(inp["lw"], dtype)[:L]
    rw = np.asarray(inp["rw"], dtype)[:R]
    fold = ((dtype(inp["lng"]) + np.asarray(inp["ms"], dtype)[:L, :R])
            + lw[:, None]) + rw[None, :]
    lanes = dict(
        gexti=ov(inp["gext_i"], 0.0),
        olp=ov(np.concatenate([[0.0], inp["open_l"][:-1]]).astype(dtype),
               0.0),
        # lanes outside the matrix: an empty interval
        vlo=ov(vlo, 1), vhi=ov(vhi, 0))
    cols = dict(gj=np.asarray(inp["gext_j"], dtype),
                orp=np.asarray(inp["open_r_shifted"], dtype))
    shards = [dict({k: v[s] for k, v in lanes.items()}, **cols,
                   ms=_shear_rows(fold, s * w - H, H + w))
              for s in range(n_dev)]
    meta = dict(L=L, R=R, w=w, W=W, H=H, inp=inp, band=(vlo, vhi),
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


def _run_blocks(mesh, st, blocks, edge, kind: str, block):
    """The block loop of a band-sharded fill: per block each of this
    rank's shards that the plan launches runs kernel G or H (`kind`,
    through _launcher) on its state u and swaps its carries; then the
    plan's halos are passed (`edge(carry)` gives (edge lanes, halo
    lanes) views) or set to -inf. The loop runs under the device of its
    shards when they share one, else each launch under its own. Ends in
    a synchronize of every device; FILL_STATS gets the counts and the
    loop's host wall."""
    from ..parallel.multihost import pass_edges
    devs = {u["cur"].device for u in st.values()}
    one = len(devs) == 1
    launch = _launcher(kind, st, block, one)
    dev0 = next(iter(devs))
    t = time.perf_counter()
    with torch.cuda.device(dev0) if one and dev0.type == "cuda" \
            else contextlib.nullcontext():
        n_launch = n_tiles = n_pass = 0
        for d0, nsteps, runs, passes, clears in blocks:
            for s, tiles in runs.items():
                u = st.get(s)
                if u is None:
                    continue
                launch(u, d0, nsteps, tiles)
                u["cur"], u["nxt"] = u["nxt"], u["cur"]
                n_launch += 1
                n_tiles += tiles[1] - tiles[0] + 1
            if passes:
                views = {s: edge(u["cur"]) for s, u in st.items()}
                pass_edges(mesh, {s: v[0] for s, v in views.items()},
                           {s: v[1] for s, v in views.items()}, passes)
                n_pass += len(passes)
            for s in clears:
                if s in st:
                    edge(st[s]["cur"])[1].fill_(NEG)
        for dev in devs:
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)
    FILL_STATS.clear()
    FILL_STATS.update(blocks=len(blocks), launches=n_launch, tiles=n_tiles,
                      passes=n_pass, loop_s=time.perf_counter() - t)


def _launcher(kind: str, st: dict, block, one_device: bool):
    """launch(u, d0, nsteps, tiles) for _run_blocks: `block` (a
    callable taking the public wrapper's keywords) when given; on CPU
    tensors the plain version; on CUDA tensors kernel G or H through its
    ctypes function, bound once, the arguments checked once a fill;
    under the caller's device context when `one_device`, else each
    launch under its shard's."""
    public = shardband_linear_block if kind == "linear" else \
        shardband_fanin_block
    plain = shardband_linear_block_plain if kind == "linear" else \
        shardband_fanin_block_plain
    names = _LIN_TENSORS if kind == "linear" else _FAN_TENSORS
    out_key = "corner" if kind == "linear" else "snap"

    def kwargs(u, d0, nsteps, tiles):
        return dict(cin=u["cur"], cout=u["nxt"], codes=u["codes"],
                    **{out_key: u[out_key]}, **u["args"], **u["scal"],
                    d0=d0, nsteps=nsteps, tiles=tiles)
    if block is not None:
        return lambda u, d0, nsteps, tiles: block(
            **kwargs(u, d0, nsteps, tiles))
    first = next(iter(st.values()))
    if first["cur"].device.type == "cpu":
        def run_plain(u, d0, nsteps, tiles):
            PLAIN_CALLS[public.__name__] += 1
            plain(**kwargs(u, d0, nsteps, tiles))
        return run_plain
    # the checks of the public wrapper, once a shard, on its first block
    for u in st.values():
        kw = kwargs(u, 1, 1, None)
        (_check_linear if kind == "linear" else _check_fanin)(
            {n: kw[n] for n, _ in names}, kw["H"], 1, 1, None)
    fn = _bind("shardband_%s_launch" % kind, len(names),
               10 if kind == "linear" else 15)
    for u in st.values():
        u["ptrs"] = [u["args"][n].data_ptr() if n in u["args"] else None
                     for n, _ in names]
        with torch.cuda.device(u["cur"].device):
            u["stream"] = torch.cuda.current_stream().cuda_stream

    def ptrs(u):
        p = list(u["ptrs"])
        p[0], p[1], p[2], p[3] = (u["cur"].data_ptr(), u["nxt"].data_ptr(),
                                  u["codes"].data_ptr(),
                                  u[out_key].data_ptr())
        return p

    def run_kernel(u, d0, nsteps, tiles):
        c = u["scal"]
        if kind == "linear":
            scal = (c["lng"], c["lgo"], c["L"], c["R"], c["base"], c["H"],
                    d0, nsteps, u["wloc"], tiles[0], tiles[1],
                    u["plan"]["threads"], u["stream"])
            go = _launch_linear
        else:
            scal = (c["lng"], c["lgo"], c["L"], c["R"], c["base"], c["H"],
                    d0, nsteps, u["wloc"], u["G"], u["KL"], u["KR"],
                    u["nf"], tiles[0], tiles[1], u["plan"]["threads"],
                    u["plan"]["smem"], u["stream"])
            go = _launch_fanin
        if one_device:
            go(fn, ptrs(u), *scal)
        else:
            with torch.cuda.device(u["cur"].device):
                go(fn, ptrs(u), *scal)
    return run_kernel


def shardband_fill(mesh, shards, meta, block=None):
    """The band-sharded linear fill of shardband_args' prep over the
    mesh's shards, on linear_launch_plan's blocks: one kernel G launch a
    shard that holds cells and block of H diagonals (its CUDA blocks:
    linear_block_plan), the halo edges passed on after each block.
    `block`, when given, takes every launch in the public wrapper's
    place. Returns (codes (L + R - 1, W) uint8 in the sheared layout,
    row 0 all 0x3F; corner (3,) f32), the same on every rank; FILL_STATS
    gets the plan's counts and the host walls."""
    L, R, w, H = meta["L"], meta["R"], meta["w"], meta["H"]
    n = mesh.size
    wloc = H + w
    last = L + R - 2
    plan = linear_block_plan(H)
    blocks = linear_launch_plan(L, R, n, w, H, band=meta.get("band"),
                                tile=plan["tile"])
    st = {}
    for s in range(n):
        if not mesh.is_local(s):
            continue
        dev = mesh.devices[s]
        base = s * w - H
        c0 = torch.full((6, wloc), NEG, dtype=torch.float32, device=dev)
        if 0 <= -base < wloc:
            c0[0, -base] = 0.0           # M of cell (0, 0), diagonal 0
        st[s] = dict(cur=c0, nxt=torch.full_like(c0, NEG),
                     codes=torch.full((last + 1, w), _G_MASKED,
                                      dtype=torch.uint8, device=dev),
                     corner=torch.full((3,), NEG, dtype=torch.float32,
                                       device=dev),
                     args=_to(shards[s], dev), wloc=wloc, plan=plan,
                     scal=dict(lng=meta["lng"], lgo=meta["lgo"], L=L, R=R,
                               base=base, H=H))
    _run_blocks(mesh, st, blocks, lambda c: (c[:, w:w + H], c[:, :H]),
                "linear", block)
    t = time.perf_counter()
    codes, corners = _gather_lanes(
        mesh, {s: [u["codes"], u["corner"][:, None]]
               for s, u in st.items()})
    FILL_STATS["gather_s"] = time.perf_counter() - t
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
    return shards, dict(L=L, R=R, w=w, W=Wt, H=H, band=(vlo, vhi),
                        lng=float(inp["lng"]), lgo=float(inp["lgo"]))


def shardband_fanin_fill(mesh, shards, meta, G: int, T: int, block=None):
    """The band-sharded fan-in fill over the mesh's shards, on
    fanin_launch_plan's blocks: one kernel H launch a shard that holds
    cells and block of T steps (its CUDA blocks: fanin_block_plan),
    the halo edges of every ring plane passed on after each block.
    `block`, when given, takes every launch in the public wrapper's
    place. Returns (codes (L + R - 1, W) uint32, snaps (3, G, W) f32),
    the same on every rank; FILL_STATS gets the plan's counts and the
    host walls."""
    L, R, w, H = meta["L"], meta["R"], meta["w"], meta["H"]
    wloc = H + w
    last = L + R - 2
    plan = fanin_block_plan(H, G)
    blocks = fanin_launch_plan(L, R, mesh.size, w, H, G, T,
                               band=meta.get("band"), tile=plan["tile"])
    st = {}
    for s in range(mesh.size):
        if not mesh.is_local(s):
            continue
        dev = mesh.devices[s]
        c0 = torch.full((3, G, wloc), NEG, dtype=torch.float32, device=dev)
        args = _to(shards[s], dev)
        st[s] = dict(cur=c0, nxt=torch.full_like(c0, NEG),
                     codes=torch.full((last + 1, w), _H_MASKED,
                                      dtype=torch.int32, device=dev),
                     snap=torch.full((3, G, w), NEG, dtype=torch.float32,
                                     device=dev),
                     args=args, wloc=wloc, plan=plan, G=G,
                     KL=args["loff"].shape[1], KR=args["roff"].shape[1],
                     nf=args["table"].shape[0],
                     scal=dict(lng=meta["lng"], lgo=meta["lgo"], L=L, R=R,
                               base=s * w - H, H=H))
    _run_blocks(mesh, st, blocks,
                lambda c: (c[:, :, w:w + H], c[:, :, :H]), "fanin", block)
    t = time.perf_counter()
    codes, snaps = _gather_lanes(mesh, {s: [u["codes"], u["snap"]]
                                        for s, u in st.items()})
    FILL_STATS["gather_s"] = time.perf_counter() - t
    return codes.view(np.uint32), snaps


def fanin_halo(H: int, G: int, w: int) -> int:
    """The exchange width of a fan-in fill: H, at most the owned lanes
    of a shard and half of kernel H's tile for ring depth G."""
    return max(1, min(H, w, fanin_lanes(G) // 2))


def shardband_fanin_align_path(left, right, model, settings, mesh,
                               left_branch_length: float = 0.0,
                               right_branch_length: float = 0.0, band=None,
                               H: int = HALO):
    """Band-sharded fill + host backtrack of one giant FAN-IN pair over
    the mesh's shards, bit-identical to the one-hot fan-in scan core;
    a band that dead-ends is filled again over the full matrix. Raises
    ValueError past the one-hot caps, and when a left bridge edge spans
    more lanes than the halo or than BRIDGE_LANES (the executor then
    runs the pair unsharded)."""
    from .viterbi_fanin import prepare_fanin, finish_fanin, K_CAP
    n = mesh.size
    inp = prepare_fanin(left, right, model, settings, np.float32)
    L, R = inp["L"], inp["R"]
    KL, KR = inp["KL"], inp["KR"]
    OLm, ORm = max(inp["OL"], 1), max(inp["OR"], 1)
    G = _g_bucket(OLm + ORm)
    H = fanin_halo(H, G, _lane_split(L, n))
    if KL > K_CAP or KR > K_CAP:
        raise ValueError("fan-in beyond the one-hot caps")
    # a step reads at most OLm lanes to the left, so T = H // OLm steps
    # consume the halo; a LEFT bridge wider than H would read past it,
    # and one wider than BRIDGE_LANES runs unsharded, as in the JAX
    # package. Right offsets only select ring depth: ORm needs no lane
    # budget.
    if OLm > min(H, BRIDGE_LANES):
        raise ValueError("left bridge offset %d exceeds the %d-lane halo "
                         "budget" % (OLm, min(H, BRIDGE_LANES)))
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
