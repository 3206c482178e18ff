"""Kernel A: the linear-chain Viterbi wavefront (csrc/viterbi_linear.cu),
its plain PyTorch version, and the prep that feeds both.

Replaces pagan2_tpu/align/viterbi_pallas.py (`_kernel` via
`pallas_fill`, the prep of `pallas_job_arrays` and
`_add_scalar_params`). The fill keeps the Pallas kernel's f32 add order
(the match score pre-folded as ((ms + lw[i]) + rw[j]) + lng; X opens as
(m + lng) + ol, Y as (m + lng) + orp; M = max(m + lng, x, y) + folded)
and its strict first-wins codes, so codes and corner scores are
bit-identical to it. Codes are plain uint8 at the target cell, row d =
diagonal d (row 0 is the 0x3F sentinel), the layout
viterbi_sheared._ShearedCells reads.

A batch of pair-end jobs takes the kernel's pair-end build (the
reference fills such pairs on its scan core, viterbi_sheared.py:450-455:
a j-side break column, and M's candidates compared after the match
score is added, which it folds as ((lng + ms) + lw[i]) + rw[j]).

Device rule: a CPU tensor takes `linear_fill_plain`; a CUDA tensor
launches the kernel or raises.
"""
from __future__ import annotations

import ctypes

import numpy as np
import torch

from .. import kernels
from .oracle import PathPtr
from .viterbi_sheared import (prepare_sheared, _ShearedCells,
                              _end_corner_linear, NEG)
from .backtrack import _backtrack_arrays

LAUNCHES = 0          # kernel A launches (one per linear_fill on CUDA)
PAIR_END_LAUNCHES = 0  # those of them in the pair-end build
TILE_LAUNCHES = 0     # those of them in the tiled build
PLAIN_CALLS = 0       # linear_fill_plain calls made by linear_fill

_BIG = np.int32(2 ** 30)     # "never valid" lower bound sentinel
# kernel A's lane builds: rows a thread and the most rows each is planned
# for; past the last, the tiled build (on the H100 it beat the four rows
# a thread that ran 2,049-4,096 rows by 12-37% on 8-pair batches there,
# tools/bench_linear_calls.py --lanes)
LANES = ((1, 128), (2, 2048))
# the tiled build's tile, threads of two rows, in the ordinary and in the
# pair-end build (tools/bench_linear_calls.py --giant --tiles); its
# hand-off is released every 32 diagonals (CHUNK in csrc/viterbi_linear.cu)
TILE_THREADS = 256
PAIR_END_TILE_THREADS = 128


def _add_scalar_params(inp):
    """Derive the scalar penalty params linear_job_arrays needs from a
    prepare_sheared dict: gap-ext, terminal gap-ext, open_r[0], and for
    a pair-end job (the dict's "pair_end") its break column jbrk (the
    dict's "jbrk", -1 for none) with its gap-ext gbrk and its open obrk
    (open_r[jbrk]). Kernel A rebuilds the j-side vectors from these
    scalars, so they are rebuilt here too and held equal to gext_j and
    open_r: any other j-side difference raises ValueError."""
    R = inp["R"]
    gj = np.asarray(inp["gext_j"])
    orp = np.asarray(inp["open_r_shifted"])[1:]   # open_r[0 .. R-2]
    jb = int(inp.get("jbrk", -1))
    inp["pair_end"] = pe = bool(inp.get("pair_end", False))
    if not -1 <= jb < R or (jb >= 0 and not pe):
        raise ValueError("break column %d of a %s job with %d columns"
                         % (jb, "pair-end" if pe else "non-pair-end", R))
    # each scalar read at a column the break does not overwrite; one
    # with no such column is used by no column of the matrix
    ends = [c for c in (0, R - 1) if c != jb]
    inp["gend"] = float(gj[ends[0]] if ends else gj[0])
    mids = [c for c in (1, 2) if 0 < c < R - 1 and c != jb]
    inp["gext"] = float(gj[mids[0]]) if mids else inp["gend"]
    # open_r[0] == open_l[0] (both 0.0 under reduced terminal penalties)
    inp["orp0"] = float(orp[0]) if R > 1 and jb != 0 else \
        float(inp["open_l"][0])
    inp["jbrk"] = jb
    inp["gbrk"] = float(gj[jb]) if jb >= 0 else 0.0
    inp["obrk"] = float(orp[jb]) if 0 <= jb < R - 1 else float(inp["lgo"])
    want_j = np.full(R, inp["gext"], gj.dtype)
    want_j[[0, R - 1]] = inp["gend"]
    want_o = np.full(R, inp["lgo"], orp.dtype)
    want_o[0] = inp["orp0"]
    if jb >= 0:
        want_j[jb] = inp["gbrk"]
        want_o[jb] = inp["obrk"]
    bad = np.flatnonzero((gj != want_j) | np.append(orp != want_o[:R - 1],
                                                    False))
    if len(bad):
        raise ValueError("j-side penalties differ from kernel A's scalar "
                         "form (break column %d) at columns %s"
                         % (jb, bad[:8].tolist()))
    return inp


def batch_rows(inps) -> int:
    """Row count Lp of a kernel A batch of prepare_sheared dicts: the
    longest left side, rounded up to a whole warp."""
    return -(-max(x["L"] for x in inps) // 32) * 32


def linear_job_arrays(inp, Lp: int, band=None):
    """Per-job host arrays for one row of a linear_fill batch, from a
    prepare_sheared dict (f32) with _add_scalar_params applied. The
    match-score table stays (L, R); linear_batch_args folds and shears
    it on the device."""
    dtype = np.float32
    L, R = inp["L"], inp["R"]
    gexti = np.zeros(Lp, dtype)
    gexti[:L] = inp["gext_i"]
    ol = np.zeros(Lp, dtype)
    ol[:L] = inp["open_l"]

    # per-matrix valid-column lower bounds: X needs i>0 (fold into
    # row 0), Y/M need j>0 (fold into the bound); rows >= L never
    # valid. vhi is the shared upper bound.
    lo = np.zeros(Lp, np.int64)
    hi = np.full(Lp, R - 1, np.int64)
    if band is not None:
        upper, lower = band
        lo[:L] = np.maximum(np.asarray(upper[:L], np.int64), 0)
        hi[:L] = np.minimum(np.asarray(lower[:L], np.int64), R - 1)
    vlox = np.minimum(lo, _BIG).astype(np.int32)
    vlox[0] = _BIG
    vlox[L:] = _BIG
    vloy = np.maximum(lo, 1)
    vloy = np.minimum(vloy, _BIG).astype(np.int32)
    vloy[L:] = _BIG
    vhi = np.full(Lp, -1, np.int32)
    vhi[:L] = hi[:L].astype(np.int32)

    fscal = np.array([inp["gext"], inp["gend"], inp["lgo"], inp["lng"],
                      inp["orp0"], inp["gbrk"], inp["obrk"], 0], dtype)
    iscal = np.array([L, R, inp["jbrk"], int(inp["pair_end"]), 0, 0, 0, 0],
                     np.int32)
    return dict(ms=np.asarray(inp["ms"], dtype),
                lw=np.asarray(inp["lw"], dtype),
                rw=np.asarray(inp["rw"], dtype),
                lng=dtype(inp["lng"]),
                gexti=gexti, ol=ol, vlox=vlox, vloy=vloy, vhi=vhi,
                fscal=fscal, iscal=iscal)


def shear_table(tab, Lp: int, D: int):
    """(L, R) table -> (D, Lp) diagonal-major: out[d, i] = tab[i, d - i],
    the column clamped to [0, R] with column R reading 0 (rows >= L read
    0 too); the fills mask what lies outside the matrix. Gathered a block
    of diagonals at a time, so the index tensors stay near 2**27
    elements whatever the table (65,536 rows x 66,559 diagonals would
    need 35 GB of them at once)."""
    L, R = tab.shape
    pad = torch.zeros((Lp, R + 1), dtype=tab.dtype, device=tab.device)
    pad[:L, :R] = tab
    out = torch.empty((D, Lp), dtype=tab.dtype, device=tab.device)
    i = torch.arange(Lp, device=tab.device)[None, :]
    step = max(1, (1 << 27) // max(Lp, 1))
    for d0 in range(0, D, step):
        d = torch.arange(d0, min(d0 + step, D), device=tab.device)[:, None]
        j = torch.clamp(d - i, 0, R)
        out[d0:d0 + len(d)] = pad[i.expand(len(d), Lp), j]
    return out


def fold_shear(ms, lw, rw, lng, Lp: int, D: int, pair_end: bool = False):
    """((ms + lw[i]) + rw[j]) + lng, sheared to (D, Lp): row d holds
    cell (i, d - i); cells outside the (L, R) table read 0 (masked by
    the fill). A pair-end job folds in the order of the reference's
    scan core, ((lng + ms) + lw[i]) + rw[j]."""
    if pair_end:
        return shear_table(((lng + ms) + lw[:, None]) + rw[None, :], Lp, D)
    return shear_table(((ms + lw[:, None]) + rw[None, :]) + lng, Lp, D)


def linear_batch_args(jobs: list, device, D: int | None = None):
    """Kernel A arguments for a batch of linear_job_arrays dicts (all
    padded to the same Lp) on `device`; `pair_end` says whether the
    batch's jobs are pair-end jobs (a batch of both kinds raises
    ValueError: kernel A takes one build a launch)."""
    dev = torch.device(device)
    Lp = len(jobs[0]["gexti"])
    kinds = {bool(j["iscal"][3]) for j in jobs}
    if len(kinds) != 1:
        raise ValueError("a kernel A batch of pair-end and other jobs")
    pair_end = kinds.pop()
    if D is None:
        D = max(int(j["iscal"][0] + j["iscal"][1]) for j in jobs) - 1
    D = max(D, 2)

    def stack(key, dt):
        return torch.from_numpy(
            np.ascontiguousarray(np.stack([j[key] for j in jobs]), dt)
        ).to(dev)

    ms = torch.empty((len(jobs), D, Lp), dtype=torch.float32, device=dev)
    for b, j in enumerate(jobs):
        ms[b] = fold_shear(torch.from_numpy(j["ms"]).to(dev),
                           torch.from_numpy(j["lw"]).to(dev),
                           torch.from_numpy(j["rw"]).to(dev),
                           torch.tensor(j["lng"], dtype=torch.float32,
                                        device=dev), Lp, D, pair_end)
    return dict(ms=ms, gexti=stack("gexti", np.float32),
                ol=stack("ol", np.float32),
                vlox=stack("vlox", np.int32), vloy=stack("vloy", np.int32),
                vhi=stack("vhi", np.int32),
                fscal=stack("fscal", np.float32),
                iscal=stack("iscal", np.int32), pair_end=pair_end)


# ----------------------------------------------------------------------
def _check_args(ms, gexti, ol, vlox, vloy, vhi, fscal, iscal):
    if ms.dim() != 3:
        raise ValueError("ms must be (B, D, Lp)")
    B, D, Lp = ms.shape
    want = [("ms", ms, torch.float32, (B, D, Lp)),
            ("gexti", gexti, torch.float32, (B, Lp)),
            ("ol", ol, torch.float32, (B, Lp)),
            ("vlox", vlox, torch.int32, (B, Lp)),
            ("vloy", vloy, torch.int32, (B, Lp)),
            ("vhi", vhi, torch.int32, (B, Lp)),
            ("fscal", fscal, torch.float32, (B, 8)),
            ("iscal", iscal, torch.int32, (B, 8))]
    for name, t, dt, shape in want:
        if t.dtype != dt:
            raise TypeError("%s must be %s, got %s" % (name, dt, t.dtype))
        if tuple(t.shape) != shape:
            raise ValueError("%s must have shape %s, got %s"
                             % (name, shape, tuple(t.shape)))
        if not t.is_contiguous():
            raise ValueError("%s must be contiguous" % name)
        if t.device != ms.device:
            raise ValueError("%s is on %s, ms on %s"
                             % (name, t.device, ms.device))
    if ms.device.type not in ("cpu", "cuda"):
        raise ValueError("unsupported device %s" % ms.device)
    return B, D, Lp


def _block(lanes: int, rows: int) -> int:
    """Threads of a block whose threads own `rows` lanes (rows) each:
    whole warps, enough for `lanes` (kernels A, D and E)."""
    return -(-lanes // (rows * 32)) * 32


def linear_plan(Lp: int, pair_end: bool = False) -> dict:
    """How kernel A is launched on Lp rows (in its pair-end build when
    `pair_end`):

    - rows: rows a thread, each thread's rows consecutive, their M, X, Y
      in registers from one diagonal to the next (LANES: 1 up to 128
      rows, 2 up to 2048; on the H100, tools/bench_linear_calls.py
      --lanes, one row a thread led at 64 and 128 rows, two from 256 to
      2,048, and the tiled build past that);
    - threads: the block, whole warps, at most 1024;
    - diagonals: "registers", a lane build (one block a job; a shared
      row of warp-edge values between warps), or "tiles", the tiled
      build past 2048 rows and on rows that are not a whole number of
      warps (no caller makes such a batch: batch_rows rounds up to a
      warp): tiles of `threads` threads x 2 rows (TILE_THREADS, or
      PAIR_END_TILE_THREADS in the pair-end build), many a job on many
      SMs, each running only its live diagonals, the last row of a tile
      handed to the next through device memory (tile_plan lists the
      tiles)."""
    rows = next((r for r, top in LANES if Lp <= top), 0) \
        if Lp % 32 == 0 else 0
    if rows:
        return dict(rows=rows, threads=_block(Lp, rows),
                    diagonals="registers")
    return tiled_plan(PAIR_END_TILE_THREADS if pair_end else TILE_THREADS)


def tiled_plan(threads: int) -> dict:
    """The tiled build's plan: tiles of `threads` threads x 2 rows."""
    return dict(rows=2, threads=threads, diagonals="tiles")


def has_lane_build(plan, Lp: int, lanes=LANES) -> bool:
    """Whether `plan` is a lane build on Lp rows: rows a thread of
    `lanes` (kernel A's LANES, or kernel F's) in whole warps, the block
    holding every row."""
    rows, threads = plan["rows"], plan["threads"]
    return rows in tuple(r for r, _top in lanes) and \
        32 <= threads <= 1024 and threads % 32 == 0 and \
        Lp % 32 == 0 and rows * threads >= Lp and \
        plan["diagonals"] == "registers"


def has_build(plan, Lp: int) -> bool:
    """Whether kernel A has a build for `plan` on Lp rows: a lane build,
    or the tiled build (two rows a thread, tiles of whole warps up to
    1024 threads) on any Lp."""
    if plan["diagonals"] != "tiles":
        return has_lane_build(plan, Lp)
    threads = plan["threads"]
    return set(plan) == {"rows", "threads", "diagonals"} and \
        plan["rows"] == 2 and 32 <= threads <= 1024 and threads % 32 == 0


def tile_plan(LR, Lp: int, D: int, threads: int) -> list:
    """The tiled build's tiles for jobs of (L, R) = LR on Lp rows and D
    diagonals, in the order blocks claim them (ticket t = job * ntiles +
    tile, so a tile's predecessor has the ticket before it): per tile
    its job and index, its rows [r0, r1], whether it is live (r0 <= L:
    a cell of it has a source in the matrix), its live diagonals
    (first, last) (None when not live), and whether it hands its last
    row on (its successor is live)."""
    rows = 2 * threads
    ntiles = -(-Lp // rows)
    out = []
    for b, (L, R) in enumerate(LR):
        for k in range(ntiles):
            r0 = k * rows
            r1 = min(r0 + rows, Lp) - 1
            live = r0 <= L
            out.append(dict(
                ticket=b * ntiles + k, job=b, tile=k, rows=(r0, r1),
                live=live,
                diagonals=(max(r0, 1), min(D - 1, min(r1, L) + R))
                if live else None,
                feeds=k + 1 < ntiles and r0 + rows <= L))
    return out


def _launch_linear(plan, ms, gexti, ol, vlox, vloy, vhi, fscal, iscal,
                   pair_end=False):
    """One launch of kernel A as `plan` (linear_plan) says, in its
    pair-end build when `pair_end`. A plan with no build raises
    ValueError before anything is launched."""
    B, D, Lp = ms.shape
    rows, threads = plan["rows"], plan["threads"]
    if not has_build(plan, Lp):
        raise ValueError("kernel A has no build for the plan %s on %d rows"
                         % (plan, Lp))
    tiled = plan["diagonals"] == "tiles"
    lib = kernels.load("viterbi_linear")
    fn = lib.viterbi_linear_launch
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * 12 + [ctypes.c_int] * 7 + \
        [ctypes.c_void_p]
    codes = torch.empty((B, D, Lp), dtype=torch.uint8, device=ms.device)
    corner = torch.empty((B, 3), dtype=torch.float32, device=ms.device)
    edges = flags = None
    if tiled:
        # per ticket its last row's M, X, Y (and a pad) by column, at most
        # D columns: 16 / (2 * threads) bytes a byte of codes
        n = B * -(-Lp // (2 * threads))
        edges = torch.empty((n, D, 4), dtype=torch.float32,
                            device=ms.device)
        flags = torch.empty(1 + n, dtype=torch.int32, device=ms.device)
    with torch.cuda.device(ms.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(ms.data_ptr(), gexti.data_ptr(), ol.data_ptr(),
                 vlox.data_ptr(), vloy.data_ptr(), vhi.data_ptr(),
                 fscal.data_ptr(), iscal.data_ptr(), codes.data_ptr(),
                 corner.data_ptr(), 0 if edges is None else edges.data_ptr(),
                 0 if flags is None else flags.data_ptr(), B, D, Lp, rows,
                 threads, int(tiled), int(bool(pair_end)), stream)
    kernels.check(err, "viterbi_linear")
    return codes, corner


def linear_fill(ms, gexti, ol, vlox, vloy, vhi, fscal, iscal,
                pair_end=None):
    """Fill a batch of linear-chain pairs. ms: (B, D, Lp) f32 folded
    match-score diagonals (row d = diagonal d); per-row vectors (B, Lp);
    fscal (B, 8) f32 [gext, gend, lgo, lng, orp0, gbrk, obrk]; iscal
    (B, 8) int32 [L, R, jbrk, pair-end]; pair_end: whether the batch's
    jobs are pair-end jobs (linear_batch_args says so; None reads
    iscal). Returns (codes (B, D, Lp) uint8, corner (B, 3) f32: M, X, Y
    at cell (L-1, R-1)).

    A pair-end job (the reference's pair-end Viterbi fill is its scan
    core, viterbi_sheared.py:450-455) takes its break column (jbrk >= 0:
    X extends there by gbrk, Y opens from there by obrk) and compares
    M's three candidates after the match score is added, first wins on
    a tie, as that core does; its match score comes folded in that
    core's order (fold_shear).

    On a CUDA tensor it launches kernel A as linear_plan(Lp, pair_end)
    says; the kernel refuses a plan it has no build for, and the wrapper
    raises on any launch error. The inputs are linear_job_arrays' (rows >= L and
    columns >= R never valid): kernel A skips the warps (and the tiled
    build the tiles and diagonals) whose cells have no source in the
    matrix on that rule."""
    global LAUNCHES, PLAIN_CALLS, PAIR_END_LAUNCHES, TILE_LAUNCHES
    B, D, Lp = _check_args(ms, gexti, ol, vlox, vloy, vhi, fscal, iscal)
    if ms.device.type == "cpu":
        PLAIN_CALLS += 1
        return linear_fill_plain(ms, gexti, ol, vlox, vloy, vhi, fscal,
                                 iscal)
    if pair_end is None:
        pe = iscal[:, 3] != 0
        pair_end = bool(pe.any())
        if pair_end != bool(pe.all()):
            raise ValueError("a kernel A batch of pair-end and other jobs")
    plan = linear_plan(Lp, pair_end)
    out = _launch_linear(plan, ms, gexti, ol, vlox, vloy, vhi, fscal,
                         iscal, pair_end)
    LAUNCHES += 1
    PAIR_END_LAUNCHES += bool(pair_end)
    TILE_LAUNCHES += plan["diagonals"] == "tiles"
    return out


def linear_fill_plain(ms, gexti, ol, vlox, vloy, vhi, fscal, iscal,
                      pair_end=None):
    """Plain PyTorch version of kernel A: a loop over diagonals on
    (B, Lp) tensors in the same add order and first-wins rule. Each
    job's kind (pair-end or not) and break column are read from iscal,
    whatever `pair_end` says."""
    B, D, Lp = ms.shape
    dev = ms.device
    f = torch.float32
    neg = torch.tensor(NEG, dtype=f, device=dev)
    gext, gend, lgo, lng, orp0, gbrk, obrk = (fscal[:, k:k + 1]
                                              for k in range(7))
    R = iscal[:, 1:2].long()
    pe = iscal[:, 3:4] != 0
    jbrk = iscal[:, 2:3].long()
    # no break column: a column no j meets
    jbrk = torch.where(pe & (jbrk >= 0), jbrk,
                       torch.full_like(jbrk, -2 ** 40))
    ii = torch.arange(Lp, device=dev)[None, :]

    def shift(v, fill):
        # row i <- row i-1 (predecessor row); row 0 reads `fill`
        return torch.cat([torch.full((B, 1), fill, dtype=v.dtype,
                                     device=dev), v[:, :-1]], dim=1)

    ol_prev = shift(ol, 0.0)
    m1 = torch.where(ii == 0, torch.zeros((), dtype=f, device=dev),
                     neg).expand(B, Lp).contiguous()
    x1 = torch.full((B, Lp), NEG, dtype=f, device=dev)
    y1 = x1.clone()
    m2, x2, y2 = x1.clone(), x1.clone(), x1.clone()
    codes = torch.empty((B, D, Lp), dtype=torch.uint8, device=dev)
    codes[:, 0] = 0x3F
    corner = torch.full((B, 3), NEG, dtype=f, device=dev)
    # per-job corner diagonal and row, read once on the host
    lr = iscal[:, :2].cpu().tolist()
    for d in range(1, D):
        j = d - ii
        m1p, x1p, y1p = shift(m1, NEG), shift(x1, NEG), shift(y1, NEG)
        m2p, x2p, y2p = shift(m2, NEG), shift(x2, NEG), shift(y2, NEG)
        gj = torch.where((j == 0) | (j == R - 1), gend, gext)
        gj = torch.where(j == jbrk, gbrk, gj)
        cx0 = x1p + gj
        cx1 = y1p + lgo
        cx2 = (m1p + lng) + ol_prev
        v01 = torch.maximum(cx0, cx1)
        xc = torch.maximum(v01, cx2)
        bx = torch.where(cx2 > v01, 2, torch.where(cx1 > cx0, 1, 0))
        orp = torch.where(j - 1 == 0, orp0, lgo)
        orp = torch.where(j - 1 == jbrk, obrk, orp)
        cy0 = y1 + gexti
        cy1 = x1 + lgo
        cy2 = (m1 + lng) + orp
        w01 = torch.maximum(cy0, cy1)
        yc = torch.maximum(w01, cy2)
        by = torch.where(cy2 > w01, 2, torch.where(cy1 > cy0, 1, 0))
        t2 = m2p + lng
        u01 = torch.maximum(t2, x2p)
        mc = torch.maximum(u01, y2p)
        bm = torch.where(y2p > u01, 2, torch.where(x2p > t2, 1, 0))
        # pair-end jobs: the candidates compared with the score added
        a0, a1, a2 = t2 + ms[:, d], x2p + ms[:, d], y2p + ms[:, d]
        z01 = torch.maximum(a0, a1)
        bm = torch.where(pe, torch.where(a2 > z01, 2,
                                         torch.where(a1 > a0, 1, 0)), bm)
        mv = torch.where(pe, torch.maximum(z01, a2), mc + ms[:, d])
        okx = (j >= vlox) & (j <= vhi)
        oky = (j >= vloy) & (j <= vhi)
        X = torch.where(okx, xc, neg)
        Y = torch.where(oky, yc, neg)
        M = torch.where(okx & oky, mv, neg)
        codes[:, d] = (bm | (bx << 2) | (by << 4)).to(torch.uint8)
        for b, (Lb, Rb) in enumerate(lr):
            if Lb + Rb - 2 == d:
                corner[b] = torch.stack([M[b, Lb - 1], X[b, Lb - 1],
                                         Y[b, Lb - 1]])
        m2, x2, y2 = m1, x1, y1
        m1, x1, y1 = M, X, Y
    return codes, corner


# ----------------------------------------------------------------------
def _finish_linear(codes_b, corner_b, left, right, model, L, R, lbl, rbl):
    """Host end corner + backtrack of one filled linear job."""
    cells = _ShearedCells(codes_b, left, right)
    end = _end_corner_linear(corner_b, left, right, model, L, R)
    end.bwd_score = 1.0
    end.full_score = 1.0
    path = _backtrack_arrays(cells, left, right, PathPtr(end, True), L, R,
                             lbl, rbl)
    return path, end


def linear_align_path(left, right, model, settings,
                      left_branch_length: float = 0.0,
                      right_branch_length: float = 0.0, band=None,
                      device="cuda"):
    """Single-pair kernel A fill + host backtrack, with the anchored-DP
    full-matrix retry (viterbi_alignment.cpp:298-317)."""
    inp = _add_scalar_params(prepare_sheared(left, right, model, settings,
                                             np.float32))
    Lp = batch_rows([inp])

    def run(bnd):
        args = linear_batch_args([linear_job_arrays(inp, Lp, band=bnd)],
                                 device)
        codes, corner = linear_fill(**args)
        return codes[0].cpu().numpy(), corner[0].cpu().numpy()

    codes, final = run(band)
    if band is not None and not np.isfinite(final).any():
        codes, final = run(None)
    return _finish_linear(codes, final, left, right, model, inp["L"],
                          inp["R"], left_branch_length,
                          right_branch_length)
