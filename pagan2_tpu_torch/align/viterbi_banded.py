"""Kernel C: the windowed banded linear-chain Viterbi wavefront
(csrc/viterbi_banded.cu), its plain PyTorch version, the prep that feeds
both, and the anchored long-pair path around them.

Replaces pagan2_tpu/align/viterbi_pallas_banded.py (`_kernel` via
`pallas_banded_fill`, the host half of `pallas_banded_args`, the stripe
folds `_device_fold_fn` / `native.fold_banded_ms`,
`_PallasBandedCells` and `pallas_banded_align_path`) and the band
schedule of pagan2_tpu/align/viterbi_banded.py.

The anchored tunnel's in-band rows form one contiguous window per
anti-diagonal d: rows [ilo[d], ilo[d] + w[d]) (`band_schedule`). The
fill carries only that window, so device memory is O(D x W): the
pre-folded match-score stripe (4 B per window cell) in, one code byte
per window cell out. Window position t of diagonal d is row
i = ilo[d] + t. The sources of X (i-1, j) and Y (i, j-1) sit at
positions t + sx and t + sy of diagonal d-1's window, the source of
M (i-1, j-1) at t + sm of diagonal d-2's; a source outside
[0, Wk) of its window reads -inf and gives "no source" (code 3).

The fill keeps the Pallas kernel's f32 add order and strict first-wins
codes (viterbi_pallas_banded.py:166-206), so corner scores and every
in-window code are bit-identical to it. Codes are written at the TARGET
cell, row d - 1 = diagonal d, bm bits 0-1, bx 2-3, by 4-5: the layout of
the reference's scan-core view (viterbi_banded._BandedCells), so the
Pallas per-access realignment is not needed.

Wk, the stripe width, is the real widest window rounded up to whole
128-row groups (4 warps of one row a thread): the Pallas kernel's
(S, Wl) tiling and diagonal bucketing are TPU compile artefacts and are
not carried over. At Wk = 128 a source past the last row reads as none in both
kernels; wider layouts can differ from the Pallas one there, only at
cells whose value is -inf, which no backtrack reads.

Device rule: a CPU tensor takes `banded_fill_plain`; a CUDA tensor
launches the kernel or raises.
"""
from __future__ import annotations

import ctypes

import numpy as np
import torch

from .. import kernels
from .oracle import PathPtr
from .viterbi_sheared import (_NONE, NEG, _ShearedCells, prepare_sheared,
                              _end_corner_linear)
from .backtrack import _backtrack_arrays

LAUNCHES = 0          # kernel C launches (one per banded_fill on CUDA)
PLAIN_CALLS = 0       # banded_fill_plain calls made by banded_fill

# the stripe width's granule: 4 warps of one row a thread (and the Pallas
# kernel's own 128-row tile, so narrow windows read the same sources)
WINDOW_GRANULE = 128
# a stripe of at least this many cells is folded on the card (only the
# O(L + R) sequence streams cross the link), smaller ones on the host
DEVICE_FOLD_CELLS = 1 << 22
# stripe cells folded per chunk of torch gathers
FOLD_CHUNK_CELLS = 1 << 22
# the ring of three diagonals and the staged stripe rows share one
# block's dynamic shared memory (227 KB on an H100)
MAX_SHARED_BYTES = 232448
MAX_STAGE_DIAGONALS = 16
# kernel C's builds (the launcher's codes): the window kernel, the
# per-position block kernel, and the block kernel with its ring in
# global scratch
BUILDS = ("window", "block", "global")
# the window kernel's instantiations: threads -> window positions a
# thread (256 threads on whole 256-column groups, else 128); on the
# H100 each beat the block kernel at its width, 1.24-1.57x at 640-1280
# columns (tools/bench_banded.py)
WINDOW_BUILDS = {128: (1, 3, 5, 7), 256: (1, 2, 3, 4, 5)}
# the window kernel's chunks: a thread a diagonal makes its step table
WINDOW_MAX_STAGE = 32


# ----------------------------------------------------------------------
def band_schedule(upper: np.ndarray, lower: np.ndarray, L: int, R: int):
    """Per-diagonal window start ilo[d] and in-band width w[d] from
    monotone tunnel bounds — THE shared schedule derivation (the
    windowed scan cores and the banded pallas kernel both consume it;
    two drifting copies hid the --force-gap monotonicity bug in r4).

    A[i] = i + upper[i] and B[i] = i + lower[i] are non-decreasing, so
    ilo(d) = first i with B[i] >= d and ihi(d) = last i with A[i] <= d
    bound the contiguous in-band row range of diagonal d.  Width comes
    from the UNCLIPPED indices: clipping first would count rows whose
    own band excludes the diagonal (a corner-cutting band must produce
    w=0 there so the -inf corner triggers the fallback)."""
    upper = np.clip(np.asarray(upper[:L], np.int64), 0, R - 1)
    lower = np.clip(np.asarray(lower[:L], np.int64), 0, R - 1)
    i = np.arange(L, dtype=np.int64)
    A = i + upper
    B = i + lower
    D = L + R - 1
    ds = np.arange(D, dtype=np.int64)
    ilo_u = np.searchsorted(B, ds, side="left")
    ihi_u = np.searchsorted(A, ds, side="right") - 1
    w = np.maximum(ihi_u - ilo_u + 1, 0)
    ilo = np.clip(ilo_u, 0, L - 1)
    return ilo.astype(np.int32), w.astype(np.int32)


def band_windows(upper: np.ndarray, lower: np.ndarray, L: int, R: int):
    """(per-diagonal window starts, max width) for the windowed scan
    cores — band_schedule with the width collapsed to its maximum."""
    ilo, w = band_schedule(upper, lower, L, R)
    return ilo, int(w.max()) if len(w) else 1


def stripe_width(wmax: int) -> int:
    """Wk: the widest window rounded up to whole 128-row groups."""
    return -(-max(int(wmax), 1) // WINDOW_GRANULE) * WINDOW_GRANULE


def band_sched(ilo, w, Wk: int) -> np.ndarray:
    """(D - 1, 8) int32 rows [ilo, w, sx, sy, sm, 0, 0, 0] for diagonals
    d = 1 .. D - 1 (row d - 1): the window and its source offsets
    sx = ilo[d] - ilo[d-1] - 1, sy = ilo[d] - ilo[d-1] and
    sm = ilo[d] - ilo[d-2] - 1, clipped to [-Wk, Wk] (a larger offset
    reads no source either way)."""
    ilo = np.asarray(ilo, np.int64)
    Dn = len(ilo) - 1
    sched = np.zeros((Dn, 8), np.int32)
    sched[:, 0] = ilo[1:]
    sched[:, 1] = np.asarray(w)[1:]
    d1 = np.diff(ilo)
    sched[:, 2] = d1 - 1
    sched[:, 3] = d1
    ilo_m2 = np.concatenate([ilo[:1], ilo[:-2]])
    sched[:, 4] = np.clip(ilo[1:] - ilo_m2 - 1, -Wk, Wk)
    return sched


# ----------------------------------------------------------------------
def fold_banded_stripe(ls, rs, lw, rw, table, ilo, w, Wk: int, lng,
                       device):
    """The pre-folded in-band match-score stripe (D - 1, Wk) f32 on
    `device`, row d - 1 = diagonal d: ((table[ls[i], rs[j]] + lw[i])
    + rw[j]) + lng at window cell (i, j), 0 outside the window. Chunked
    torch gathers from the O(L + R) streams, so no O(L x R) array and no
    second stripe-sized temporary exists. The flat table index wraps
    python-style for the start site's state -1, like
    native.fold_banded_ms and the reference's folds."""
    dev = torch.device(device)
    L, R = len(ls), len(rs)
    nf = int(table.shape[1])
    Dn = len(ilo) - 1
    ls_t = torch.as_tensor(np.asarray(ls, np.int64), device=dev)
    rs_t = torch.as_tensor(np.asarray(rs, np.int64), device=dev)
    lw_t = torch.as_tensor(np.asarray(lw, np.float32), device=dev)
    rw_t = torch.as_tensor(np.asarray(rw, np.float32), device=dev)
    tflat = torch.as_tensor(
        np.ascontiguousarray(table, np.float32).ravel(), device=dev)
    ilo_t = torch.as_tensor(np.asarray(ilo, np.int64), device=dev)
    w_t = torch.as_tensor(np.asarray(w, np.int64), device=dev)
    lng_t = torch.tensor(np.float32(lng), device=dev)
    zero = torch.zeros((), dtype=torch.float32, device=dev)
    tt = torch.arange(Wk, device=dev)[None, :]
    out = torch.empty((Dn, Wk), dtype=torch.float32, device=dev)
    CH = max(1, FOLD_CHUNK_CELLS // Wk)
    for c0 in range(0, Dn, CH):
        c1 = min(c0 + CH, Dn)
        d = torch.arange(c0 + 1, c1 + 1, device=dev)
        rows = ilo_t[d][:, None] + tt
        rc = rows.clamp(0, L - 1)
        cc = (d[:, None] - rows).clamp(0, R - 1)
        code = torch.remainder(ls_t[rc] * nf + rs_t[cc], nf * nf)
        vals = ((tflat[code] + lw_t[rc]) + rw_t[cc]) + lng_t
        out[c0:c1] = torch.where(tt < w_t[d][:, None], vals, zero)
    return out


def _host_fold(ls, rs, lw, rw, table, ilo, w, Wk, lng, device):
    """The native threaded host fold, moved to `device` (the torch fold
    on `device` where the native library is unavailable)."""
    from .. import native
    L, R = len(ls), len(rs)
    Dn = len(ilo) - 1
    ms = np.zeros((max(Dn, 1), Wk), np.float32)
    if not native.fold_banded_ms(ls, rs, lw, rw, table, ilo, w, L, R,
                                 Dn + 1, Wk, float(lng), ms):
        return fold_banded_stripe(ls, rs, lw, rw, table, ilo, w, Wk, lng,
                                  device)
    return torch.from_numpy(ms[:Dn]).to(device)


def banded_args(left, right, model, settings, upper, lower, device="cpu"):
    """Host prep of one banded fill (the host half of the reference's
    pallas_banded_args): the schedule, the scalars and the folded
    stripe, as `banded_fill` kwargs on `device`, and the meta the
    backtrack needs (inp, ilo, w)."""
    dtype = np.float32
    dev = torch.device(device)
    inp = prepare_sheared(left, right, model, settings, dtype,
                          with_ms=False)
    L, R = inp["L"], inp["R"]
    D = L + R - 1
    ilo, w = band_schedule(upper, lower, L, R)
    Wk = stripe_width(w.max() if len(w) else 1)
    sched = band_sched(ilo, w, Wk)
    Dn = D - 1

    fold = (fold_banded_stripe
            if dev.type == "cuda" and Dn * Wk >= DEVICE_FOLD_CELLS
            else _host_fold)
    ms = fold(np.asarray(left.states[:L], np.int32),
              np.asarray(right.states[:R], np.int32),
              np.asarray(inp["lw"], dtype), np.asarray(inp["rw"], dtype),
              np.asarray(model.log_score, dtype), ilo, w, Wk, inp["lng"],
              dev)

    brkx = settings.x_read1_length if settings.pair_end_reads else -2
    brky = settings.y_read1_length if settings.pair_end_reads else -2
    gext = dtype(model.log_gap_ext())
    gend = (gext if settings.no_terminal_edges
            else dtype(model.log_gap_end_ext()))
    gbrk = (model.log_gap_break_ext() if settings.pair_end_reads
            else gend)
    # open_l[0] / open_r[0] (and the pair-end break sites) are zeroed
    # only under reduced terminal penalties (prepare_sheared)
    olz = orz = (0.0 if settings.reduced_terminal_gap_penalties
                 else inp["lgo"])
    cornerd = D - 1
    tcorner = (L - 1) - int(ilo[cornerd])
    fscal = np.array([gext, gend, gbrk, inp["lgo"], inp["lng"], olz, orz,
                      0], dtype)
    iscal = np.array([L, R, brkx, brky, cornerd, tcorner, 0, 0], np.int32)
    return (dict(fscal=torch.from_numpy(fscal).to(dev),
                 iscal=torch.from_numpy(iscal).to(dev),
                 sched=torch.from_numpy(sched).to(dev), ms=ms),
            dict(inp=inp, ilo=ilo, w=w))


# ----------------------------------------------------------------------
def _check_args(fscal, iscal, sched, ms):
    if ms.dim() != 2:
        raise ValueError("ms must be (D - 1, Wk)")
    Dn, Wk = ms.shape
    if Dn < 1 or Wk % WINDOW_GRANULE:
        raise ValueError("ms must have D - 1 >= 1 rows and a multiple of "
                         "%d columns, got %s" % (WINDOW_GRANULE,
                                                 tuple(ms.shape)))
    want = [("fscal", fscal, torch.float32, (8,)),
            ("iscal", iscal, torch.int32, (8,)),
            ("sched", sched, torch.int32, (Dn, 8)),
            ("ms", ms, torch.float32, (Dn, Wk))]
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
    return Dn, Wk


def _stage_depth(row_bytes: int, fixed: int,
                 top: int = MAX_STAGE_DIAGONALS) -> int:
    """Diagonals per staged chunk (a power of two up to `top`) whose
    double-buffered rows (row_bytes + 32 bytes a diagonal) fit beside
    `fixed` bytes, or 0."""
    td = top
    while td >= 1 and fixed + 2 * td * (row_bytes + 32) > MAX_SHARED_BYTES:
        td //= 2
    return td


def window_plan(Wk: int, threads: int) -> dict:
    """The window kernel's plan for a stripe of Wk columns in a block of
    `threads`, Wk / threads positions a thread: a ring of three float4
    slots of 3 Wk (144 Wk bytes), the staged chunks of stripe rows (4 Wk
    bytes a diagonal), their schedule rows (32) and step tables (48)."""
    td = _stage_depth(4 * Wk + 48, 144 * Wk, WINDOW_MAX_STAGE)
    return dict(build="window", threads=threads,
                rows_a_thread=Wk // threads, stage=td,
                smem=144 * Wk + 2 * td * (4 * Wk + 80))


def block_plan(Wk: int) -> dict:
    """The block kernel's plan: min(1024, Wk) threads looping over the
    Wk positions; the ring of three diagonals (36 Wk bytes) and the
    staged chunks of stripe rows in shared memory where at least one
    diagonal a chunk fits, else the ring in global scratch and nothing
    staged."""
    threads = min(1024, Wk)
    td = _stage_depth(4 * Wk, 36 * Wk)
    return dict(build="block" if td else "global", threads=threads,
                rows_a_thread=-(-Wk // threads), stage=td,
                smem=36 * Wk + 2 * td * (4 * Wk + 32) if td else 0)


def banded_plan(Wk: int) -> dict:
    """How kernel C is launched on a stripe of Wk columns (a multiple of
    128):

    - build: "window" (the window kernel: a block of 128 or 256 threads,
      a template on positions a thread, the ring as float4 slots, step
      tables made a chunk ahead) where one of its instantiations covers
      Wk exactly and its shared memory fits (Wk up to 1280); else
      "block" (one thread a position, up to 1024 threads, a block
      barrier a step) while the ring and one staged diagonal fit in
      shared memory; else "global", the block kernel with its ring in
      global scratch;
    - threads, rows_a_thread: the block and its window positions a
      thread (the window kernel: 256 threads on whole 256-column groups,
      else 128; on the H100 eight warps of one position beat four of
      two at Wk 256, four warps of one beat one warp of three or two of
      two at Wk 128);
    - stage: diagonals a staged chunk (double buffered), 0 for the
      global ring;
    - smem: dynamic shared bytes.

    The plan needs no look at the schedule: the window kernel skips, a
    diagonal at a time, each block of rows past that diagonal's window."""
    threads = 256 if Wk % 256 == 0 else 128
    if Wk // threads in WINDOW_BUILDS[threads]:
        p = window_plan(Wk, threads)
        if p["stage"]:
            return p
    return block_plan(Wk)


def banded_fill(fscal, iscal, sched, ms):
    """Fill one anchored linear pair over its band windows. ms: (D - 1,
    Wk) f32 folded stripe, row d - 1 = diagonal d; sched: (D - 1, 8)
    int32 (`band_sched`); fscal (8,) f32 [gext, gend, gbrk, lgo, lng,
    olz, orz]; iscal (8,) int32 [L, R, xbrk, ybrk, cornerd, tcorner].
    Returns (codes (D - 1, Wk) uint8 at the target cell, corner (3,)
    f32: M, X, Y at cell (L - 1, R - 1)).

    On a CUDA tensor it launches kernel C as banded_plan(Wk) says; the
    kernel refuses a plan it has no build for, and the wrapper raises on
    any launch error."""
    global LAUNCHES, PLAIN_CALLS
    Dn, Wk = _check_args(fscal, iscal, sched, ms)
    if ms.device.type == "cpu":
        PLAIN_CALLS += 1
        return banded_fill_plain(fscal, iscal, sched, ms)
    for name, t in (("sched", sched), ("ms", ms)):
        if t.data_ptr() % 16:
            raise ValueError("%s must be 16-byte aligned" % name)
    plan = banded_plan(Wk)
    lib = kernels.load("viterbi_banded")
    fn = lib.viterbi_banded_launch
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 7 + \
        [ctypes.c_void_p]
    codes = torch.empty((Dn, Wk), dtype=torch.uint8, device=ms.device)
    corner = torch.empty(3, dtype=torch.float32, device=ms.device)
    gbuf = torch.empty(9 * Wk, dtype=torch.float32, device=ms.device) \
        if plan["build"] == "global" else None
    with torch.cuda.device(ms.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(fscal.data_ptr(), iscal.data_ptr(), sched.data_ptr(),
                 ms.data_ptr(), codes.data_ptr(), corner.data_ptr(),
                 0 if gbuf is None else gbuf.data_ptr(), Dn, Wk,
                 BUILDS.index(plan["build"]), plan["threads"],
                 plan["rows_a_thread"], plan["stage"], plan["smem"], stream)
    kernels.check(err, "viterbi_banded")
    LAUNCHES += 1
    return codes, corner


def banded_fill_plain(fscal, iscal, sched, ms):
    """Plain PyTorch version of kernel C: a loop over diagonals on
    (3, Wk) tensors of M, X and Y in the same add order and first-wins
    rule."""
    Dn, Wk = ms.shape
    dev = ms.device
    f = torch.float32
    neg = torch.tensor(NEG, dtype=f, device=dev)
    gext, gend, gbrk, lgo, lng, olz, orz = (fscal[k] for k in range(7))
    L, R, xbrk, ybrk, cornerd, tc = iscal[:6].tolist()
    sch = sched[:, :5].cpu().tolist()
    t = torch.arange(Wk, device=dev)
    negs = torch.full((3, Wk), NEG, dtype=f, device=dev)

    def source(gen, s):
        """gen's (M, X, Y) at window position t + s (-inf outside
        [0, Wk)) and where that position exists."""
        s = max(-Wk, min(Wk, s))
        pad = torch.cat([negs, gen, negs], dim=1)
        p = t + s
        return pad[:, Wk + s:2 * Wk + s], (p >= 0) & (p < Wk)

    g1 = negs.clone()              # diagonal 0: M(0, 0) = 0
    g1[0, 0] = 0.0
    g2 = negs.clone()              # diagonal -1
    codes = torch.empty((Dn, Wk), dtype=torch.uint8, device=dev)
    corner = torch.full((3,), NEG, dtype=f, device=dev)
    for k in range(Dn):
        d = k + 1
        ilo_d, wd, sx, sy, sm = sch[k]
        i = ilo_d + t
        j = d - i
        okw = t < wd
        okx = okw & (i > 0)
        oky = okw & (j > 0)
        okm = okx & (j > 0)
        # penalties of the SOURCE cell: X reads gj(j), olv(i - 1);
        # Y reads gei(i), orv(j - 1)
        gj = torch.where(j == ybrk, gbrk,
                         torch.where((j == 0) | (j == R - 1), gend, gext))
        olv = torch.where((i - 1 == 0) | (i - 1 == xbrk), olz, lgo)
        gei = torch.where(i == xbrk, gbrk,
                          torch.where((i == 0) | (i == L - 1), gend, gext))
        orv = torch.where((j - 1 == 0) | (j - 1 == ybrk), orz, lgo)

        (m1, x1, y1), vx = source(g1, sx)
        cx0 = x1 + gj
        cx1 = y1 + lgo
        cx2 = (m1 + lng) + olv
        v01 = torch.maximum(cx0, cx1)
        xc = torch.maximum(v01, cx2)
        bx = torch.where(cx2 > v01, 2, torch.where(cx1 > cx0, 1, 0))

        (m1, x1, y1), vy = source(g1, sy)
        cy0 = y1 + gei
        cy1 = x1 + lgo
        cy2 = (m1 + lng) + orv
        w01 = torch.maximum(cy0, cy1)
        yc = torch.maximum(w01, cy2)
        by = torch.where(cy2 > w01, 2, torch.where(cy1 > cy0, 1, 0))

        (m2, x2, y2), vm = source(g2, sm)
        t2 = m2 + lng
        u01 = torch.maximum(t2, x2)
        mc = torch.maximum(u01, y2)
        bm = torch.where(y2 > u01, 2, torch.where(x2 > t2, 1, 0))

        okx, oky, okm = okx & vx, oky & vy, okm & vm
        X = torch.where(okx, xc, neg)
        Y = torch.where(oky, yc, neg)
        M = torch.where(okm, mc + ms[k], neg)
        codes[k] = (torch.where(okm, bm, _NONE)
                    | (torch.where(okx, bx, _NONE) << 2)
                    | (torch.where(oky, by, _NONE) << 4)).to(torch.uint8)
        if d == cornerd and 0 <= tc < Wk:
            corner = torch.stack([M[tc], X[tc], Y[tc]])
        g2, g1 = g1, torch.stack([M, X, Y])
    return codes, corner


# ----------------------------------------------------------------------
class _BandedCells(_ShearedCells):
    """Backtrack view over the (D - 1, Wk) codes: cell (i, j) is window
    position i - ilo[d] of diagonal d = i + j, row d - 1; cells outside
    the window have no source."""

    def __init__(self, codes, ilo, w, left, right):
        super().__init__(codes, left, right)
        self.ilo = np.asarray(ilo)
        self.w = np.asarray(w)

    def _code(self, i, j) -> int:
        d = i + j
        if d < 1 or d >= len(self.ilo):
            return _NONE | (_NONE << 2) | (_NONE << 4)
        t = i - int(self.ilo[d])
        if t < 0 or t >= int(self.w[d]):
            return _NONE | (_NONE << 2) | (_NONE << 4)
        return int(self.bp[d - 1, t])


# ----------------------------------------------------------------------
def banded_align_path(left, right, model, settings, upper, lower,
                      left_branch_length: float = 0.0,
                      right_branch_length: float = 0.0, device="cuda"):
    """Windowed banded fill + host backtrack. A band that cannot reach
    the end corner is refilled over the full matrix on kernel A
    (viterbi_alignment.cpp:298-317)."""
    args, meta = banded_args(left, right, model, settings, upper, lower,
                             device)
    codes, corner = banded_fill(**args)
    final = corner.cpu().numpy()
    if not np.isfinite(final).any():
        from .viterbi_linear import linear_align_path
        return linear_align_path(left, right, model, settings,
                                 left_branch_length, right_branch_length,
                                 band=None, device=device)
    inp = meta["inp"]
    L, R = inp["L"], inp["R"]
    cells = _BandedCells(codes.cpu().numpy(), meta["ilo"], meta["w"],
                         left, right)
    end = _end_corner_linear(final, left, right, model, L, R)
    end.bwd_score = 1.0
    end.full_score = 1.0
    path = _backtrack_arrays(cells, left, right, PathPtr(end, True), L, R,
                             left_branch_length, right_branch_length)
    return path, end
