"""Kernel A's tiled build (csrc/viterbi_linear.cu, items 7-9), pinned on
the CPU: its tile plan (viterbi_linear.tile_plan) as a pure function,
and a plain PyTorch emulation of its schedule held bit for bit against
linear_fill_plain (codes torch.equal, corner bits equal) in the
ordinary and the pair-end build.

The emulation runs the tiles in claim order, each only on its live
diagonals, with its warps (32 threads x 2 rows) skipped as the kernel
skips them, and hands each tile's last row to the next as the kernel
does: one entry a column j, written once, published every `chunk`
entries and once more at the end; the successor waits at the start of
each chunk of its diagonals for the count it needs and reads only the
columns up to R. Unwritten entries hold NaN, so a read of one shows."""
from dataclasses import replace

import numpy as np
import pytest
import torch

from pagan2_tpu_torch.align import AlignSettings
from pagan2_tpu_torch.align import viterbi_linear as tl
from pagan2_tpu_torch.align.viterbi_sheared import prepare_sheared
from pagan2_tpu_torch.graph import build_leaf_graph
from pagan2_tpu_torch.models import ModelFactory, alphabets as alph

MODEL = ModelFactory(alph.DNA).alignment_model(0.2)
NEG = float("-inf")
ALL_DONE = 0x7fffffff
WARP_ROWS = 64          # 32 threads x 2 rows

# name: (pairs (left, right sites), band half-width, Lp or None (a whole
# number of warps), tile threads, chunk: the hand-off's release interval,
# the kernel's CHUNK (32) or a shorter one, which releases more often)
CASES = {
    # rows past the short jobs' L: their tiles skipped
    "ragged": ([(300, 250), (90, 120), (40, 61)], None, None, 32, 32),
    "banded": ([(260, 240), (200, 180)], 12, None, 64, 8),
    # 224 rows on tiles of 64: the last tile holds 32
    "partial_last_tile": ([(210, 150)], None, None, 32, 7),
    # 157 rows: not a whole number of warps, odd (no vector loads)
    "odd_rows": ([(156, 140)], None, 157, 32, 32),
    # R = 401 columns against tiles of 64 rows
    "wide_R": ([(100, 400), (150, 90)], None, None, 32, 5),
    # an empty right side: R = 1
    "R1": ([(150, 0), (90, 30)], None, None, 32, 32),
}
BREAKS = (0, "mid", "R-1", -1)


def _args(case, pair_end):
    """Kernel A's arguments for a case on the CPU; pair_end: every job
    a pair-end job, its break column in turn 0, mid, R - 1 and none."""
    pairs, w, Lp, _t, _c = CASES[case]
    rng = np.random.default_rng(sorted(CASES).index(case) + 50 * pair_end)
    inps, bands = [], []
    for q, (n, m) in enumerate(pairs):
        base = rng.choice(list("ACGT"), size=max(n, m))
        mut = base.copy()
        idx = rng.random(len(base)) < 0.15
        mut[idx] = rng.choice(list("ACGT"), size=int(idx.sum()))
        s = AlignSettings()
        if pair_end:
            R = m + 1
            y = {"mid": R // 2, "R-1": R - 1}.get(BREAKS[q % 4],
                                                    BREAKS[q % 4])
            s = replace(s, pair_end_reads=True,
                        y_read1_length=y if m else -1)
        inp = tl._add_scalar_params(prepare_sheared(
            build_leaf_graph("".join(base[:n]), alph.DNA),
            build_leaf_graph("".join(mut[:m]), alph.DNA), MODEL, s,
            np.float32))
        inps.append(inp)
        band = None
        if w is not None:
            c = np.arange(inp["L"]) * inp["R"] // inp["L"]
            band = (np.maximum(c - w, 0), np.minimum(c + w, inp["R"] - 1))
        bands.append(band)
    Lp = Lp or tl.batch_rows(inps)
    args = tl.linear_batch_args([tl.linear_job_arrays(x, Lp, band=b)
                                 for x, b in zip(inps, bands)], "cpu")
    assert args["pair_end"] == pair_end
    if pair_end:
        assert (args["iscal"][:, 2] >= 0).any()
    return args


def emulate_tiles(threads, chunk, ms, gexti, ol, vlox, vloy, vhi, fscal,
                  iscal, pair_end=None):
    """Kernel A's tiled build on tiles of `threads` threads x 2 rows, run
    tile by tile in claim order (see the module's docstring). Returns
    (codes, corner) as linear_fill_plain does."""
    B, D, Lp = ms.shape
    f = torch.float32
    codes = torch.zeros((B, D, Lp), dtype=torch.uint8)
    corner = torch.full((B, 3), NEG, dtype=f)
    LR = iscal[:, :2].tolist()
    edges, counts = {}, {}
    for t in tl.tile_plan(LR, Lp, D, threads):
        b = t["job"]
        r0, r1 = t["rows"]
        codes[b, 0, r0:r1 + 1] = 0x3F
        if not t["live"]:
            continue
        L, R = LR[b]
        gext, gend, lgo, lng, orp0, gbrk, obrk = fscal[b, :7]
        pe = bool(iscal[b, 3])
        jbrk = int(iscal[b, 2]) if pe and int(iscal[b, 2]) >= 0 else -2 ** 40
        rows = torch.arange(r0, r1 + 1)
        sl = slice(r0, r1 + 1)
        gx = gexti[b, sl]
        olp = torch.cat([ol[b, r0 - 1:r0] if r0 else torch.zeros(1),
                         ol[b, r0:r1]])
        lox, loy, hi = vlox[b, sl], vloy[b, sl], vhi[b, sl]
        # the warps' live diagonals (item 5)
        wlo = r0 + (rows - r0) // WARP_ROWS * WARP_ROWS
        wlast = torch.where((wlo <= L) & (wlo < Lp),
                            torch.clamp(wlo + WARP_ROWS - 1, max=L) + R, -1)
        m1 = torch.where(rows == 0, 0.0, NEG).to(f)
        x1 = torch.full_like(m1, NEG)
        y1, m2, x2, y2 = (torch.full_like(m1, NEG) for _ in range(4))
        neg3 = torch.full((3,), NEG, dtype=f)
        pred = edges.get(t["ticket"] - 1) if t["tile"] else None
        e1 = neg3           # row r0 - 1 on diagonal d - 2
        own = torch.full((D, 3), float("nan"), dtype=f) \
            if t["feeds"] else None
        written = 0
        dbeg, dend = t["diagonals"]
        for d in range(dbeg, dend + 1):
            jp = d - r0
            if pred is not None and (d - dbeg) % chunk == 0 and jp <= R:
                # the wait: the predecessor publishes the count this
                # chunk needs (every chunk entries, or all at its end)
                need = min(jp + chunk, R + 1)
                assert any(c >= need for c in counts[t["ticket"] - 1])
            e0 = neg3
            if pred is not None and jp <= R:
                e0 = pred[jp]
                assert not bool(torch.isnan(e0).any()), (t, d)
            j = d - rows
            m1p = torch.cat([e0[:1], m1[:-1]])
            x1p = torch.cat([e0[1:2], x1[:-1]])
            y1p = torch.cat([e0[2:3], y1[:-1]])
            m2p = torch.cat([e1[:1], m2[:-1]])
            x2p = torch.cat([e1[1:2], x2[:-1]])
            y2p = torch.cat([e1[2:3], y2[:-1]])
            gj = torch.where((j == 0) | (j == R - 1), gend, gext)
            gj = torch.where(j == jbrk, gbrk, gj)
            cx0, cx1, cx2 = x1p + gj, y1p + lgo, (m1p + lng) + olp
            v01 = torch.maximum(cx0, cx1)
            xc = torch.maximum(v01, cx2)
            bx = torch.where(cx2 > v01, 2, torch.where(cx1 > cx0, 1, 0))
            orp = torch.where(j - 1 == 0, orp0, lgo)
            orp = torch.where(j - 1 == jbrk, obrk, orp)
            cy0, cy1, cy2 = y1 + gx, x1 + lgo, (m1 + lng) + orp
            w01 = torch.maximum(cy0, cy1)
            yc = torch.maximum(w01, cy2)
            by = torch.where(cy2 > w01, 2, torch.where(cy1 > cy0, 1, 0))
            t2 = m2p + lng
            msd = ms[b, d, sl]
            if pe:
                a0, a1, a2 = t2 + msd, x2p + msd, y2p + msd
                z01 = torch.maximum(a0, a1)
                mv = torch.maximum(z01, a2)
                bm = torch.where(a2 > z01, 2, torch.where(a1 > a0, 1, 0))
            else:
                u01 = torch.maximum(t2, x2p)
                mv = torch.maximum(u01, y2p) + msd
                bm = torch.where(y2p > u01, 2, torch.where(x2p > t2, 1, 0))
            okx = (j >= lox) & (j <= hi)
            oky = (j >= loy) & (j <= hi)
            active = (d >= wlo) & (d <= wlast)
            X = torch.where(okx & active, xc, NEG)
            Y = torch.where(oky & active, yc, NEG)
            M = torch.where(okx & oky & active, mv, NEG)
            code = torch.where(active, bm | (bx << 2) | (by << 4), 0)
            codes[b, d, sl] = code.to(torch.uint8)
            if d == L + R - 2 and r0 <= L - 1 <= r1:
                corner[b] = torch.stack([M[L - 1 - r0], X[L - 1 - r0],
                                         Y[L - 1 - r0]])
            if own is not None and d >= r1:
                own[d - r1] = torch.stack([M[-1], X[-1], Y[-1]])
                written += 1
                if written % chunk == 0:
                    assert not bool(torch.isnan(own[:written]).any())
                    counts.setdefault(t["ticket"], []).append(written)
            m2, x2, y2, m1, x1, y1 = m1, x1, y1, M, X, Y
            e1 = e0
        if own is not None:
            edges[t["ticket"]] = own
            counts.setdefault(t["ticket"], []).append(ALL_DONE)
    return codes, corner


def _bits(t):
    return t.contiguous().view(torch.int32)


@pytest.mark.parametrize("pair_end", [False, True],
                         ids=["ordinary", "pair_end"])
@pytest.mark.parametrize("case", list(CASES))
def test_tiled_emulation_matches_plain(case, pair_end):
    """The tiled schedule, its warp skip and its edge hand-off give
    linear_fill_plain's codes and corners bit for bit."""
    args = _args(case, pair_end)
    _pairs, _w, _Lp, threads, chunk = CASES[case]
    codes, corner = emulate_tiles(threads, chunk, **args)
    pc, pk = tl.linear_fill_plain(**args)
    assert torch.equal(codes, pc)
    assert torch.equal(_bits(corner), _bits(pk))
    assert bool(torch.isfinite(pk).any(dim=1).all())


@pytest.mark.parametrize("case", list(CASES))
def test_tiles_cover_every_cell_with_a_code(case):
    """Every cell whose plain code is not 0 lies in a live tile's rows
    and live diagonals; diagonal 0 is 0x3F on every row (written by every
    tile, live or not)."""
    args = _args(case, False)
    pc, _pk = tl.linear_fill_plain(**args)
    B, D, Lp = pc.shape
    LR = args["iscal"][:, :2].tolist()
    covered = torch.zeros((B, D, Lp), dtype=torch.bool)
    for t in tl.tile_plan(LR, Lp, D, CASES[case][3]):
        r0, r1 = t["rows"]
        covered[t["job"], 0, r0:r1 + 1] = True
        if t["live"]:
            d0, d1 = t["diagonals"]
            covered[t["job"], d0:d1 + 1, r0:r1 + 1] = True
    assert bool(covered[:, 0].all())
    assert not bool(pc[~covered].any())
    assert bool((pc[:, 0] == 0x3F).all())


@pytest.mark.parametrize("LR,Lp,threads", [
    ([(300, 251), (91, 121), (41, 62)], 320, 32),
    ([(157, 141)], 157, 32),
    ([(65536, 1024)], 65536, 256),
    ([(16570, 16570)], 16576, 256),
    ([(5001, 1901), (4501, 2401)], 5024, 256),
    ([(4097, 65), (50, 2)], 4128, 1024)])
def test_tile_plan_ranges_and_claim_order(LR, Lp, threads):
    """tile_plan: ntiles = ceil(Lp / 2T) tiles a job, tickets in job
    then tile order (a tile's predecessor holds the ticket before it, so
    it was claimed first); tile k holds rows [2Tk, min(2T(k+1), Lp) - 1],
    is live iff its first row is at most L, runs diagonals
    [max(r0, 1), min(D - 1, min(r1, L) + R)], and hands its last row on
    iff the next tile of its job is live."""
    D = max(L + R for L, R in LR) - 1
    plan = tl.tile_plan(LR, Lp, D, threads)
    rows = 2 * threads
    ntiles = -(-Lp // rows)
    assert len(plan) == len(LR) * ntiles
    assert [t["ticket"] for t in plan] == list(range(len(plan)))
    for t in plan:
        L, R = LR[t["job"]]
        k = t["tile"]
        assert t["ticket"] == t["job"] * ntiles + k
        r0, r1 = t["rows"]
        assert r0 == k * rows and r1 == min(r0 + rows, Lp) - 1
        assert t["live"] == (r0 <= L)
        if t["live"]:
            assert t["diagonals"] == (max(r0, 1),
                                      min(D - 1, min(r1, L) + R))
            assert t["diagonals"][0] <= t["diagonals"][1]
        else:
            assert t["diagonals"] is None
        nxt = plan[t["ticket"] + 1] if k + 1 < ntiles else None
        assert t["feeds"] == (nxt is not None and nxt["live"])
        if k:
            prev = plan[t["ticket"] - 1]
            assert prev["job"] == t["job"] and prev["rows"][1] == r0 - 1
            # a live tile's predecessor is live and hands it its row
            assert not t["live"] or prev["feeds"]
    # rows of a job: the tiles partition [0, Lp)
    for b in range(len(LR)):
        own = [t["rows"] for t in plan if t["job"] == b]
        assert own[0][0] == 0 and own[-1][1] == Lp - 1
        assert all(a[1] + 1 == c[0] for a, c in zip(own, own[1:]))


def test_tile_plan_at_the_gate():
    """The gate pair (65,536 x 1,024 cells) at the default tile: 128
    tiles of 512 rows, each live on 1,535 diagonals (its rows and R
    more), so about three tiles' ranges overlap at any diagonal."""
    Lp, D = 65536, 65535 + 1024 - 1
    plan = tl.tile_plan([(65535, 1024)], Lp, D, tl.TILE_THREADS)
    assert len(plan) == 128 and all(t["live"] for t in plan)
    spans = [t["diagonals"][1] - t["diagonals"][0] + 1 for t in plan]
    assert spans[1:-1] == [512 + 1024] * 126
    assert sum(t["feeds"] for t in plan) == 127
