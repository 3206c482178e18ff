"""Linear-chain pair helpers: eligibility, host-side input prep and the
host accessors over a filled wavefront.

Ported from pagan2_tpu/align/viterbi_sheared.py without its JAX scan
core: the fill itself is kernel A (align/viterbi_linear.py), which writes
one uint8 code per cell in the sheared layout read here (bp[d, i] holds
cell (i, d - i); bm bits 0-1, bx 2-3, by 4-5; 3 = no predecessor).

Candidate evaluation order matches the reference exactly
(viterbi_alignment.cpp:1328-1436: gap = ext, double, open; match =
m, x, y; strict-greater first-wins), so tracebacks are identical to the
host oracle for chain inputs.
"""
from __future__ import annotations

import numpy as np

from ..graph.sequence_graph import SequenceGraph
from ..models.evol_model import EvolModel
from .settings import AlignSettings, X_MAT, Y_MAT, M_MAT
from .oracle import MatrixPtr, first_is_bigger

NEG = -np.inf
_NONE = 3  # "no backpointer" 2-bit code

def is_linear_chain(g: SequenceGraph) -> bool:
    """Fast-path eligibility: every site 1..N-1 has exactly one bwd edge,
    from its immediate predecessor."""
    for i in range(1, g.num_sites()):
        b = g.bwd[i]
        if len(b) != 1 or g.edges.start[b[0]] != i - 1:
            return False
    return True


def _shear_np(vals_2d: np.ndarray, D: int) -> np.ndarray:
    """(L, R) row-major -> (D, L) diagonal-major: out[i+j, i] = in[i, j]
    (clamped past column R-1; callers mask)."""
    L, R = vals_2d.shape
    ext = np.concatenate(
        [vals_2d, np.zeros((L, 1), vals_2d.dtype)], axis=1)
    d_idx = np.arange(D)[None, :] - np.arange(L)[:, None]
    idx = np.clip(d_idx, 0, R)
    # the .T view is fine: downstream np.stack copies exactly once
    return np.take_along_axis(ext, idx, axis=1).T


def prepare_sheared(left: SequenceGraph, right: SequenceGraph,
                    model: EvolModel, settings: AlignSettings,
                    dtype=np.float64, with_ms: bool = True):
    """Host-side input prep for the sheared kernel. with_ms=False skips
    the O(L*R) match-score table for banded consumers that gather
    scores in-scan (viterbi_banded builds them by one-hot contraction
    — a 200 kb pair would otherwise need ~300 GB here)."""
    L = left.num_sites() - 1
    R = right.num_sites() - 1
    D = L + R - 1

    lstates = np.asarray(left.states[:L], dtype=np.int32)
    rstates = np.asarray(right.states[:R], dtype=np.int32)
    ms = (model.log_score[np.ix_(lstates, rstates)].astype(dtype)
          if with_ms else None)

    m = model
    gext = m.log_gap_ext()
    gend = gext if settings.no_terminal_edges else m.log_gap_end_ext()
    gext_j = np.full(R, gext, dtype)
    gext_j[0] = gend
    gext_j[R - 1] = gend
    gext_i = np.full(L, gext, dtype)
    gext_i[0] = gend
    gext_i[L - 1] = gend

    lgo = dtype(m.log_gap_open())
    open_l = np.full(L, lgo, dtype)   # open_l[p] for predecessor row p
    open_r = np.full(R, lgo, dtype)
    if settings.reduced_terminal_gap_penalties:
        open_l[0] = 0.0
        open_r[0] = 0.0

    # pair-end read1 boundary (viterbi_alignment.cpp:866-884 gap type,
    # basic_alignment.h:497-513 zeroed open penalty at the boundary;
    # gap close is log(1.0)=0 everywhere so needs no vector); jbrk, the
    # j-side column, is what kernel A takes in place of the vectors
    jbrk = -1
    if settings.pair_end_reads:
        if 0 <= settings.x_read1_length < L:
            gext_i[settings.x_read1_length] = m.log_gap_break_ext()
            if settings.reduced_terminal_gap_penalties:
                open_l[settings.x_read1_length] = 0.0
        if 0 <= settings.y_read1_length < R:
            jbrk = settings.y_read1_length
            gext_j[settings.y_read1_length] = m.log_gap_break_ext()
            if settings.reduced_terminal_gap_penalties:
                open_r[settings.y_read1_length] = 0.0

    def edge_logw_vec(g, n):
        """lw[i] = f32-rounded log weight of site i's bwd edge,
        vectorized (the per-site Python loop dominated host prep on
        100-leaf families)."""
        out = np.zeros(n, dtype)
        if n <= 1:
            return out
        ids = np.fromiter((g.bwd[i][0] for i in range(1, n)),
                          np.int64, n - 1)
        w = np.asarray(g.edges.weight, np.float64)[ids]
        with np.errstate(divide="ignore"):
            out[1:] = np.where(w > 0,
                               np.log(w).astype(np.float32), NEG)
        return out

    lw = edge_logw_vec(left, L)
    rw = edge_logw_vec(right, R)

    # open_pen_r sheared at index j-1: orp_sh[d, i] = open_r[d-i-1]
    open_r_shifted = np.concatenate([[0.0], open_r[:-1]]).astype(dtype)

    return dict(
        L=L, R=R, D=D,
        ms=ms, gext_j=gext_j, gext_i=gext_i,
        open_l=open_l, open_r_shifted=open_r_shifted,
        lw=lw, rw=rw,
        lng=dtype(m.log_non_gap()), lgo=lgo,
        pair_end=bool(settings.pair_end_reads), jbrk=jbrk,
    )


# ----------------------------------------------------------------------
class _ShearedCells:
    """Oracle-style cell accessor over the packed bp planes."""

    def __init__(self, bp, left, right):
        self.bp = np.asarray(bp)
        self.left = left
        self.right = right

    def _code(self, i, j) -> int:
        """6-bit step code of cell (i, j): bm | bx << 2 | by << 4."""
        return int(self.bp[i + j, i])

    def cell(self, which, i, j) -> MatrixPtr:
        code = self._code(i, j)
        mp = MatrixPtr()
        if which == M_MAT:
            mv = code & 3
            if mv == _NONE:
                return mp
            mp.matrix = (M_MAT, X_MAT, Y_MAT)[mv]
            mp.x_ind = i - 1
            mp.y_ind = j - 1
            mp.x_edge_ind = self.left.bwd[i][0]
            mp.y_edge_ind = self.right.bwd[j][0]
        elif which == X_MAT:
            mv = (code >> 2) & 3
            if mv == _NONE:
                mp.y_ind = j
                return mp
            mp.matrix = (X_MAT, Y_MAT, M_MAT)[mv]
            mp.x_ind = i - 1
            mp.y_ind = j
            mp.x_edge_ind = self.left.bwd[i][0]
        else:
            mv = (code >> 4) & 3
            if mv == _NONE:
                mp.x_ind = i
                return mp
            mp.matrix = (Y_MAT, X_MAT, M_MAT)[mv]
            mp.x_ind = i
            mp.y_ind = j - 1
            mp.y_edge_ind = self.right.bwd[j][0]
        return mp


def _end_corner_linear(final, left, right, model, L, R):
    """End-corner resolution for chain graphs: the stop sites have one
    bwd edge each, so only the corner cell's three values matter
    (viterbi_alignment.cpp:1440-1567 collapses to three candidates)."""
    mx = MatrixPtr()
    le = left.bwd[L][0]
    re = right.bwd[R][0]

    def logw(g, e):
        w = float(g.edges.weight[e])
        return float(np.float32(np.log(w))) if w > 0 else NEG

    mM, mX, mY = [float(v) for v in final]
    # m_match
    sc = mM + model.log_non_gap() + logw(left, le) + logw(right, re)
    if first_is_bigger(sc, mx.score):
        mx.score = sc
        mx.x_ind = L - 1
        mx.y_ind = R - 1
        mx.x_edge_ind = le
        mx.y_edge_ind = re
        mx.matrix = M_MAT
    best = mx.score
    # x gap close
    sc = mX + 0.0
    if first_is_bigger(sc, mx.score):
        mx.score = sc
        mx.matrix = X_MAT
        mx.x_ind = L - 1
        mx.x_edge_ind = le
        mx.y_edge_ind = -1
    if first_is_bigger(mx.score, best):
        best = mx.score
        mx.y_ind = R - 1
    # y gap close
    sc = mY + 0.0
    if first_is_bigger(sc, mx.score):
        mx.score = sc
        mx.matrix = Y_MAT
        mx.y_ind = R - 1
        mx.y_edge_ind = re
        mx.x_edge_ind = -1
    if first_is_bigger(mx.score, best):
        mx.x_ind = L - 1
    return mx


def _bucket(n: int) -> int:
    """The reference's shape buckets. The port keeps them because routing
    depends on them: the window-vs-full choice is
    _bucket(Wreal) * 2 <= _bucket(R), and jobs batch by (L, R) bucket."""
    if n <= 128:
        return -(-n // 32) * 32
    if n <= 1024:
        return -(-n // 128) * 128
    p = 1024
    while p < n:
        p *= 2
    return p

