"""Full-probability pass: forward/backward probability planes,
posteriors and stochastic path sampling, for linear-chain and fan-in
graph pairs.

Ported from pagan2_tpu/align/fullprob.py. The reference computes forward
probabilities inside the Viterbi fill
(Viterbi_alignment::compute_fwd_scores, viterbi_alignment.cpp:856-971),
then a full-matrix backward pass and the per-cell posterior
full_score = fwd*bwd/total (viterbi_alignment.cpp:329-371, 975-1034),
and stochastic backtracks that draw moves in proportion to forward
probability (sample_new_path, :1193-1322).

Here the two plane fills run on the device as kernels D and E
(align/fullprob_fill.py: one anti-diagonal of all three matrices per
step, every diagonal rescaled by its maximum, the logarithm of the scale
accumulated), f32. The stored planes are (scaled value, cumulative
log-scale) pairs; `FullProbPlanes` holds them as numpy arrays on the
host and exposes exact log-space accessors and posteriors (posteriors
are scale-free).

Semantics mirrored from the reference:
- forward gap moves use the plain extension probability and NO edge
  weights (viterbi_alignment.cpp:2151-2154); match moves DO fold in both
  edge weights (:2029-2112);
- the backward match term takes the match score at the *target* cell
  (score_match_bwd, :2259-2305);
- the bwd corner is seeded at the stop sites' bwd-edge pairs with
  non_gap * w_l * w_r (initialise_array_corner_bwd, :740-830);
- fwd/bwd totals must agree within 1% (:344-355) — checked here;
- terminal/reduced gap penalties do NOT enter the probability passes
  (only the Viterbi scores), matching the oracle.

Every pair with more than 4 sites in all takes the device fills,
whatever its fan-in or edge offsets: edge slots K, ring depth G and seed
depth are runtime sizes of the fan-in entry points.
"""
from __future__ import annotations

import numpy as np

from .settings import AlignSettings, X_MAT, Y_MAT, M_MAT
from .oracle import MatrixPtr, PathPtr

NEG = -np.inf


def _common_inputs(left, right, model):
    L = left.num_sites() - 1
    R = right.num_sites() - 1
    m = model
    consts = np.array(
        [m.ext_prob, m.gap_close() * m.gap_open(),
         m.non_gap() * m.gap_open(), m.non_gap() * m.non_gap(),
         m.gap_close() * m.non_gap()], np.float32)
    return dict(L=L, R=R, consts=consts,
                lstates=np.asarray(left.states[:L], np.int32),
                rstates=np.asarray(right.states[:R], np.int32),
                score=m.score.astype(np.float32))


def linear_fullprob_inputs(left, right, model):
    """Host-side numpy inputs of one linear-chain pair for
    fullprob_fill.linear_batch_args (f32): the state vectors and the
    model's match-probability table (the (L, R) table is gathered,
    folded with the edge weights and sheared on the device), the raw
    bwd-edge weights of both sides, the five transition constants and
    the corner seed non_gap * w_lstop * w_rstop."""
    inp = _common_inputs(left, right, model)
    L, R = inp["L"], inp["R"]

    def edge_w_vec(g, n):
        """w[i] = raw weight of site i's bwd edge."""
        out = np.ones(n, np.float32)
        if n > 1:
            ids = np.fromiter((g.bwd[i][0] for i in range(1, n)),
                              np.int64, n - 1)
            out[1:n] = np.asarray(g.edges.weight,
                                  np.float64)[ids].astype(np.float32)
        return out

    w_lstop = float(left.edges.weight[left.bwd[L][0]])
    w_rstop = float(right.edges.weight[right.bwd[R][0]])
    inp.update(wl=edge_w_vec(left, L), wr=edge_w_vec(right, R),
               w_lstop=w_lstop, w_rstop=w_rstop,
               seed=np.float32(model.non_gap() * w_lstop * w_rstop))
    return inp


def fanout_arrays(g, n):
    """Per-site FWD-edge offset/weight arrays over sites 0..n-1,
    excluding edges into the stop site (the oracle's bwd pass skips
    nxt >= L; stop-edge mass arrives via the corner seeds)."""
    KF = 1
    offs = []
    for i in range(n):
        row = [(int(g.edges.end[e]) - i, float(g.edges.weight[e]))
               for e in g.fwd[i] if int(g.edges.end[e]) < n]
        offs.append(row)
        KF = max(KF, len(row))
    off = np.zeros((n, KF), np.int32)
    w = np.zeros((n, KF), np.float32)
    for i, row in enumerate(offs):
        for k, (o, wt) in enumerate(row):
            off[i, k] = o
            w[i, k] = wt
    return off, w


def fanin_fullprob_inputs(left, right, model):
    """Host-side numpy inputs of one fan-in graph pair for
    fullprob_fill.fanin_batch_args (f32): per site the offsets and
    weights of its bwd edges (forward fill) and of its fwd edges
    (backward fill), and the block of bwd corner seeds. Slot axes pad
    with inert zero slots when jobs are stacked."""
    inp = _common_inputs(left, right, model)
    L, R = inp["L"], inp["R"]
    m = model
    la = left.padded_bwd_arrays()
    ra = right.padded_bwd_arrays()

    def side(arr, n):
        ar = np.arange(n)[:, None]
        mask = arr["mask"][:n] & (arr["prev"][:n] >= 0) & \
            (arr["prev"][:n] < ar)
        offp = np.where(mask, ar - arr["prev"][:n], 0).astype(np.int32)
        wp = np.where(mask, arr["w"][:n], 0.0).astype(np.float32)
        return offp, wp

    loffp, lwp = side(la, L)
    roffp, rwp = side(ra, R)
    lfoff, lfw = fanout_arrays(left, L)
    rfoff, rfw = fanout_arrays(right, R)

    # bwd corner seeds over every stop-site bwd-edge pair
    # (initialise_array_corner_bwd, viterbi_alignment.cpp:740-830)
    lb = [(int(left.edges.start[e]), float(left.edges.weight[e]))
          for e in left.bwd[L]]
    rb = [(int(right.edges.start[e]), float(right.edges.weight[e]))
          for e in right.bwd[R]]
    corner_d = L + R - 2
    Gs = 1
    for li, _ in lb:
        for ri, _ in rb:
            Gs = max(Gs, corner_d - (li + ri) + 1)
    seed_block = np.zeros((Gs, L), np.float32)
    seed_block[0, L - 1] = m.non_gap()
    for li, wl in lb:
        for ri, wr in rb:
            seed_block[corner_d - (li + ri), li] = \
                m.non_gap() * wl * wr

    inp.update(loffp=loffp, lwp=lwp, roffp=roffp, rwp=rwp,
               lfoff=lfoff, lfw=lfw, rfoff=rfoff, rfw=rfw,
               seed_block=seed_block,
               KL=loffp.shape[1], KR=roffp.shape[1],
               KFL=lfoff.shape[1], KFR=rfoff.shape[1],
               OLm=max(1, int(loffp.max())),
               ORm=max(1, int(roffp.max())))
    return inp


def pair_plane_fills(left, right, model, fanin: bool, device):
    """Both fills of ONE pair on `device`. Returns (inp, f_planes, fcum,
    b_planes, bcum): planes (3, D, Lp) and cum (D,) numpy arrays."""
    from . import fullprob_fill as ff
    if fanin:
        inp = fanin_fullprob_inputs(left, right, model)
        (fp_, fc), (bp_, bc) = ff.fanin_plane_fills(
            *ff.fanin_batch_args([inp], device))
    else:
        inp = linear_fullprob_inputs(left, right, model)
        (fp_, fc), (bp_, bc) = ff.linear_plane_fills(
            **ff.linear_batch_args([inp], device))
    return (inp, fp_[0].cpu().numpy(), fc[0].cpu().numpy(),
            bp_[0].cpu().numpy(), bc[0].cpu().numpy())


# ----------------------------------------------------------------------
# host-side container
# ----------------------------------------------------------------------
class FullProbPlanes:
    """Scaled fwd/bwd probability planes for one pair.

    Planes are sheared (D, Lp): plane[d, i] holds cell (i, j=d-i) of one
    matrix, scaled so each diagonal's max is 1; true value =
    plane[d, i] * exp(cum[d]). Posteriors are computed scale-free.
    """

    def __init__(self, left, right, model, settings, fanin=None,
                 device="cuda"):
        if fanin is None:
            # callers that already know the chain property pass it in
            # (is_linear_chain is an O(n) python scan per graph)
            from .viterbi_sheared import is_linear_chain
            fanin = not (is_linear_chain(left) and
                         is_linear_chain(right))
        inp, f_planes, fcum, b_planes, bcum = pair_plane_fills(
            left, right, model, fanin, device)
        self._setup(left, right, model, inp, fanin)
        self._finish(f_planes, fcum, b_planes, bcum)

    @classmethod
    def from_arrays(cls, left, right, model, inp, f_planes, fcum,
                    b_planes, bcum, fanin=False):
        """Construct from pre-filled planes (the batched executor fills
        a whole generation bucket in one launch). inp is the job's
        linear_fullprob_inputs dict (fanin_fullprob_inputs when
        fanin=True); f_planes/b_planes are (3, D, Lp) arrays M, X, Y."""
        self = cls.__new__(cls)
        self._setup(left, right, model, inp, fanin)
        self._finish(f_planes, fcum, b_planes, bcum)
        return self

    def _setup(self, left, right, model, inp, fanin):
        self.left = left
        self.right = right
        self.model = model
        self.L = inp["L"]
        self.R = inp["R"]
        self.fanin = fanin
        if not fanin:
            self.w_lstop = inp["w_lstop"]
            self.w_rstop = inp["w_rstop"]

    def _finish(self, f_planes, fcum, b_planes, bcum):
        """Store planes + totals + the fwd/bwd 1% consistency check
        (viterbi_alignment.cpp:344-355)."""
        L, R = self.L, self.R
        m = self.model
        self.f = tuple(np.asarray(p) for p in f_planes)
        self.fcum = np.asarray(fcum)
        self.b = tuple(np.asarray(p) for p in b_planes)
        self.bcum = np.asarray(bcum)
        self.Lp = self.f[0].shape[1]

        if not self.fanin:
            # fwd total at the end corner
            # (iterate_bwd_edges_for_end_corner's fwd accumulation,
            # viterbi_alignment.cpp:1440-1567): match via non_gap*wl*wr
            # + both gap closes via gap_close (no weights)
            gc = m.gap_close()
            d = L + R - 2
            i = L - 1
            tot = (m.non_gap() * self.w_lstop * self.w_rstop *
                   self._fp(M_MAT, d, i) +
                   gc * self._fp(X_MAT, d, i) +
                   gc * self._fp(Y_MAT, d, i))
            self.log_total = (np.log(tot) + self.fcum[d]) if tot > 0 \
                else NEG
        else:
            self.log_total = self._fanin_corner_total()
        bt = self._bp(M_MAT, 0, 0)
        self.log_total_bwd = (np.log(bt) + self.bcum[0]) if bt > 0 else NEG

        # fwd/bwd agreement within 1% (viterbi_alignment.cpp:344-355)
        from ..utils import log_out
        # the reference's window is a fixed 1% ratio on doubles; the
        # scaled fills accumulate one log per diagonal, so allow the
        # float-precision share of |log_total| on top (f32 runs on long
        # pairs drift ~1e-5 relative, far past where raw doubles would
        # have overflowed entirely)
        eps = np.finfo(self.fcum.dtype).eps
        tol = np.log(1.01) + 4 * eps * np.sqrt(max(len(self.fcum), 1)) \
            * abs(self.log_total)
        dlog = abs(self.log_total - self.log_total_bwd) \
            if np.isfinite(self.log_total_bwd) else np.inf
        if dlog > tol:
            log_out("Problem in computation? log fwd: %g, log bwd: %g"
                    % (self.log_total, self.log_total_bwd), 1)


    def _fanin_corner_total(self):
        """Forward total via the end-corner enumeration
        (viterbi_alignment.cpp:1440-1567). The reference re-visits the
        right gap-close per (le != le0, re != re0) pair, so those terms
        carry multiplicity len(lb); replicated for parity."""
        left, right, m = self.left, self.right, self.model
        L, R = self.L, self.R
        ng, gc = m.non_gap(), m.gap_close()
        lb = [(int(left.edges.start[e]), float(left.edges.weight[e]))
              for e in left.bwd[L]]
        rb = [(int(right.edges.start[e]), float(right.edges.weight[e]))
              for e in right.bwd[R]]
        terms = []   # (value in scaled units, log-scale)
        for li, wl in lb:
            for ri, wr in rb:
                d = li + ri
                terms.append((self._fp(M_MAT, d, li) * ng * wl * wr,
                              self.fcum[d]))
        for li, _wl in lb:
            d = li + R - 1
            terms.append((self._fp(X_MAT, d, li) * gc, self.fcum[d]))
        for n, (ri, _wr) in enumerate(rb):
            d = L - 1 + ri
            mult = 1 if n == 0 else len(lb)
            terms.append((mult * self._fp(Y_MAT, d, L - 1) * gc,
                          self.fcum[d]))
        mx = max((ls for v, ls in terms if v > 0), default=None)
        if mx is None:
            return NEG
        tot = sum(v * np.exp(ls - mx) for v, ls in terms if v > 0)
        return float(np.log(tot) + mx)

    # matrix-indexed scaled reads (mat in {X_MAT, Y_MAT, M_MAT};
    # planes are stored (M, X, Y))
    def _fp(self, mat, d, i):
        return float(self.f[{M_MAT: 0, X_MAT: 1, Y_MAT: 2}[mat]][d, i])

    def _bp(self, mat, d, i):
        return float(self.b[{M_MAT: 0, X_MAT: 1, Y_MAT: 2}[mat]][d, i])

    def fwd_scaled(self, mat, i, j):
        """(scaled value, log-scale) with true fwd = v * exp(ls)."""
        d = i + j
        return self._fp(mat, d, i), float(self.fcum[d])

    def fwd(self, mat, i, j):
        """Raw forward value. May over/underflow f64 on long pairs (the
        log-odds-scaled match scores exceed 1); only the scale-free
        posterior is consumed downstream, so that is acceptable."""
        v, ls = self.fwd_scaled(mat, i, j)
        with np.errstate(over="ignore", under="ignore"):
            return v * np.exp(ls)

    def bwd(self, mat, i, j):
        d = i + j
        with np.errstate(over="ignore", under="ignore"):
            return self._bp(mat, d, i) * np.exp(self.bcum[d])

    def posterior(self, mat, i, j):
        """full_score = fwd*bwd/total (viterbi_alignment.cpp:1029-1034),
        computed scale-free."""
        d = i + j
        k = {M_MAT: 0, X_MAT: 1, Y_MAT: 2}[mat]
        v = float(self.f[k][d, i]) * float(self.b[k][d, i])
        if v <= 0:
            return 0.0
        return v * np.exp(self.fcum[d] + self.bcum[d] - self.log_total)

    def posterior_plane(self):
        """(L-1, R-1) max-over-matrices posterior for the MetaPost
        heatmaps (plot_posterior_probabilities_*)."""
        L, R = self.L, self.R
        best = np.zeros((L, R))
        scale = self.fcum + self.bcum - self.log_total   # (D,)
        for k in range(3):
            prod = self.f[k] * self.b[k]                 # (D, Lp)
            with np.errstate(divide="ignore"):
                lp = np.where(prod > 0, np.log(prod), NEG) + scale[:, None]
            # unshear: cell (i, j) at plane[i+j, i]
            for i in range(L):
                row = lp[i:i + R, i]
                best[i] = np.maximum(best[i], np.exp(np.minimum(row, 0.0))
                                     * (row > NEG))
        return best[:L - 1, :R - 1]

    def total_fwd_score(self) -> float:
        with np.errstate(over="ignore", under="ignore"):
            return float(np.exp(self.log_total))



# ----------------------------------------------------------------------
# Viterbi path + posterior annotation
# ----------------------------------------------------------------------
def annotate_path(path, planes: FullProbPlanes, end: MatrixPtr):
    """Fill fwd/bwd/full_score on a Viterbi path's cells from the
    probability planes (the reference carries them in the DP cells;
    build_ancestral_sequence reads full_score as the site posterior,
    basic_alignment.cpp:61-179)."""
    end.fwd_score = planes.total_fwd_score()
    end.bwd_score = 1.0
    end.full_score = 1.0
    i, j = planes.L - 1, planes.R - 1
    mat = end.matrix
    for pp in reversed(path):
        mp = pp.mp
        if mp is end:
            # the end pointer keeps its sentinel scores (the oracle
            # never revisits it); it is not always path[-1] — trailing
            # pre-existing gaps follow it when the corner resolves
            # through a site-skipping stop edge
            continue
        if not pp.real_site:
            # pushed pre-existing gap: coordinates are explicit
            gi, gj = mp.x_ind, mp.y_ind
            mp.fwd_score = planes.fwd(mp.matrix, gi, gj)
            mp.bwd_score = planes.bwd(mp.matrix, gi, gj)
            mp.full_score = planes.posterior(mp.matrix, gi, gj)
            continue
        mp.fwd_score = planes.fwd(mat, i, j)
        mp.bwd_score = planes.bwd(mat, i, j)
        mp.full_score = planes.posterior(mat, i, j)
        # follow the stored predecessor coordinates (equal to plain
        # decrements on linear chains; graph edges may skip sites)
        if mat == M_MAT:
            i, j = mp.x_ind, mp.y_ind
        elif mat == X_MAT:
            i = mp.x_ind
        else:
            j = mp.y_ind
        mat = mp.matrix
    return path



def fullprob_viterbi_path(left, right, model, settings: AlignSettings,
                          left_branch_length=0.0, right_branch_length=0.0,
                          planes=None, linear=None, device="cuda"):
    """Viterbi path via kernel A (linear chains) or kernel B (fan-in
    graphs) + posterior annotation from the probability planes. Returns
    (path, end, planes)."""
    from .viterbi_sheared import is_linear_chain
    if linear is None:
        linear = is_linear_chain(left) and is_linear_chain(right)
    if linear:
        from .viterbi_linear import linear_align_path
        path, end = linear_align_path(left, right, model, settings,
                                      left_branch_length,
                                      right_branch_length, device=device)
    else:
        from .viterbi_fanin import fanin_align_path
        path, end = fanin_align_path(left, right, model, settings,
                                     left_branch_length,
                                     right_branch_length, device=device)
    if planes is None:
        planes = FullProbPlanes(left, right, model, settings,
                                fanin=not linear, device=device)
    annotate_path(path, planes, end)
    return path, end, planes


# ----------------------------------------------------------------------
# stochastic backtrack over the planes (sample_new_path,
# viterbi_alignment.cpp:1193-1322)
# ----------------------------------------------------------------------
def _draw(cands, rng):
    total = sum(c[0] for c in cands)
    r = total * rng.random()
    acc = 0.0
    for c in cands:
        acc += c[0]
        if acc >= r:
            return c
    return cands[-1]


def sample_path_planes(planes: FullProbPlanes, settings: AlignSettings,
                       rng, left_branch_length=0.0,
                       right_branch_length=0.0):
    """Draw one path proportional to forward probabilities
    (sample_new_path, viterbi_alignment.cpp:1193-1322). Linear chains
    take the fast single-diagonal candidate sets (per-diagonal scales
    cancel inside each draw); fan-in graphs enumerate per-edge
    candidates with explicit rescaling. Returns (path, end_ptr)."""
    if getattr(planes, "fanin", False):
        return _sample_fanin(planes, settings, rng,
                             left_branch_length, right_branch_length)
    left, right = planes.left, planes.right
    m = planes.model
    L, R = planes.L, planes.R
    gc, go, ng, ext = m.gap_close(), m.gap_open(), m.non_gap(), m.ext_prob

    def fs(mat, i, j):
        d = i + j
        return planes._fp(mat, d, i)

    # -- end corner (iterate_bwd_edges_for_sampled_end_corner) --------
    le0 = left.bwd[L][0]
    re0 = right.bwd[R][0]
    cands = [
        (fs(M_MAT, L - 1, R - 1) * ng * planes.w_lstop * planes.w_rstop,
         M_MAT, L - 1, R - 1, le0, re0),
        (fs(X_MAT, L - 1, R - 1) * gc * planes.w_lstop,
         X_MAT, L - 1, R - 1, le0, -1),
        (fs(Y_MAT, L - 1, R - 1) * gc * planes.w_rstop,
         Y_MAT, L - 1, R - 1, re0, -1),
    ]
    c = _draw(cands, rng)
    end = MatrixPtr(score=c[0], matrix=c[1], x_ind=c[2], y_ind=c[3])
    if c[1] == M_MAT:
        end.x_edge_ind, end.y_edge_ind = c[4], c[5]
    elif c[1] == X_MAT:
        end.x_edge_ind = c[4]
    else:
        end.y_edge_ind = c[4]
    end.bwd_score = 1.0
    end.full_score = 1.0
    end.fwd_score = planes.total_fwd_score()

    if end.x_edge_ind >= 0:
        left.edges.used[end.x_edge_ind] = True
    if end.y_edge_ind >= 0:
        right.edges.used[end.y_edge_ind] = True

    stack: list[PathPtr] = []
    vit_mat = end.matrix
    i, j = L - 1, R - 1
    if i > 0 or j > 0:
        stack.append(PathPtr(end, True))

    while True:
        if vit_mat == M_MAT:
            le = left.bwd[i][0]
            re = right.bwd[j][0]
            ms = m.score[left.states[i], right.states[j]]
            w = (float(left.edges.weight[le]) *
                 float(right.edges.weight[re]))
            li, rj = i - 1, j - 1
            cs = [(fs(M_MAT, li, rj) * ng * ng * ms * w, M_MAT),
                  (fs(X_MAT, li, rj) * gc * ng * ms * w, X_MAT),
                  (fs(Y_MAT, li, rj) * gc * ng * ms * w, Y_MAT)]
            pick = _draw(cs, rng)
            mp = MatrixPtr(score=pick[0], matrix=pick[1], x_ind=li,
                           y_ind=rj, x_edge_ind=le, y_edge_ind=re)
            mp.full_score = planes.posterior(M_MAT, i, j)
            left.edges.used[le] = True
            right.edges.used[re] = True
            vit_mat = pick[1]
            i -= 1
            j -= 1
        elif vit_mat == X_MAT:
            e = left.bwd[i][0]
            w = float(left.edges.weight[e])
            li = i - 1
            cs = [(fs(X_MAT, li, j) * ext * w, X_MAT),
                  (fs(Y_MAT, li, j) * gc * go * w, Y_MAT),
                  (fs(M_MAT, li, j) * ng * go * w, M_MAT)]
            pick = _draw(cs, rng)
            mp = MatrixPtr(score=pick[0], matrix=pick[1], x_ind=li,
                           y_ind=j, x_edge_ind=e)
            mp.full_score = planes.posterior(X_MAT, i, j)
            left.edges.used[e] = True
            vit_mat = pick[1]
            i -= 1
        else:
            e = right.bwd[j][0]
            w = float(right.edges.weight[e])
            rj = j - 1
            cs = [(fs(Y_MAT, i, rj) * ext * w, Y_MAT),
                  (fs(X_MAT, i, rj) * gc * go * w, X_MAT),
                  (fs(M_MAT, i, rj) * ng * go * w, M_MAT)]
            pick = _draw(cs, rng)
            mp = MatrixPtr(score=pick[0], matrix=pick[1], x_ind=i,
                           y_ind=rj, y_edge_ind=e)
            mp.full_score = planes.posterior(Y_MAT, i, j)
            right.edges.used[e] = True
            vit_mat = pick[1]
            j -= 1
        if i > 0 or j > 0:
            stack.append(PathPtr(mp, True))
        if i < 1 and j < 1:
            break

    return stack[::-1], end


def _sample_fanin(planes: FullProbPlanes, settings: AlignSettings, rng,
                  left_branch_length=0.0, right_branch_length=0.0):
    """Stochastic backtrack on fan-in graphs over the probability
    planes: per-edge candidate sets in the oracle's exact enumeration
    order (iterate_bwd_edges_for_sampled_{end_corner,match,gap},
    viterbi_alignment.cpp:1664-2028). Candidates source different
    diagonals, so each draw rescales by the max diagonal log-scale
    (ratios equal the oracle's raw-probability ratios)."""
    left, right, m = planes.left, planes.right, planes.model
    L, R = planes.L, planes.R
    ng, gc, go, ext = m.non_gap(), m.gap_close(), m.gap_open(), m.ext_prob
    lw = left.edges.weight
    rw = right.edges.weight
    lstart = left.edges.start
    rstart = right.edges.start

    def fsc(mat, i, j):
        d = i + j
        return planes._fp(mat, d, i), float(planes.fcum[d])

    def draw(cands):
        mx = max((ls for v, ls, _ in cands if v > 0), default=0.0)
        vals = [v * np.exp(ls - mx) if v > 0 else 0.0
                for v, ls, _ in cands]
        total = sum(vals)
        r = total * rng.random()
        acc = 0.0
        for v, (_, _, mp) in zip(vals, cands):
            acc += v
            if acc >= r:
                return mp
        return cands[-1][2]

    # -- end corner (iterate_bwd_edges_for_sampled_end_corner) --------
    lb = left.bwd[L]
    rb = right.bwd[R]
    cands = []

    def add_m(le, re):
        li, ri = int(lstart[le]), int(rstart[re])
        v, ls = fsc(M_MAT, li, ri)
        mp = MatrixPtr(matrix=M_MAT, x_ind=li, y_ind=ri,
                       x_edge_ind=le, y_edge_ind=re)
        cands.append((v * ng * float(lw[le]) * float(rw[re]), ls, mp))

    def add_close(e, is_x):
        if is_x:
            prev = int(lstart[e])
            v, ls = fsc(X_MAT, prev, R - 1)
            mp = MatrixPtr(matrix=X_MAT, x_ind=prev, y_ind=R - 1,
                           x_edge_ind=e)
            cands.append((v * gc * float(lw[e]), ls, mp))
        else:
            prev = int(rstart[e])
            v, ls = fsc(Y_MAT, L - 1, prev)
            mp = MatrixPtr(matrix=Y_MAT, x_ind=L - 1, y_ind=prev,
                           y_edge_ind=e)
            cands.append((v * gc * float(rw[e]), ls, mp))

    le0, re0 = lb[0], rb[0]
    add_m(le0, re0)
    add_close(le0, True)
    add_close(re0, False)
    for re in rb[1:]:
        add_m(le0, re)
        add_close(re, False)
    for le in lb[1:]:
        add_m(le, re0)
        add_close(le, True)
        for re in rb[1:]:
            add_m(le, re)
            add_close(re, False)
    end = draw(cands).copy()
    end.bwd_score = 1.0
    end.full_score = 1.0
    end.fwd_score = planes.total_fwd_score()
    if end.x_edge_ind >= 0:
        left.edges.used[end.x_edge_ind] = True
    if end.y_edge_ind >= 0:
        right.edges.used[end.y_edge_ind] = True

    # -- per-cell samplers --------------------------------------------
    def sampled_match(i, j):
        ms = float(m.score[left.states[i], right.states[j]])
        m_match = ng * ng * ms
        z_match = gc * ng * ms
        cs = []

        def add(le, re):
            li, ri = int(lstart[le]), int(rstart[re])
            w = float(lw[le]) * float(rw[re])
            for mat_id, fac in ((M_MAT, m_match), (X_MAT, z_match),
                                (Y_MAT, z_match)):
                v, ls = fsc(mat_id, li, ri)
                mp = MatrixPtr(matrix=mat_id, x_ind=li, y_ind=ri,
                               x_edge_ind=le, y_edge_ind=re)
                cs.append((v * fac * w, ls, mp))

        lbi = left.bwd[i]
        rbj = right.bwd[j]
        e0, f0 = lbi[0], rbj[0]
        add(e0, f0)
        for re in rbj[1:]:
            add(e0, re)
        for le in lbi[1:]:
            add(le, f0)
            for re in rbj[1:]:
                add(le, re)
        sp = draw(cs).copy()
        sp.fwd_score = planes.fwd(M_MAT, i, j)
        sp.bwd_score = planes.bwd(M_MAT, i, j)
        sp.full_score = planes.posterior(M_MAT, i, j)
        return sp

    def sampled_gap(i, j, is_x):
        cs = []
        if is_x:
            seq, w, site = left, lw, i
            zmat, wmat = X_MAT, Y_MAT
        else:
            seq, w, site = right, rw, j
            zmat, wmat = Y_MAT, X_MAT
        for e in seq.bwd[site]:
            prev = int(seq.edges.start[e])
            we = float(w[e])

            def mk(v, ls, mat_id):
                mp = MatrixPtr(matrix=mat_id)
                if is_x:
                    mp.x_ind = prev
                    mp.x_edge_ind = e
                else:
                    mp.y_ind = prev
                    mp.y_edge_ind = e
                cs.append((v, ls, mp))

            if is_x:
                vz, lz = fsc(X_MAT, prev, j)
                vw, lwv = fsc(Y_MAT, prev, j)
                vm, lm = fsc(M_MAT, prev, j)
            else:
                vz, lz = fsc(Y_MAT, i, prev)
                vw, lwv = fsc(X_MAT, i, prev)
                vm, lm = fsc(M_MAT, i, prev)
            mk(vz * ext * we, lz, zmat)
            mk(vw * gc * go * we, lwv, wmat)
            mk(vm * ng * go * we, lm, M_MAT)
        sp = draw(cs).copy()
        which = X_MAT if is_x else Y_MAT
        sp.fwd_score = planes.fwd(which, i, j)
        sp.bwd_score = planes.bwd(which, i, j)
        sp.full_score = planes.posterior(which, i, j)
        if is_x:
            sp.y_ind = j
        else:
            sp.x_ind = i
        return sp

    # -- walk (sample_new_path, viterbi_alignment.cpp:1193-1322) ------
    stack: list[PathPtr] = []
    ij = [L - 1, R - 1]
    vit_mat = end.matrix

    def push_gap(i, j, matrix, bl):
        mp = MatrixPtr(score=-1, x_ind=i, y_ind=j, matrix=matrix)
        mp.fwd_score = planes.fwd(matrix, i, j)
        mp.bwd_score = planes.bwd(matrix, i, j)
        mp.full_score = planes.posterior(matrix, i, j)
        stack.append(PathPtr(mp, False, bl, 1))

    def insert_preexisting_gap(x_ind, y_ind):
        while x_ind < ij[0]:
            push_gap(ij[0] - 1, ij[1], X_MAT, left_branch_length)
            ij[0] -= 1
        while y_ind < ij[1]:
            push_gap(ij[0], ij[1] - 1, Y_MAT, right_branch_length)
            ij[1] -= 1

    def insert_pp(pp):
        if ij[0] > 0 or ij[1] > 0:
            stack.append(pp)

    insert_preexisting_gap(end.x_ind, end.y_ind)
    insert_pp(PathPtr(end, True))

    while True:
        i, j = ij
        if vit_mat == M_MAT:
            bwd_p = sampled_match(i, j)
            left.edges.used[bwd_p.x_edge_ind] = True
            right.edges.used[bwd_p.y_edge_ind] = True
            ij[0] -= 1
            ij[1] -= 1
        elif vit_mat == X_MAT:
            bwd_p = sampled_gap(i, j, True)
            left.edges.used[bwd_p.x_edge_ind] = True
            ij[0] -= 1
        else:
            bwd_p = sampled_gap(i, j, False)
            right.edges.used[bwd_p.y_edge_ind] = True
            ij[1] -= 1
        vit_mat = bwd_p.matrix
        insert_preexisting_gap(bwd_p.x_ind, bwd_p.y_ind)
        insert_pp(PathPtr(bwd_p, True))
        if ij[0] < 1 and ij[1] < 1:
            break

    return stack[::-1], end
