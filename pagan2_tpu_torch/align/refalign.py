"""Read an existing alignment as if aligned: vector-DP along the fixed
column path.

Transliteration of Reference_alignment (src/main/reference_alignment.cpp):
``read_alignment`` (:37-183) turns the two children's gapped rows into a
fixed M/X/Y ``simple_path``; ``make_alignment_path`` (:185-422) runs the
pairwise scoring recurrences restricted to that path — per-path-position
M/X/Y vectors instead of matrices, O(path x edges) — which still chooses
among the children's (possibly multi-site-skipping) edges and therefore
decides which child sites become skipped at the ancestor. The ancestral
graph is then built by the shared machinery (ancestral.py).

Host-side by design: reading a reference alignment is a linear-time
ingest step, not a DP hot path; the TPU kernels are for the O(L*R) fills.
"""
from __future__ import annotations

from dataclasses import replace

import numpy as np

from ..graph.sequence_graph import SequenceGraph
from ..models.evol_model import EvolModel
from .settings import (AlignSettings, X_MAT, Y_MAT, M_MAT,
                       NORMAL_GAP, END_GAP, PAIR_BREAK_GAP)
from .oracle import MatrixPtr, PathPtr, first_is_bigger

NEG = -np.inf


def reference_alignment_settings(s: AlignSettings,
                                 perfect_reference: bool = False
                                 ) -> AlignSettings:
    """set_reference_alignment_settings (basic_alignment.h:588-593)."""
    if perfect_reference:
        return s
    return replace(s, max_allowed_skip_distance=5.0,
                   max_allowed_skip_branches=50000,
                   max_allowed_match_skip_branches=50000)


def build_simple_path(gapped_left: str, gapped_right: str,
                      is_codons: bool = False):
    """reference_alignment.cpp:89-171: column classes from gap patterns.

    Returns (steps, gapped_anc) where steps is a list of
    (matrix, x_ind, y_ind) — x/y being the zero-based consumed-site
    counters the reference stores (swapped there, unswapped here since
    they are only replayed into non-real backtrack entries).
    """
    if len(gapped_left) != len(gapped_right):
        raise ValueError("gapped sequences of different length")
    steps = []
    anc = []
    li = ri = 0
    stride = 3 if is_codons else 1
    for c in range(0, len(gapped_left), stride):
        lcol = gapped_left[c:c + stride]
        rcol = gapped_right[c:c + stride]
        lgap = lcol[0] == "-"
        rgap = rcol[0] == "-"
        if is_codons:
            if any((ch == "-") != lgap for ch in lcol) or \
                    any((ch == "-") != rgap for ch in rcol):
                raise ValueError(
                    "reading frame error in codon reference alignment")
        if not lgap and rgap:
            steps.append((X_MAT, li, -1))
            anc.append("A" * stride)
            li += 1
        elif lgap and not rgap:
            steps.append((Y_MAT, -1, ri))
            anc.append("A" * stride)
            ri += 1
        elif not lgap and not rgap:
            steps.append((M_MAT, li, ri))
            anc.append("A" * stride)
            li += 1
            ri += 1
        else:
            anc.append("-" * stride)
    return steps, "".join(anc)


class RefAligner:
    """Vector-DP along a fixed path (make_alignment_path)."""

    def __init__(self, left: SequenceGraph, right: SequenceGraph,
                 model: EvolModel, settings: AlignSettings,
                 left_branch_length: float = 0.0,
                 right_branch_length: float = 0.0):
        self.left = left
        self.right = right
        self.model = model
        self.s = settings
        self.left_branch_length = left_branch_length
        self.right_branch_length = right_branch_length

        # mark_no_gap_penalty_sites bookkeeping (reduced terminal
        # penalties; pair-end reads unsupported on this path)
        self.x_length = left.num_sites() if settings.reduced_terminal_gap_penalties else -1
        self.y_length = right.num_sites() if settings.reduced_terminal_gap_penalties else -1

        ew = left.edges.weight
        self.lw = [float(np.float32(np.log(np.float64(w)))) for w in ew]
        ew = right.edges.weight
        self.rw = [float(np.float32(np.log(np.float64(w)))) for w in ew]

    # -- penalties (basic_alignment.h:490-542) -------------------------
    def _log_gap_open_penalty(self, prev_site: int, is_x: bool) -> float:
        if self.s.reduced_terminal_gap_penalties and prev_site == 0:
            return 0.0
        return self.model.log_gap_open()

    def _log_gap_close_penalty(self, this_site: int, is_x: bool) -> float:
        if self.s.reduced_terminal_gap_penalties:
            if is_x and this_site == self.x_length:
                return 0.0
            if not is_x and this_site == self.y_length:
                return 0.0
        return self.model.log_gap_close()

    # -- scoring kernels (reference_alignment.cpp:917-1291) ------------
    def _score_m_match_v(self, le, re, m_log_match, mx):
        lp = self.left.edges.start[le]
        lpi = self.l_site_to_path[lp]
        rp = self.right.edges.start[re]
        rpi = self.r_site_to_path[rp]
        if lpi != rpi:
            return
        sc = self.mvect[lpi].score + m_log_match + self.lw[le] + self.rw[re]
        if first_is_bigger(sc, mx.score):
            mx.score = sc
            mx.path_index = lpi
            mx.x_ind = lp
            mx.y_ind = rp
            mx.x_edge_ind = le
            mx.y_edge_ind = re
            mx.matrix = M_MAT

    def _score_x_match_v(self, le, re, x_log_match, mx):
        lp = self.left.edges.start[le]
        lpi = self.l_site_to_path[lp]
        rp = self.right.edges.start[re]
        if self.path_to_r[lpi] != rp:
            return
        sc = self.xvect[lpi].score + x_log_match + self.lw[le] + self.rw[re]
        if first_is_bigger(sc, mx.score):
            mx.score = sc
            mx.path_index = lpi
            mx.x_ind = lp
            mx.y_ind = rp
            mx.x_edge_ind = le
            mx.y_edge_ind = re
            mx.matrix = X_MAT

    def _score_y_match_v(self, le, re, y_log_match, mx):
        lp = self.left.edges.start[le]
        rp = self.right.edges.start[re]
        rpi = self.r_site_to_path[rp]
        if self.path_to_l[rpi] != lp:
            return
        sc = self.yvect[rpi].score + y_log_match + self.lw[le] + self.rw[re]
        if first_is_bigger(sc, mx.score):
            mx.score = sc
            mx.path_index = rpi
            mx.x_ind = lp
            mx.y_ind = rp
            mx.x_edge_ind = le
            mx.y_edge_ind = re
            mx.matrix = Y_MAT

    def _score_gap_ext_v(self, le, re, z_vect, mx, is_x, gap_type,
                         alignment_end):
        if is_x:
            e, w = le, self.lw[le]
            pi = self.l_site_to_path[self.left.edges.start[le]]
            if not alignment_end and \
                    self.path_to_r[pi] != self.right.edges.end[re]:
                return
        else:
            e, w = re, self.rw[re]
            pi = self.r_site_to_path[self.right.edges.start[re]]
            if not alignment_end and \
                    self.path_to_l[pi] != self.left.edges.end[le]:
                return
        m = self.model
        if gap_type == END_GAP:
            ext = m.log_gap_end_ext()
        elif gap_type == PAIR_BREAK_GAP:
            ext = m.log_gap_break_ext()
        else:
            ext = m.log_gap_ext()
        sc = z_vect[pi].score + ext + w
        if first_is_bigger(sc, mx.score):
            mx.score = sc
            mx.path_index = pi
            if is_x:
                mx.matrix = X_MAT
                mx.x_ind = self.left.edges.start[le]
                mx.x_edge_ind = le
                if alignment_end:
                    mx.y_ind = 0
            else:
                mx.matrix = Y_MAT
                mx.y_ind = self.right.edges.start[re]
                mx.y_edge_ind = re
                if alignment_end:
                    mx.x_ind = 0

    def _score_gap_double_v(self, le, re, w_vect, mx, is_x):
        if is_x:
            w = self.lw[le]
            pi = self.r_site_to_path[self.right.edges.end[re]]
            if self.path_to_l[pi] != self.left.edges.start[le]:
                return
        else:
            w = self.rw[re]
            pi = self.l_site_to_path[self.left.edges.end[le]]
            if self.path_to_r[pi] != self.right.edges.start[re]:
                return
        m = self.model
        sc = w_vect[pi].score + m.log_gap_close() + m.log_gap_open() + w
        if first_is_bigger(sc, mx.score):
            mx.score = sc
            mx.path_index = pi
            mx.matrix = Y_MAT if is_x else X_MAT
            mx.x_ind = self.left.edges.start[le]
            mx.x_edge_ind = le
            mx.y_ind = self.right.edges.start[re]
            mx.y_edge_ind = re

    def _score_gap_open_v(self, le, re, m_vect, mx, is_x, alignment_end):
        if is_x:
            e, w = le, self.lw[le]
            start = self.left.edges.start[le]
            pi = self.l_site_to_path[start]
            if not alignment_end and \
                    self.path_to_r[pi] != self.right.edges.end[re]:
                return
        else:
            e, w = re, self.rw[re]
            start = self.right.edges.start[re]
            pi = self.r_site_to_path[start]
            if not alignment_end and \
                    self.path_to_l[pi] != self.left.edges.end[le]:
                return
        sc = m_vect[pi].score + self.model.log_non_gap() + \
            self._log_gap_open_penalty(start, is_x) + w
        if first_is_bigger(sc, mx.score):
            mx.score = sc
            mx.matrix = M_MAT
            mx.path_index = pi
            if is_x:
                mx.x_ind = start
                mx.x_edge_ind = le
                if alignment_end:
                    mx.y_ind = 0
            else:
                mx.y_ind = start
                mx.y_edge_ind = re
                if alignment_end:
                    mx.x_ind = 0

    def _score_gap_close_v(self, le, re, z_vect, mx, is_x):
        if is_x:
            w = self.lw[le]
            pi = self.l_site_to_path[self.left.edges.start[le]]
            if self.path_to_r[pi] != self.right.edges.start[re]:
                return
            this = self.left.edges.end[le]
        else:
            w = self.rw[re]
            pi = self.r_site_to_path[self.right.edges.start[re]]
            if self.path_to_l[pi] != self.left.edges.start[le]:
                return
            this = self.right.edges.end[re]
        sc = z_vect[pi].score + self._log_gap_close_penalty(this, is_x) + w
        if first_is_bigger(sc, mx.score):
            mx.score = sc
            mx.path_index = pi
            if is_x:
                mx.matrix = X_MAT
                mx.x_ind = self.left.edges.start[le]
                mx.x_edge_ind = le
            else:
                mx.matrix = Y_MAT
                mx.y_ind = self.right.edges.start[re]
                mx.y_edge_ind = re

    # -- per-step iterations (reference_alignment.cpp:626-912) ---------
    def _known_gap(self, lsite, rsite, z, w, m, mx, is_x, gap_type,
                   alignment_end):
        if alignment_end:
            own = self.left.bwd[lsite] if is_x else self.right.bwd[rsite]
            for e in own:
                self._score_gap_open_v(e, e, m, mx, is_x, True)
                self._score_gap_ext_v(e, e, z, mx, is_x, gap_type, True)
            return
        lb = self.left.bwd[lsite]
        rb = self.right.bwd[rsite]
        if not lb or not rb:
            return
        for le in lb:
            for re in rb:
                self._score_gap_double_v(le, re, w, mx, is_x)
                self._score_gap_open_v(le, re, m, mx, is_x, False)
                self._score_gap_ext_v(le, re, z, mx, is_x, gap_type, False)

    def _known_match(self, lsite, rsite, mx, last_m_path_index):
        lb = self.left.bwd[lsite]
        rb = self.right.bwd[rsite]
        if not lb or not rb:
            return
        m = self.model
        log_match = m.log_score[self.left.states[lsite],
                                self.right.states[rsite]]
        m_log = 2.0 * m.log_non_gap() + log_match
        x_log = self._log_gap_close_penalty(
            self.left.edges.end[lb[0]], True) + m.log_non_gap() + log_match
        y_log = self._log_gap_close_penalty(
            self.right.edges.end[rb[0]], False) + m.log_non_gap() + log_match
        # per pair: m, y, x (reference_alignment.cpp:645-647)
        for le in lb:
            if self.l_site_to_path[self.left.edges.start[le]] < \
                    last_m_path_index:
                continue
            for re in rb:
                self._score_m_match_v(le, re, m_log, mx)
                self._score_y_match_v(le, re, y_log, mx)
                self._score_x_match_v(le, re, x_log, mx)

    def _vector_end(self, mx):
        """iterate_bwd_edges_for_vector_end (:783-912)."""
        lsite = self.left.num_sites() - 1
        rsite = self.right.num_sites() - 1
        lb = self.left.bwd[lsite]
        rb = self.right.bwd[rsite]
        if not lb or not rb:
            return
        m_log = self.model.log_non_gap()
        best = [NEG]

        def m_match(le, re):
            self._score_m_match_v(le, re, m_log, mx)
            if first_is_bigger(mx.score, best[0]):
                best[0] = mx.score

        def close_x(le, re):
            self._score_gap_close_v(le, re, self.xvect, mx, True)
            if first_is_bigger(mx.score, best[0]):
                best[0] = mx.score
                mx.y_ind = self.right.num_sites() - 2

        def close_y(le, re):
            self._score_gap_close_v(le, re, self.yvect, mx, False)
            if first_is_bigger(mx.score, best[0]):
                best[0] = mx.score
                mx.x_ind = self.left.num_sites() - 2

        le0, re0 = lb[0], rb[0]
        m_match(le0, re0)
        close_x(le0, re0)
        close_y(le0, re0)
        for re in rb[1:]:
            m_match(le0, re)
            close_x(le0, re)
            close_y(le0, re)
        for le in lb[1:]:
            m_match(le, re0)
            close_y(le, re0)   # swapped order in the left-extra loop
            close_x(le, re0)
            for re in rb[1:]:
                m_match(le, re)
                close_x(le, re)
                close_y(le, re)

    # -- the fill + backtrack ------------------------------------------
    def read_alignment(self, is_codons: bool = False):
        left, right = self.left, self.right
        if left.gapped_seq is None or right.gapped_seq is None:
            raise ValueError("both graphs need gapped_seq for "
                             "reference-alignment reading")
        steps, gapped_anc = build_simple_path(left.gapped_seq,
                                              right.gapped_seq, is_codons)
        P = len(steps)
        left_length = left.num_sites()
        right_length = right.num_sites()

        self.mvect = [MatrixPtr(score=0.0, x_ind=0, y_ind=0)]
        neg = MatrixPtr(score=NEG, x_ind=0, y_ind=0)
        self.xvect = [neg]
        self.yvect = [neg]
        self.l_site_to_path = [0]
        self.r_site_to_path = [0]
        self.l_site_to_last = [0]
        self.r_site_to_last = [0]
        self.path_to_l = [0]
        self.path_to_r = [0]

        i_ind = j_ind = 0
        last_m_path_index = -1
        i_seq_start = j_seq_start = True

        for i, (mat, _sx, _sy) in enumerate(steps):
            # NB the sequence-END side of this condition can never fire
            # (consumed-site indices max out at num_sites()-2, one
            # short of *_length-1) — the REFERENCE has the identical
            # comparison against sites_length()-1
            # (reference_alignment.cpp:70,260-268); replicated verbatim
            j_gap_type = END_GAP if (j_ind == 0 or
                                     j_ind == right_length - 1) else NORMAL_GAP
            i_gap_type = END_GAP if (i_ind == 0 or
                                     i_ind == left_length - 1) else NORMAL_GAP
            mpm = MatrixPtr()
            mpx = MatrixPtr()
            mpy = MatrixPtr()

            if mat == X_MAT:
                i_ind += 1
                self.l_site_to_path.append(i + 1)
                self.l_site_to_last.append(i + 1)
                self._known_gap(i_ind, j_ind, self.xvect, self.yvect,
                                self.mvect, mpx, True, j_gap_type,
                                j_seq_start)
                if mpx.y_ind < 0:
                    mpx.y_ind = self.path_to_r[
                        self.l_site_to_path[mpx.x_ind]]
                if mpx.matrix == Y_MAT:
                    mpx.y_ind = self.path_to_r[
                        self.l_site_to_last[mpx.x_ind]]
                i_seq_start = False
            elif mat == Y_MAT:
                j_ind += 1
                self.r_site_to_path.append(i + 1)
                self.r_site_to_last.append(i + 1)
                self._known_gap(i_ind, j_ind, self.yvect, self.xvect,
                                self.mvect, mpy, False, i_gap_type,
                                i_seq_start)
                if mpy.x_ind < 0:
                    mpy.x_ind = self.path_to_l[
                        self.r_site_to_path[mpy.y_ind]]
                if mpy.matrix == X_MAT:
                    mpy.x_ind = self.path_to_l[
                        self.r_site_to_last[mpy.y_ind]]
                j_seq_start = False
            else:
                i_ind += 1
                j_ind += 1
                self.l_site_to_path.append(i + 1)
                self.r_site_to_path.append(i + 1)
                self.l_site_to_last.append(i + 1)
                self.r_site_to_last.append(i + 1)
                self._known_match(i_ind, j_ind, mpm, last_m_path_index)
                i_seq_start = j_seq_start = False
                last_m_path_index = i

            self.mvect.append(mpm)
            self.xvect.append(mpx)
            self.yvect.append(mpy)
            self.path_to_l.append(i_ind)
            self.path_to_r.append(j_ind)
            self.l_site_to_last[i_ind] = i + 1
            self.r_site_to_last[j_ind] = i + 1

        self.l_site_to_path.append(P)
        self.r_site_to_path.append(P)
        self.l_site_to_last.append(P)
        self.r_site_to_last.append(P)

        end = MatrixPtr()
        self._vector_end(end)
        if end.score == NEG:
            raise RuntimeError("Reference_alignment: end corner unreachable")
        end.bwd_score = 1.0
        end.full_score = 1.0
        path = self._backtrack(PathPtr(end, True), steps)
        return path, end, gapped_anc

    def _backtrack(self, fp: PathPtr, steps):
        """backtrack_new_vector_path (:427-621)."""
        left, right = self.left, self.right
        stack: list[PathPtr] = []
        P = len(steps)

        vit_mat = fp.mp.matrix
        x_ind = fp.mp.x_ind
        y_ind = fp.mp.y_ind
        next_pi = fp.mp.path_index

        if fp.mp.x_edge_ind >= 0:
            left.edges.used[fp.mp.x_edge_ind] = True
        if fp.mp.y_edge_ind >= 0:
            right.edges.used[fp.mp.y_edge_ind] = True

        k = P
        if vit_mat == X_MAT:
            y_ind = -1
        elif vit_mat == Y_MAT:
            x_ind = -1

        def push_skipped():
            nonlocal k
            while next_pi < k:
                smat, sx, sy = steps[k - 1]
                stack.append(PathPtr(
                    MatrixPtr(score=-1, x_ind=sx, y_ind=sy, matrix=smat),
                    False))
                k -= 1

        while k >= 0:
            if vit_mat == M_MAT:
                vect = self.mvect
            elif vit_mat == X_MAT:
                vect = self.xvect
            elif vit_mat == Y_MAT:
                vect = self.yvect
            else:
                raise RuntimeError(
                    f"incorrect backward pointer {vit_mat}")
            push_skipped()
            if k < 1:
                break
            stack.append(PathPtr(
                MatrixPtr(score=-1, x_ind=x_ind, y_ind=y_ind,
                          matrix=vit_mat), True))
            cell = vect[k]
            prev_mat = vit_mat
            vit_mat = cell.matrix
            x_ind = cell.x_ind
            y_ind = cell.y_ind
            next_pi = cell.path_index
            if prev_mat in (M_MAT, X_MAT) and cell.x_edge_ind >= 0:
                left.edges.used[cell.x_edge_ind] = True
            if prev_mat in (M_MAT, Y_MAT) and cell.y_edge_ind >= 0:
                right.edges.used[cell.y_edge_ind] = True
            if vit_mat == X_MAT:
                y_ind = -1
            elif vit_mat == Y_MAT:
                x_ind = -1
            k -= 1
            if k < 1:
                break

        return stack[::-1]


# ----------------------------------------------------------------------
def read_alignment_pair(left: SequenceGraph, right: SequenceGraph,
                        model: EvolModel, settings: AlignSettings | None = None,
                        left_branch_length: float = 0.0,
                        right_branch_length: float = 0.0,
                        perfect_reference: bool = False,
                        is_codons: bool = False) -> SequenceGraph:
    """Node::read_alignment_this_node equivalent: vector-DP + ancestral
    graph, with the ancestor's gapped row recorded for the next level."""
    from .ancestral import build_ancestral_graph
    settings = reference_alignment_settings(settings or AlignSettings(),
                                            perfect_reference)
    ra = RefAligner(left, right, model, settings,
                    left_branch_length, right_branch_length)
    path, end, gapped_anc = ra.read_alignment(is_codons)
    anc = build_ancestral_graph(left, right, path, model, settings,
                                left_branch_length, right_branch_length)
    anc.gapped_seq = gapped_anc
    return anc
