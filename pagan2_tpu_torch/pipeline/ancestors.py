"""Ancestral state reconstruction.

In-process parsimony push-down (Node::reconstruct_parsimony_ancestor,
node.h:1027-1105) and marginal ML ancestors via Felsenstein pruning —
the native replacement for the reference's external BppAncestors
(src/utils/bppancestors.cpp), done as batched array ops instead of a
popen round-trip.
"""
from __future__ import annotations

import numpy as np

from ..graph.sequence_graph import MATCHED, NON_REAL
from ..tree.newick import TreeNode
from ..models.alphabets import Alphabet


def reconstruct_parsimony_ancestors(tree: TreeNode, alphabet: Alphabet):
    """Push resolved parent states down the tree, marking never-matched
    sites non-real (exact transliteration of node.h:1027-1072)."""
    from ..utils import ensure_recursion_for_depth, tree_depth
    ensure_recursion_for_depth(tree_depth(tree))
    g = tree.graph
    child_parsimony = alphabet.child_parsimony

    def at_site(node: TreeNode, pos: int, parent_state: int,
                is_matched: bool):
        if node.is_leaf:
            return
        sg = node.graph
        pstate = sg.path_state[pos]
        if pstate == MATCHED:
            new_state = int(child_parsimony[parent_state, sg.states[pos]])
            sg.states[pos] = new_state
            is_matched = True
        else:
            sg.states[pos] = parent_state
        if not is_matched:
            sg.site_type[pos] = NON_REAL
        li = sg.child_l[pos]
        ri = sg.child_r[pos]
        if li >= 0:
            at_site(node.left, li, sg.states[pos], is_matched)
        if ri >= 0:
            at_site(node.right, ri, sg.states[pos], is_matched)

    for i in range(1, g.num_sites() - 1):
        at_site(tree, i, g.states[i], False)


# ----------------------------------------------------------------------
def reconstruct_ml_ancestors(tree: TreeNode, model_factory,
                             include_gaps_as_missing: bool = True):
    """Marginal maximum-likelihood ancestral states by Felsenstein
    pruning over the alignment columns (native BppAncestors equivalent:
    uses the same substitution model on canonical states; ambiguity
    characters contribute as uniform partials).

    Mutates internal-node graph states at matched sites to the
    max-marginal-posterior canonical state.
    """
    from ..utils import ensure_recursion_for_depth, tree_depth
    ensure_recursion_for_depth(tree_depth(tree))
    a = model_factory.alphabet
    nc = a.n_canon

    # per-branch P matrices
    from ..models.eigen import p_matrix
    pmats = {}

    def pm(dist):
        key = round(float(dist), 12)
        if key not in pmats:
            pmats[key] = p_matrix(model_factory.lam, model_factory.u,
                                  model_factory.v, max(dist, 1e-9))
        return pmats[key]

    # state -> canonical-indicator partials, one gather table (-1 maps
    # to all-missing = uniform)
    partial_table = np.ones((a.n_full + 1, nc))
    for st in range(a.n_full):
        v = np.zeros(nc)
        if st < nc:
            v[st] = 1.0
        else:
            for k in range(int(a.n_units[st])):
                m = int(a.members[st, k])
                if 0 <= m < nc:
                    v[m] = 1.0
            if not v.any():
                v[:] = 1.0
        partial_table[st + 1] = v

    def _norm_rows(v):
        # per-site rescaling: partials shrink multiplicatively per
        # level and underflow to 0 on deep trees; the argmax
        # posteriors are scale-invariant
        m = v.max(axis=1, keepdims=True)
        return v / np.where(m > 0, m, 1.0)

    # upward (postorder) partial likelihoods, one vectorized
    # gather+matmul per node (not per site)
    up: dict[int, np.ndarray] = {}

    def upward(node: TreeNode):
        g = node.graph
        n = g.num_sites()
        L = np.ones((n, nc))
        if node.is_leaf:
            st = np.asarray(g.states[1:n - 1], np.int64)
            L[1:n - 1] = partial_table[st + 1]
            up[id(node)] = L
            return L
        lL = upward(node.left)
        rL = upward(node.right)
        pl = pm(node.left.dist)
        pr = pm(node.right.dist)
        li = np.asarray(g.child_l[1:n - 1], np.int64)
        ri = np.asarray(g.child_r[1:n - 1], np.int64)
        v = np.ones((n - 2, nc))
        has_l = li >= 0
        if has_l.any():
            v[has_l] *= lL[li[has_l]] @ pl.T
        has_r = ri >= 0
        if has_r.any():
            v[has_r] *= rL[ri[has_r]] @ pr.T
        L[1:n - 1] = _norm_rows(v)
        up[id(node)] = L
        return L

    upward(tree)

    # downward: root prior = pi; assign argmax marginal at internal sites
    pi = model_factory.pi

    def downward(node: TreeNode, down: np.ndarray):
        g = node.graph
        if node.is_leaf:
            return
        n = g.num_sites()
        L = up[id(node)]
        post = down[1:n - 1] * L[1:n - 1]
        states = np.asarray(g.states[1:n - 1], np.int64)
        ok = (post.sum(axis=1) > 0) & (states >= 0)
        new = np.where(ok, post.argmax(axis=1), states)
        g.states[1:n - 1] = [int(x) for x in new]
        # propagate to children
        for child, sib, pc, psib in (
                (node.left, node.right, pm(node.left.dist),
                 pm(node.right.dist)),
                (node.right, node.left, pm(node.right.dist),
                 pm(node.left.dist))):
            if child.is_leaf:
                continue
            ci = np.asarray(g.child_l[1:n - 1]
                            if child is node.left
                            else g.child_r[1:n - 1], np.int64)
            si = np.asarray(g.child_r[1:n - 1]
                            if child is node.left
                            else g.child_l[1:n - 1], np.int64)
            cd = np.ones((child.graph.num_sites(), nc))
            valid = ci >= 0
            msg = down[1:n - 1].copy()
            has_sib = valid & (si >= 0)
            if has_sib.any():
                sibL = up[id(sib)]
                msg[has_sib] *= sibL[si[has_sib]] @ psib.T
            res = msg[valid] @ pc
            cd[ci[valid]] = _norm_rows(res)
            downward(child, cd)

    root_down = np.tile(pi, (tree.graph.num_sites(), 1))
    downward(tree, root_down)
