"""Guide-tree inference for unaligned input.

The reference shells out to MAFFT + FastTree/RAxML/BppDist
(src/utils/input_output_parser.cpp:149-449). The native path computes a
k-mer cosine distance matrix (vectorized numpy/jax — no subprocesses)
and builds a BIONJ-style neighbor-joining tree, midpoint-rooted. This is
a documented deviation: parity configs always supply a guide tree.
"""
from __future__ import annotations

import numpy as np

from .newick import TreeNode, midpoint_root


def _kmer_profile(seq: str, k: int, alphabet: str) -> np.ndarray:
    idx = {c: i for i, c in enumerate(alphabet)}
    n = len(alphabet)
    prof = np.zeros(n ** k, dtype=np.float64)
    code = 0
    valid = 0
    mod = n ** (k - 1)
    for ch in seq:
        v = idx.get(ch)
        if v is None:
            valid = 0
            code = 0
            continue
        code = (code % mod) * n + v
        valid += 1
        if valid >= k:
            prof[code] += 1
    return prof


def kmer_distance_matrix(seqs: list[str], data_type: str = "dna"):
    k = 6 if data_type == "dna" else 3
    alphabet = "ACGT" if data_type == "dna" else "ARNDCQEGHILKMFPSTWYV"
    profs = np.stack([_kmer_profile(s.upper(), k, alphabet) for s in seqs])
    norms = np.linalg.norm(profs, axis=1)
    norms[norms == 0] = 1.0
    cos = (profs @ profs.T) / np.outer(norms, norms)
    cos = np.clip(cos, 1e-6, 1.0)
    # common-kmer distance transform
    d = -np.log(cos)
    np.fill_diagonal(d, 0.0)
    return d


def neighbor_joining(d: np.ndarray, names: list[str]) -> TreeNode:
    """Classic NJ (Saitou & Nei) over a dense distance matrix."""
    n = len(names)
    nodes = [TreeNode(name=nm) for nm in names]
    if n == 1:
        return nodes[0]
    if n == 2:
        nodes[0].dist = nodes[1].dist = max(d[0, 1] / 2, 1e-4)
        return TreeNode(children=nodes)

    d = d.astype(np.float64).copy()
    active = list(range(n))
    dist = {(i, j): d[i, j] for i in range(n) for j in range(n)}

    def D(i, j):
        return dist[(i, j)] if (i, j) in dist else dist[(j, i)]

    next_id = n
    while len(active) > 2:
        m = len(active)
        r = {i: sum(D(i, j) for j in active if j != i) for i in active}
        best = None
        for ai in range(m):
            for aj in range(ai + 1, m):
                i, j = active[ai], active[aj]
                q = (m - 2) * D(i, j) - r[i] - r[j]
                if best is None or q < best[0]:
                    best = (q, i, j)
        _, i, j = best
        dij = D(i, j)
        li = 0.5 * dij + (r[i] - r[j]) / (2 * (m - 2))
        lj = dij - li
        node_i = nodes[i]
        node_j = nodes[j]
        node_i.dist = max(li, 1e-6)
        node_j.dist = max(lj, 1e-6)
        parent = TreeNode(children=[node_i, node_j])
        nodes.append(parent)
        u = next_id
        next_id += 1
        for k_ in active:
            if k_ in (i, j):
                continue
            dist[(u, k_)] = 0.5 * (D(i, k_) + D(j, k_) - dij)
        active = [a for a in active if a not in (i, j)] + [u]

    i, j = active
    node_i = nodes[i]
    node_j = nodes[j]
    dij = D(i, j)
    node_i.dist = max(dij / 2, 1e-6)
    node_j.dist = max(dij / 2, 1e-6)
    return TreeNode(children=[node_i, node_j])




def _unroot(tree: TreeNode) -> TreeNode:
    """Collapse a binary root into a trifurcation so midpoint rooting can
    choose the balance point freely."""
    if len(tree.children) != 2:
        return tree
    a, b = tree.children
    if not a.is_leaf:
        inner, outer = a, b
    elif not b.is_leaf:
        inner, outer = b, a
    else:
        return tree
    outer.dist += inner.dist
    return TreeNode(children=inner.children + [outer])


def infer_guide_tree(entries, data_type: str = "dna") -> str:
    seqs = [e.sequence.replace("-", "") for e in entries]
    names = [e.name for e in entries]
    if len(entries) == 1:
        return f"{names[0]}:0.1;"
    d = kmer_distance_matrix(seqs, data_type)
    tree = neighbor_joining(d, names)
    if len(names) > 2:
        tree = midpoint_root(_unroot(tree))
    return tree.to_newick()
