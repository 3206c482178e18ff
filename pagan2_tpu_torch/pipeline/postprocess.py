"""Output post-processing: evolutionary-event listing, pruning and
trimming of extended (placement) alignments, NHX tree output.

Native equivalents of the reference's output-stage features:
- --events            BppAncestors::count_events (bppancestors.cpp:319-470)
- --prune-extended-alignment / --prune-keep-number / --prune-keep-closest
                      Input_output_parser::prune_extended_alignment
                      (input_output_parser.cpp:930-1016); the BppPhySamp
                      subprocess path (keep N most distant) is replaced by
                      an in-framework max-min tree-distance subsample
- --trim-extended-alignment / --trim-keep-sites
                      (input_output_parser.cpp:813-856)
- NHX tree output     Node::print_nhx_tree (node.h:1603-1660)
"""
from __future__ import annotations

from ..io.fasta import FastaEntry
from ..tree.newick import TreeNode
from ..utils import log_out


# ----------------------------------------------------------------------
# tree helpers

def read_node_names(tree: TreeNode) -> set[str]:
    """Leaf names whose sequence graph is a read/query sequence
    (Node::get_read_node_names, node.h:510-524)."""
    out = set()
    for n in tree.leaves():
        if n.graph is not None and getattr(n.graph, "is_read_sequence",
                                           False):
            out.add(n.name)
    return out


def _all_descendants_reads(node: TreeNode) -> bool:
    return all(n.graph is not None
               and getattr(n.graph, "is_read_sequence", False)
               for n in node.leaves())


def _closest_reference_leaf(node: TreeNode) -> tuple[float, str]:
    """(distance, name) of the nearest non-read leaf below node."""
    best_d, best = -1.0, ""
    for leaf in node.leaves():
        if leaf.graph is not None and getattr(leaf.graph,
                                              "is_read_sequence", False):
            continue
        d = _depth_between(node, leaf)
        if d is not None and (best_d < 0 or d < best_d):
            best_d, best = d, leaf.name
    return best_d, best


def _depth_between(anc: TreeNode, leaf: TreeNode) -> float | None:
    if anc is leaf:
        return 0.0
    for c in anc.children:
        d = _depth_between(c, leaf)
        if d is not None:
            return d + c.dist
    return None


def closest_reference_leaves(tree: TreeNode) -> set[str]:
    """For every internal node with exactly one all-reads child subtree,
    the nearest reference leaf on the other side
    (Node::get_closest_reference_leaves, node.h:845-875)."""
    names: set[str] = set()

    def rec(n: TreeNode):
        if n.is_leaf:
            return
        for c in n.children:
            rec(c)
        lr = _all_descendants_reads(n.left)
        rr = _all_descendants_reads(n.right)
        if lr != rr:
            side = n.right if lr else n.left
            _, name = _closest_reference_leaf(side)
            if name:
                names.add(name)

    rec(tree)
    return names


def parent_child_pairs(tree: TreeNode) -> list[tuple[str, str]]:
    """(parent, child) name pairs, children-first postorder
    (Node::get_parent_child_pairs, node.h:1556-1568)."""
    pairs: list[tuple[str, str]] = []

    def rec(n: TreeNode):
        if n.is_leaf:
            return
        rec(n.left)
        rec(n.right)
        pairs.append((n.name, n.left.name))
        pairs.append((n.name, n.right.name))

    rec(tree)
    return pairs


def tagged_topology(tree: TreeNode) -> str:
    """Newick topology with node labels, no branch lengths
    (Node::print_tagged_topology, node.h:1797-1816)."""
    def rec(n: TreeNode) -> str:
        if n.is_leaf:
            return n.name
        return "(%s,%s)%s" % (rec(n.left), rec(n.right), n.name)
    if tree.is_leaf:
        return ""
    return "(%s,%s)%s;" % (rec(tree.left), rec(tree.right), tree.name)


def print_nhx_tree(tree: TreeNode) -> str:
    """NHX tree string with [&&NHX:TID=...] tags where present
    (Node::print_nhx_tree, node.h:1613-1660)."""
    def tag(n: TreeNode) -> str:
        if n.nhx_tid:
            return "[&&NHX:TID=%s]" % n.nhx_tid
        return ""

    def rec(n: TreeNode) -> str:
        if n.is_leaf:
            return "%s:%s%s" % (n.name, _fmt(n.dist), tag(n))
        return "(%s,%s):%s%s" % (rec(n.left), rec(n.right),
                                 _fmt(n.dist), tag(n))

    if tree.is_leaf:
        return ""
    return "(%s,%s):%s%s;" % (rec(tree.left), rec(tree.right),
                              _fmt(tree.dist), tag(tree))


def _fmt(d: float) -> str:
    return ("%g" % d)


def write_nhx_tree(tree: TreeNode, path: str, suffix: str = "nhx_tree"):
    with open(path + "." + suffix, "w") as f:
        f.write(print_nhx_tree(tree))


# ----------------------------------------------------------------------
# evolutionary events (--events)

def count_events(tree: TreeNode, alignment: list[FastaEntry],
                 out_prefix: str, data_type: str = "dna",
                 is_codon: bool = False, mt: bool = False) -> str:
    """List per-branch substitutions / insertions / deletions by
    comparing each parent row to its child rows. The alignment must
    include ancestor rows. Returns the text written to
    <out_prefix>.events (bppancestors.cpp:319-470)."""
    from ..io.translate import codon_to_amino
    seqs = {e.name: e.sequence for e in alignment}
    word = 3 if is_codon else 1
    lines = ["Alignment topology with node labels:", "",
             tagged_topology(tree), "", "",
             "Inferred evolutionary events per branch:"]

    for parent, child in parent_child_pairs(tree):
        ps = seqs.get(parent)
        cs = seqs.get(child)
        if ps is None or cs is None:
            continue
        subs, ins, dels = [], [], []
        pg = cg = False
        lines.append("")
        lines.append("branch " + child)
        for i in range(0, len(ps), word):
            site = i // word + 1
            pc = ps[i:i + word]
            cc = cs[i:i + word]
            p_real = not all(ch in "-." for ch in pc)
            c_real = not all(ch in "-." for ch in cc)
            if p_real and not c_real and not cg:
                cg = True
                dels.append(" %d" % site)
            if not p_real and c_real and not pg:
                pg = True
                ins.append(" %d" % site)
            if p_real and pg:
                pg = False
                ins.append("..%d insertion\n" % (site - 1))
            if c_real and cg:
                cg = False
                dels.append("..%d deletion\n" % (site - 1))
            if p_real and c_real and pc != cc:
                s = " %d %s -> %s" % (site, pc, cc)
                if is_codon:
                    pa = codon_to_amino(pc, mt=mt)
                    ca = codon_to_amino(cc, mt=mt)
                    s += " (%s)" % pa if pa == ca else \
                         " (%s -> %s)" % (pa, ca)
                subs.append(s + "\n")
        # close runs that extend to the last alignment column
        if pg:
            ins.append("..%d insertion\n" % site)
        if cg:
            dels.append("..%d deletion\n" % site)
        lines.append("".join(subs) + "".join(ins) + "".join(dels))

    text = "\n".join(lines) + "\n"
    with open(out_prefix + ".events", "w") as f:
        f.write(text)
    return text


# ----------------------------------------------------------------------
# prune / trim extended alignments

def remove_gap_only_columns(entries: list[FastaEntry]):
    """In-place removal of columns that are gaps in every row
    (Fasta_reader::remove_gap_only_columns)."""
    if not entries:
        return
    ncol = len(entries[0].sequence)
    keep = [j for j in range(ncol)
            if any(e.sequence[j] not in "-." for e in entries)]
    for e in entries:
        e.sequence = "".join(e.sequence[j] for j in keep)


def trim_alignment(alignment: list[FastaEntry], readnames: set[str],
                   keep_sites: int = 15) -> list[FastaEntry]:
    """Keep only the column span covered by query/read rows, widened by
    keep_sites on both ends (input_output_parser.cpp:813-856)."""
    if not alignment:
        return []
    ncol = len(alignment[0].sequence)
    first, last = ncol, 0
    for e in alignment:
        if e.name not in readnames:
            continue
        for i, ch in enumerate(e.sequence):
            if ch != "-":
                first = min(first, i)
                last = max(last, i)
    if first > last:
        # no read row covers any column (e.g. a run without placement
        # reads): nothing to trim, keep the alignment intact
        log_out("No query rows to trim around; alignment kept "
                "untrimmed.\n", 1)
        return [FastaEntry(name=e.name, comment=e.comment,
                           sequence=e.sequence) for e in alignment]
    first = max(first - keep_sites, 0)
    last = min(last + keep_sites, ncol)
    return [FastaEntry(name=e.name, comment=e.comment,
                       sequence=e.sequence[first:last])
            for e in alignment]


def _prune_tree_keep(tree: TreeNode, keep: set[str]) -> TreeNode | None:
    """Copy of the tree with only `keep` leaves; unary nodes collapsed
    with summed branch lengths (Node::prune_tree)."""
    def rec(n: TreeNode) -> TreeNode | None:
        if n.is_leaf:
            if n.name in keep:
                return TreeNode(name=n.name, dist=n.dist,
                                nhx_tid=n.nhx_tid)
            return None
        kids = [rec(c) for c in n.children]
        kids = [k for k in kids if k is not None]
        if not kids:
            return None
        if len(kids) == 1:
            kids[0].dist += n.dist
            return kids[0]
        return TreeNode(name=n.name, dist=n.dist, children=kids,
                        nhx_tid=n.nhx_tid)
    return rec(tree)


def maxmin_distant_subset(tree: TreeNode, candidates: set[str],
                          n_keep: int) -> set[str]:
    """Greedy max-min tree-distance subsample of reference leaves — the
    in-framework replacement for the BppPhySamp subprocess
    (bppphysamp_tree.cpp; input_output_parser.cpp:948-966)."""
    leaves = [l for l in tree.leaves() if l.name in candidates]
    if len(leaves) <= n_keep:
        return {l.name for l in leaves}
    dist2, depth = _leaf_distances(tree, with_depth=True)

    names = [l.name for l in leaves]
    # start from the deepest leaf
    first = max(range(len(names)),
                key=lambda i: max(depth[names[i]].values()))

    from .. import native
    if len(names) > 32:
        import numpy as np
        mat = np.zeros((len(names), len(names)))
        for i, a in enumerate(names):
            for j in range(i + 1, len(names)):
                mat[i, j] = mat[j, i] = dist2(a, names[j])
        keep_mask = native.maxmin_subsample(mat, n_keep, first)
        if keep_mask is not None:
            return {nm for nm, k in zip(names, keep_mask) if k}

    kept = [names[first]]
    rest = [nm for nm in names if nm != kept[0]]
    while len(kept) < n_keep and rest:
        nxt = max(rest, key=lambda nm: min(dist2(nm, k) for k in kept))
        kept.append(nxt)
        rest.remove(nxt)
    return set(kept)


def threshold_distant_subset(tree: TreeNode, candidates: set[str],
                             threshold: float,
                             seq_length: dict[str, int]) -> set[str]:
    """--prune-keep-threshold: BppPhySamp's deletion_method=threshold
    with choice_criterion=length (bppphysamp_tree.cpp:161-168): while
    any two kept reference leaves are closer than `threshold` in tree
    distance, drop the one with the shorter (ungapped) sequence."""
    import numpy as np
    leaves = [l for l in tree.leaves() if l.name in candidates]
    names = [l.name for l in leaves]
    n = len(names)
    if n < 2:
        return set(names)
    dist = _leaf_distances(tree)
    # one O(n^2) matrix; deletions just mask rows/columns
    mat = np.full((n, n), np.inf)
    for i in range(n):
        for j in range(i + 1, n):
            mat[i, j] = mat[j, i] = dist(names[i], names[j])
    lengths = np.array([seq_length.get(nm, 0) for nm in names])
    alive = np.ones(n, bool)
    while alive.sum() > 1:
        sub = np.where(alive, mat, np.inf)
        sub = np.where(alive[:, None], sub, np.inf)
        i, j = np.unravel_index(np.argmin(sub), sub.shape)
        if sub[i, j] >= threshold:
            break
        drop = i if lengths[i] <= lengths[j] else j
        alive[drop] = False
    return {nm for nm, a in zip(names, alive) if a}


def _leaf_distances(tree: TreeNode, with_depth: bool = False):
    """Pairwise leaf tree-distance function via root paths (LCA depth);
    with_depth also returns the per-leaf root-path depth map."""
    depth: dict[str, dict[int, float]] = {}

    def paths(n: TreeNode, acc, d):
        acc = acc + [(id(n), d)]
        if n.is_leaf:
            depth[n.name] = dict(acc)
        for c in n.children:
            paths(c, acc, d + c.dist)

    paths(tree, [], 0.0)

    def dist2(a: str, b: str) -> float:
        pa, pb = depth[a], depth[b]
        da = max(pa.values())
        db = max(pb.values())
        lca = max((d for k, d in pa.items() if k in pb), default=0.0)
        return da + db - 2 * lca

    return (dist2, depth) if with_depth else dist2


def prune_extended_alignment(tree: TreeNode, alignment: list[FastaEntry],
                             keep_number: int = 0,
                             keep_closest: bool = False,
                             keep_threshold: float | None = None,
                             trim: bool = False, trim_keep_sites: int = 15):
    """Pruned views of a placement alignment. Returns a list of
    (suffix, entries, pruned_tree) outputs
    (input_output_parser.cpp:930-1016)."""
    readnames = read_node_names(tree)
    outs = []

    def build(keep: set[str], suffix: str):
        kept = [e for e in alignment if e.name in keep]
        kept = [FastaEntry(name=e.name, comment=e.comment,
                           sequence=e.sequence) for e in kept]
        remove_gap_only_columns(kept)
        if trim:
            kept = trim_alignment(kept, readnames, trim_keep_sites)
        ptree = _prune_tree_keep(tree, keep)
        outs.append((suffix, kept, ptree))

    if keep_threshold is not None:
        # --prune-keep-threshold wins over --prune-keep-number
        # (bppphysamp_tree.cpp:161: threshold= ... deletion_method=threshold)
        refs = {l.name for l in tree.leaves()} - readnames
        lengths = {e.name: sum(c not in "-." for c in e.sequence)
                   for e in alignment}
        keep = threshold_distant_subset(tree, refs, keep_threshold,
                                        lengths) | readnames
        build(keep, ".pruned")
    elif keep_number > 1:
        refs = {l.name for l in tree.leaves()} - readnames
        keep = maxmin_distant_subset(tree, refs, keep_number) | readnames
        build(keep, ".pruned")
    else:
        if len(readnames) > 1:
            build(set(readnames), ".pruned")
        else:
            log_out("Only one query sequence: pruned alignment without "
                    "reference not meaningful.\n", 0)
    if keep_closest:
        keep = closest_reference_leaves(tree) | readnames
        build(keep, ".pruned_closest")
    return outs
