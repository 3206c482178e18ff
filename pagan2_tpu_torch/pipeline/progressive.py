"""Tree-guided progressive alignment driver.

Ported from pagan2_tpu/pipeline/progressive.py. Equivalent of
Node::start_alignment / align_sequences_this_node / get_alignment
(src/main/node.cpp:52-345, :537-832). The guide tree is executed in
*generations*: every node whose two children are done is ready, and one
generation's pairwise alignments are independent jobs — the unit that
gets batched into one kernel launch per shape bucket on `device`, or
one a shard over the jobs mesh `mesh` (parallel/executor.py), the
reference's OpenMP wavefront, node.cpp:227-269, re-expressed
data-parallel.
"""
from __future__ import annotations

from dataclasses import dataclass, field

from ..graph.builders import build_leaf_graph
from ..graph.sequence_graph import NON_REAL, XSKIPPED, YSKIPPED
from ..io.fasta import FastaEntry, clean_sequence
from ..models import ModelFactory, alphabets as alph
from ..align import AlignSettings
from ..tree.newick import TreeNode, parse_newick


@dataclass
class ProgressiveResult:
    tree: TreeNode
    alignment: list[FastaEntry]
    node_graphs: dict = field(default_factory=dict)


def fix_ambiguous_states(node: TreeNode, model) -> None:
    """Node::fix_ambiguous_states (node.cpp:1610-1636): under
    --mostcommon ancestral calling, a matched ancestral site is flagged
    ambiguous when its children disagree or carry an ambiguity
    character (basic_alignment.cpp:146-155). After each node's
    alignment, any such site whose two descendant state sets share
    exactly ONE state — while more than two states were seen in total —
    is resolved to the shared state, pushed down through the chain of
    ambiguous descendants (set_ambiguous_state, node.cpp:1660-1690).
    Returns the set of tree nodes whose graphs were mutated (the
    push-down rewrites DESCENDANT graphs too — checkpointing re-saves
    them)."""
    mutated: dict = {}    # id(node) -> node (TreeNode is unhashable)
    if getattr(model, "ambiguity_type", "wildcard") != "mostcommon":
        return mutated
    from ..utils import ensure_recursion_for_depth, tree_depth
    ensure_recursion_for_depth(tree_depth(node))
    g = node.graph
    for j in range(1, g.num_sites() - 1):
        if not g.ambiguous[j]:
            continue
        lj = g.child_l[j]
        rj = g.child_r[j]
        ls: set[int] = set()
        rs: set[int] = set()
        if lj >= 0:
            _gather_ambiguous_states(node.left, lj, ls)
        if rj >= 0:
            _gather_ambiguous_states(node.right, rj, rs)
        shared = ls & rs
        if len(shared) == 1 and len(ls) + len(rs) > 2:
            _set_ambiguous_state(node, j, next(iter(shared)), mutated)
    return mutated


def _gather_ambiguous_states(node: TreeNode, pos: int, out: set) -> None:
    """Node::get_ambiguous_states (node.cpp:1639-1658): the state codes
    of the nearest non-ambiguous descendants (iterative: ambiguity
    chains can run the full depth of a ladder tree)."""
    stack = [(node, pos)]
    while stack:
        n, p = stack.pop()
        g = n.graph
        if not g.ambiguous[p]:
            out.add(int(g.states[p]))
            continue
        lj = g.child_l[p]
        rj = g.child_r[p]
        if lj >= 0:
            stack.append((n.left, lj))
        if rj >= 0:
            stack.append((n.right, rj))


def _set_ambiguous_state(node: TreeNode, pos: int, state: int,
                         mutated: dict) -> bool:
    """Node::set_ambiguous_state (node.cpp:1660-1690). Reference-
    verbatim quirks kept: only a direct non-ambiguous descendant with
    the matching state lets its parent take the state (an ambiguous
    site always reports False upward, node.cpp:1688), and the right
    branch is only tried when the left one did not succeed."""
    g = node.graph
    if not g.ambiguous[pos]:
        return int(g.states[pos]) == state
    lj = g.child_l[pos]
    rj = g.child_r[pos]
    anc_syms = alph.ancestral_symbols(g.data_type)
    cont = True
    if lj >= 0 and _set_ambiguous_state(node.left, lj, state, mutated):
        g.states[pos] = int(state)
        g.symbols[pos] = anc_syms[state]
        mutated[id(node)] = node
        cont = False
    if rj >= 0 and cont and _set_ambiguous_state(node.right, rj, state,
                                                 mutated):
        g.states[pos] = int(state)
        g.symbols[pos] = anc_syms[state]
        mutated[id(node)] = node
    return False


def match_sequences_to_tree(tree: TreeNode, entries: list[FastaEntry]):
    """Fasta_reader::place_sequences_to_nodes equivalent: leaf names must
    match sequence names (silent prefix matching like the reference's
    relaxed matching is not attempted)."""
    by_name = {e.name: e for e in entries}
    missing = [l.name for l in tree.leaves() if l.name not in by_name]
    if missing:
        raise ValueError(f"sequences missing for tree leaves: {missing}")
    return {l.name: by_name[l.name] for l in tree.leaves()}


def generations(tree: TreeNode):
    """Yield lists of internal nodes whose children are both finished —
    the OpenMP readiness rule (node.cpp:240-264)."""
    done = {id(l) for l in tree.leaves()}
    pending = [n for n in tree.nodes_postorder() if not n.is_leaf]
    while pending:
        ready = [n for n in pending
                 if id(n.left) in done and id(n.right) in done]
        if not ready:
            raise RuntimeError("guide tree scheduling stuck")
        yield ready
        for n in ready:
            done.add(id(n))
        pending = [n for n in pending if id(n) not in done]


def align_progressive(entries: list[FastaEntry], tree: TreeNode | str,
                      data_type: str | None = None,
                      settings: AlignSettings | None = None,
                      model_factory: ModelFactory | None = None,
                      engine: str = "auto",
                      include_internal_nodes: bool = False,
                      mode454: bool = False,
                      homopolymer: bool = False,
                      checkpoint_dir: str | None = None,
                      device="cuda", mesh=None) -> ProgressiveResult:
    if isinstance(tree, str):
        tree = parse_newick(tree)
    if not getattr(tree, "branch_rules_applied", False):
        # default rules only when the CLI has not already applied the
        # user's --real/--fixed/--scale/--truncate-branches choices
        tree.apply_branch_length_rules()
    tree.name_internal()

    if data_type is None:
        from ..io.fasta import guess_data_type
        data_type = guess_data_type(entries)

    settings = settings or AlignSettings()
    if model_factory is None:
        if data_type == alph.DNA:
            from ..io.fasta import empirical_dna_frequencies
            pi = empirical_dna_frequencies(entries)
            model_factory = ModelFactory(alph.DNA, dna_pi=pi)
        else:
            model_factory = ModelFactory(data_type)

    seq_map = match_sequences_to_tree(tree, entries)
    for leaf in tree.leaves():
        seq = clean_sequence(seq_map[leaf.name].sequence, data_type)
        leaf.graph = build_leaf_graph(seq, data_type, mode454=mode454,
                                      homopolymer=homopolymer)

    # mid-run checkpointing (framework extension; the reference has
    # none, SURVEY §5): finished subtree graphs persist as npz and a
    # restarted run skips them
    ckpt = None
    if checkpoint_dir:
        ckpt = _checkpointer(checkpoint_dir, tree, seq_map, data_type,
                             settings, model_factory, engine, mode454,
                             homopolymer, include_internal_nodes)

    # generation-wise execution: each generation's jobs are independent,
    # so they run as one batched kernel launch per shape bucket (the
    # reference's OpenMP wavefront, node.cpp:227-269, re-expressed
    # data-parallel)
    from ..parallel.executor import PairJob, execute_pair_jobs
    from ..utils import log_progress, finish_progress
    n_internal = sum(1 for _ in tree.nodes_postorder()) - \
        sum(1 for _ in tree.leaves())
    done = 0
    for gen in generations(tree):
        jobs = []
        for node in gen:
            if ckpt is not None:
                g = ckpt(node)
                if g is not None:
                    node.graph = g
                    continue
            dist = node.left.dist + node.right.dist
            model = model_factory.alignment_model(dist)
            jobs.append(PairJob(node.left.graph, node.right.graph, model,
                                settings,
                                left_branch_length=node.left.dist,
                                right_branch_length=node.right.dist,
                                key=node))
        done += len(gen)
        # "aligning node X (k/n)" progress line (node.cpp:60)
        log_progress("aligning %d node%s (%d/%d)"
                     % (len(jobs), "s" if len(jobs) != 1 else "",
                        done, n_internal), 0)
        for job, (anc, _end) in zip(
                jobs, execute_pair_jobs(jobs, engine=engine,
                                        device=device, mesh=mesh)):
            job.key.graph = anc
            # --mostcommon: resolve ambiguity chains now that the
            # subtree below this node is complete (node.cpp:167)
            mutated = fix_ambiguous_states(job.key, job.model)
            if ckpt is not None:
                ckpt(job.key, write_graph=anc)
                for d in mutated.values():
                    if d is not job.key:
                        ckpt(d, write_graph=d.graph)
    finish_progress()

    alignment = extract_alignment(tree, include_internal_nodes,
                                  data_type=data_type)
    return ProgressiveResult(tree=tree, alignment=alignment)


def _checkpointer(checkpoint_dir, tree, seq_map, data_type, settings,
                  model_factory, engine, mode454, homopolymer,
                  include_internal_nodes):
    """--checkpoint-dir: the run's fingerprint checked against (or
    written to) the directory's manifest.json, and ckpt(node) -> graph
    or None, ckpt(node, write_graph=g) saving one node's graph as npz.
    A directory of another run raises ValueError; an unreadable node
    file is recomputed."""
    import dataclasses
    import hashlib
    import json
    import os
    import zipfile

    import numpy as np

    from ..graph.serialize import graph_to_npz, graph_from_npz
    from ..utils import log_out
    os.makedirs(checkpoint_dir, exist_ok=True)
    # fingerprint the run: node names are #N# for every tree, so a
    # reused directory from a DIFFERENT run would silently load
    # foreign graphs without this check
    h = hashlib.sha256()
    for leaf in sorted(tree.leaves(), key=lambda n: n.name):
        h.update(leaf.name.encode())
        h.update(seq_map[leaf.name].sequence.encode()
                 if leaf.name in seq_map else b"")
    h.update(tree.to_newick().encode())
    h.update(data_type.encode())
    # alignment-relevant configuration: re-running the same input with
    # different model/alignment settings against an existing directory
    # must NOT silently load graphs computed under the old parameters
    h.update(repr(sorted(dataclasses.asdict(settings).items())).encode())
    h.update(repr((engine, mode454, homopolymer,
                   include_internal_nodes)).encode())
    # q encodes pi AND kappa/rho (HKY) — hashing pi alone would miss
    # --dna-kappa/--dna-rho changes
    h.update(np.asarray(model_factory.q, np.float64).tobytes())
    h.update(repr((np.asarray(model_factory.pi, np.float64).tolist(),
                   model_factory.indel,
                   model_factory.score_scaling,
                   model_factory.ambiguity_factor,
                   model_factory.pileup_454,
                   model_factory.mostcommon)).encode())
    fp = h.hexdigest()
    manifest = os.path.join(checkpoint_dir, "manifest.json")
    if os.path.exists(manifest):
        try:
            with open(manifest) as f:
                old = json.load(f).get("fingerprint")
        except (OSError, ValueError, AttributeError):
            old = None      # unreadable manifest: not this run's
        if old != fp:
            raise ValueError(
                "checkpoint dir %r belongs to a different run "
                "(input/tree/settings fingerprint mismatch — "
                "the fingerprint also covers model and alignment "
                "configuration, and its scheme can change between "
                "framework versions); use one directory per run"
                % checkpoint_dir)
    else:
        with open(manifest, "w") as f:
            json.dump({"fingerprint": fp}, f)

    def path(node):
        safe = node.name.replace("#", "n").replace("/", "_")
        return os.path.join(checkpoint_dir, safe + ".npz")

    def ckpt(node, write_graph=None):
        if write_graph is not None:
            graph_to_npz(write_graph, path(node))
            return None
        p = path(node)
        if os.path.exists(p):
            try:
                return graph_from_npz(p)
            except (OSError, ValueError, KeyError, EOFError,
                    zipfile.BadZipFile) as e:   # corrupt checkpoint: redo
                log_out("checkpoint %s unreadable (%s); "
                        "recomputing\n" % (p, e), 1)
        return None

    return ckpt


# ----------------------------------------------------------------------
@dataclass
class _Insertion:
    """Insertion_at_node (node.h): a child site not referenced by its
    parent's columns (query placement inserts these)."""
    node_name: str
    site: int
    left_child: bool


def extract_alignment(tree: TreeNode, include_internal_nodes=False,
                      data_type: str = "dna",
                      insertion_aware: bool | None = None
                      ) -> list[FastaEntry]:
    """Node::get_alignment (node.cpp:537-624): walk root columns and
    recursively expand child columns. When a placement splice shifted
    site indices (Node::sequence_site_index_needs_correcting), use the
    insertion-aware path (node.cpp:578-624) that re-expands child sites
    skipped by the parent (additional_sites_before_alignment_column,
    node.cpp:976-1059)."""
    from ..utils import ensure_recursion_for_depth, tree_depth
    ensure_recursion_for_depth(tree_depth(tree))
    if insertion_aware is None:
        insertion_aware = getattr(tree, "site_index_corrected", False)
    if include_internal_nodes:
        nodes = list(tree.nodes_inorder())
    else:
        nodes = list(tree.leaves())
    entries = [FastaEntry(name=n.name) for n in nodes]
    rows = [[] for _ in nodes]

    root = tree.graph
    anc_syms = alph.ancestral_symbols(data_type)

    def column_at(node: TreeNode, j: int, out: list):
        g = node.graph
        if node.is_leaf:
            out.append(g.symbols[j])
            return
        lj = g.child_l[j]
        rj = g.child_r[j]
        if lj >= 0:
            column_at(node.left, lj, out)
        else:
            k = (node.left.num_leaves() if not include_internal_nodes
                 else 2 * node.left.num_leaves() - 1)
            out.extend([g.gap_symbol] * k)
        if include_internal_nodes:
            st = g.states[j]
            c = anc_syms[st] if st >= 0 else g.gap_symbol
            if g.path_state[j] in (XSKIPPED, YSKIPPED) or \
                    g.site_type[j] == NON_REAL:
                c = g.gap_symbol
            out.append(c)
        if rj >= 0:
            column_at(node.right, rj, out)
        else:
            k = (node.right.num_leaves() if not include_internal_nodes
                 else 2 * node.right.num_leaves() - 1)
            out.extend([g.gap_symbol] * k)

    def additional_sites_before(node: TreeNode, j: int,
                                additions: list[_Insertion]):
        """additional_sites_before_alignment_column (node.cpp:976-1059)."""
        if node.is_leaf:
            return
        g = node.graph
        lj = g.child_l[j]
        rj = g.child_r[j]
        if j > 0:
            prev_lj = -1
            jj = j
            while jj > 0:
                prev_lj = g.child_l[jj - 1]
                if prev_lj >= 0:
                    break
                jj -= 1
            prev_rj = -1
            jj = j
            while jj > 0:
                prev_rj = g.child_r[jj - 1]
                if prev_rj >= 0:
                    break
                jj -= 1
            if lj > 0 and prev_lj >= 0 and lj - prev_lj != 1:
                for k in range(prev_lj + 1, lj):
                    additional_sites_before(node.left, k, additions)
                    additions.append(_Insertion(node.name, k, True))
            if rj > 0 and prev_rj >= 0 and rj - prev_rj != 1:
                for k in range(prev_rj + 1, rj):
                    additional_sites_before(node.right, k, additions)
                    additions.append(_Insertion(node.name, k, False))
        if lj >= 0:
            additional_sites_before(node.left, lj, additions)
        if rj >= 0:
            additional_sites_before(node.right, rj, additions)

    def columns_before(node: TreeNode, ins: _Insertion, out: list):
        """get_multiple_alignment_columns_before (node.cpp:835-889):
        a full-tree column that is all gaps except in the subtree that
        owns the inserted site."""
        if node.is_leaf:
            out.append(node.graph.gap_symbol)
            return
        g = node.graph
        if node.name == ins.node_name:
            if ins.left_child:
                column_at(node.left, ins.site, out)
                if include_internal_nodes:
                    out.append(g.gap_symbol)
                columns_before(node.right, ins, out)
            else:
                columns_before(node.left, ins, out)
                if include_internal_nodes:
                    out.append(g.gap_symbol)
                column_at(node.right, ins.site, out)
        else:
            columns_before(node.left, ins, out)
            if include_internal_nodes:
                out.append(g.gap_symbol)
            columns_before(node.right, ins, out)

    # NOTE: non_real (deleted-range) sites still emit columns — deletion
    # only severs graph edges (node.cpp:557-577 iterates all root sites)
    if not insertion_aware:
        for j in range(1, root.num_sites() - 1):
            col: list[str] = []
            column_at(tree, j, col)
            for r, ch in zip(rows, col):
                r.append(ch)
    else:
        for j in range(1, root.num_sites()):
            additions: list[_Insertion] = []
            additional_sites_before(tree, j, additions)
            for ins in additions:
                col: list[str] = []
                if tree.is_leaf:
                    col.append(tree.graph.gap_symbol)
                else:
                    columns_before(tree, ins, col)
                for r, ch in zip(rows, col):
                    r.append(ch)
            if j < root.num_sites() - 1:
                col = []
                column_at(tree, j, col)
                for r, ch in zip(rows, col):
                    r.append(ch)

    for e, r in zip(entries, rows):
        e.sequence = "".join(r)
    return entries
