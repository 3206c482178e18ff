"""Reference-alignment ingestion: rebuild the graph tree from an
existing alignment + tree without O(L*R) DP.

Node::read_reference_alignment / read_alignment (node.h:909-1013):
post-order over the guide tree, each internal node running the
vector-DP path reader (align/refalign.py) on its children's gapped
rows. Leaves carry their aligned row as ``gapped_seq`` and their
ungapped characters as graph sites. ``quick`` uses one model at
distance 0.5 for every node (node.h:913-917).
"""
from __future__ import annotations

from dataclasses import dataclass, field

from ..io.fasta import FastaEntry
from ..tree.newick import TreeNode, parse_newick
from ..graph import build_leaf_graph
from ..models import ModelFactory, alphabets as alph
from ..align import AlignSettings
from ..align.refalign import read_alignment_pair
from .progressive import (match_sequences_to_tree, generations,
                          ProgressiveResult, extract_alignment)
from ..io.fasta import clean_sequence


def read_reference_alignment(entries: list[FastaEntry],
                             tree: TreeNode | str,
                             data_type: str | None = None,
                             settings: AlignSettings | None = None,
                             model_factory: ModelFactory | None = None,
                             quick: bool = False,
                             perfect_reference: bool = False,
                             reconstruct_ancestors: bool = True
                             ) -> ProgressiveResult:
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

    rows = match_sequences_to_tree(tree, entries)
    lengths = {len(e.sequence) for e in rows.values()}
    if len(lengths) != 1:
        raise ValueError("reference alignment rows differ in length")

    is_codons = data_type == alph.CODON
    for leaf in tree.leaves():
        # '.' is a gap too (fasta cleanup strips both); normalize so
        # the simple-path builder (which tests '-') stays in sync with
        # the leaf graph's real site count
        gapped = rows[leaf.name].sequence.replace(".", "-")
        ungapped = clean_sequence(gapped.replace("-", ""), data_type)
        leaf.graph = build_leaf_graph(ungapped, data_type)
        leaf.graph.gapped_seq = gapped

    quick_model = model_factory.alignment_model(0.5) if quick else None
    for gen in generations(tree):
        for node in gen:
            model = quick_model or model_factory.alignment_model(
                node.left.dist + node.right.dist)
            node.graph = read_alignment_pair(
                node.left.graph, node.right.graph, model, settings,
                left_branch_length=node.left.dist,
                right_branch_length=node.right.dist,
                perfect_reference=perfect_reference,
                is_codons=is_codons)

    if reconstruct_ancestors:
        from .ancestors import reconstruct_parsimony_ancestors
        reconstruct_parsimony_ancestors(tree, alph.get_alphabet(data_type))

    alignment = extract_alignment(tree, False, data_type=data_type)
    return ProgressiveResult(tree=tree, alignment=alignment)
