"""Merging of sampled alignment paths into the ancestral graph.

Equivalent of Viterbi_alignment::merge_sampled_sequence
(src/main/viterbi_alignment.cpp:572-721) over the Unique_index machinery
(src/main/sequence.h:161-213, 872-1004): each site is keyed by the
(left child, right child, match state) triple; sites of the sampled
graph missing from the ancestral graph are copied in together with
their edges, then the site vector is re-sorted by child order and edge
endpoints remapped.
"""
from __future__ import annotations

import functools

from ..graph.sequence_graph import SequenceGraph, START_SITE, STOP_SITE

_MATCH, _XGAP, _YGAP = 0, 1, 2


def unique_index_keys(g: SequenceGraph) -> list[tuple]:
    """initialise_unique_index (sequence.h:872-915). The right-only
    branch tags sites `match`, not `ygap` — reproduced as-is."""
    keys = []
    prev_l = prev_r = 0
    for i in range(g.num_sites()):
        l = g.child_l[i]
        r = g.child_r[i]
        if l > 0 and r > 0:
            k = (l, r, _MATCH)
            prev_l, prev_r = l, r
        elif l > 0:
            k = (l, prev_r, _XGAP)
            prev_l = l
        elif r > 0:
            k = (prev_l, r, _MATCH)
            prev_r = r
        elif g.site_type[i] == START_SITE:
            k = (0, 0, _MATCH)
        elif g.site_type[i] == STOP_SITE:
            k = (prev_l + 1, prev_r + 1, _MATCH)
        else:
            k = (-1, -1, -1)
        keys.append(k)
    return keys


def _comes_before(a: tuple, b: tuple) -> bool:
    """Site::comesBefore (sequence.h:653-657)."""
    return ((a[0] < b[0] and a[1] <= b[1]) or
            (a[0] <= b[0] and a[1] < b[1]))


def _sort_and_remap(g: SequenceGraph, keys: list[tuple]):
    """sort_sites_vector + remap_edges_vector (sequence.h:977-1002)."""
    n = g.num_sites()
    order = sorted(range(n), key=functools.cmp_to_key(
        lambda x, y: -1 if _comes_before(keys[x], keys[y])
        else (1 if _comes_before(keys[y], keys[x]) else 0)))
    new_index = [0] * n
    for new, old in enumerate(order):
        new_index[old] = new

    def perm(lst):
        return [lst[o] for o in order]

    g.states = perm(g.states)
    g.symbols = perm(g.symbols)
    g.site_type = perm(g.site_type)
    g.path_state = perm(g.path_state)
    g.posterior_support = perm(g.posterior_support)
    g.site_bcount_slu = perm(g.site_bcount_slu)
    g.site_bdist_slu = perm(g.site_bdist_slu)
    g.child_l = perm(g.child_l)
    g.child_r = perm(g.child_r)
    g.sumA = perm(g.sumA)
    g.sumC = perm(g.sumC)
    g.sumG = perm(g.sumG)
    g.sumT = perm(g.sumT)
    g.ambiguous = perm(g.ambiguous)
    g.bwd = perm(g.bwd)
    g.fwd = perm(g.fwd)
    for eid in range(len(g.edges)):
        g.edges.start[eid] = new_index[g.edges.start[eid]]
        g.edges.end[eid] = new_index[g.edges.end[eid]]


def merge_sampled_graph(anc: SequenceGraph, sampled: SequenceGraph):
    """Union the sampled graph into the ancestral graph in place."""
    anc_keys = unique_index_keys(anc)
    key_to_site: dict[tuple, int] = {}
    for i, k in enumerate(anc_keys):
        key_to_site.setdefault(k, i)

    sample_keys = unique_index_keys(sampled)
    map_s2a: list[int] = []
    added: list[int] = []
    for i in range(sampled.num_sites()):
        k = sample_keys[i]
        hit = key_to_site.get(k, -1)
        if hit >= 0:
            map_s2a.append(hit)
        else:
            idx = anc.add_site(
                state=sampled.states[i], symbol=sampled.symbols[i],
                path_state=sampled.path_state[i],
                child_l=sampled.child_l[i], child_r=sampled.child_r[i])
            anc.site_bcount_slu[idx] = sampled.site_bcount_slu[i]
            anc.site_bdist_slu[idx] = sampled.site_bdist_slu[i]
            # copy_site_details copies the full site payload
            # (sequence.h): posterior support, ambiguity flag, pileup
            # counts must survive the merge
            anc.posterior_support[idx] = sampled.posterior_support[i]
            anc.ambiguous[idx] = sampled.ambiguous[i]
            anc.sumA[idx] = sampled.sumA[i]
            anc.sumC[idx] = sampled.sumC[i]
            anc.sumG[idx] = sampled.sumG[i]
            anc.sumT[idx] = sampled.sumT[i]
            anc_keys.append(k)
            key_to_site[k] = idx
            map_s2a.append(idx)
            added.append(i)

    def copy_edge(eid):
        s = map_s2a[sampled.edges.start[eid]]
        e = map_s2a[sampled.edges.end[eid]]
        if anc.find_bwd_edge(e, s) >= 0:
            return
        ne = anc.add_edge(s, e, sampled.edges.weight[eid])
        anc.edges.bcount_slu[ne] = sampled.edges.bcount_slu[eid]
        anc.edges.bdist_slu[ne] = sampled.edges.bdist_slu[eid]
        anc.edges.bcount_skip[ne] = sampled.edges.bcount_skip[eid]

    # NB edges are only copied for ADDED sites — the reference does the
    # same (merge_sampled_sequence iterates sample_index_for_added,
    # viterbi_alignment.cpp:624-721), so a sampled path whose sites all
    # exist already contributes no new edges there either; replicated
    # verbatim
    for i in added:
        for eid in sampled.bwd[i]:
            copy_edge(eid)
        for eid in sampled.fwd[i]:
            copy_edge(eid)

    if added:
        _sort_and_remap(anc, anc_keys)
