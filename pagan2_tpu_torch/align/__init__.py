"""Pairwise alignment: anchoring/band planning, the Viterbi dispatch and
the full-probability / path-sampling branch.

Ported from pagan2_tpu/align/__init__.py (`plan_band`, `_band_cells`,
`_acct`, `set_sampling_seed` and `align_pair`). Linear-chain pairs fill
on kernel A (viterbi_linear), or on kernel C (viterbi_banded) when their
anchored band is thin; fan-in graph pairs on kernel B (viterbi_fanin);
full-probability and sampling pairs add the forward/backward plane fills
of kernels D and E (fullprob, fullprob_fill); pairs of two empty
sequences run on the host oracle. Pair-end break penalties ride every
Viterbi fill (kernel A's break column, kernel B's positional vectors,
kernel C's break scalars); the probability planes ignore them, as the
reference's forward and backward passes do.
"""
from .settings import AlignSettings, X_MAT, Y_MAT, M_MAT
from .oracle import PairAligner, PathPtr, MatrixPtr
from .ancestral import build_ancestral_graph
from ..utils import log_out

_RNG = None


def set_sampling_seed(seed):
    """Seed the path-sampling RNG (the reference seeds rand() with
    time(0), main.cpp:92; a fixed seed makes runs reproducible)."""
    global _RNG
    import numpy as np
    _RNG = np.random.default_rng(seed)


def plan_band(left, right, settings):
    """Anchor discovery + tunnel + coverage/memory planning for one pair.

    Returns (band, skipped): band is (upper, lower) per-row column
    bounds, skipped=True means the placement coverage heuristic decided
    to skip the alignment entirely (node.cpp:155-186). Raises
    MemoryError when the band exceeds the memory budget and --force-gap
    cannot rescue it (node.cpp:100-152, settings.cpp:187-190)."""
    from .anchors import (define_tunnel_for_graphs,
                          replace_largest_block_with_gap,
                          tunnel_coverage)
    upper, lower, blocks, cov = \
        define_tunnel_for_graphs(
            left, right,
            use_prefix_anchors=settings.use_prefix_anchors,
            use_hmmer_anchors=settings.use_hmmer_anchors,
            prefix_hit_length=settings.prefix_hit_length,
            width=settings.anchors_offset,
            threshold_total=settings.anchor_threshold_total,
            threshold_partly=settings.anchor_threshold_partly)
    band = (upper, lower)
    # viterbi_alignment.cpp:176-179
    log_out("Computing %.0f%% of DP matrix." % (cov * 100), 1)
    # skip-if-poorly-anchored placement heuristic (node.cpp:155-186;
    # active only when the CLI set anchoring_threshold < 1 for a
    # query run)
    if cov > settings.anchoring_threshold:
        log_out("anchoring coverage %.3f is above the threshold. "
                "Skipping the full alignment." % cov, 1)
        return band, True
    # memory budget + --force-gap rescue loop (node.cpp:100-152,
    # settings.cpp:187-190). Our banded fill stores 3 f32 score
    # planes + 1 int8 backpointer per in-band cell (13 B/cell vs the
    # reference's ~195 B across its three matrices).
    L1 = left.num_sites() - 1
    R1 = right.num_sites() - 1
    limit = settings.memory_limit_mb * 1024 * 1024
    while True:
        cells = cov * float(L1) * float(R1)
        mem = int(cells * 13) + 50 * 1024 * 1024
        if mem <= limit:
            break
        if not settings.force_gap:
            raise MemoryError(
                "Memory usage over limits (~%d bytes, allowed %d). "
                "Allow more RAM (--memory-for-single-alignment) or "
                "--force-gap to continue." % (mem, limit))
        log_out("Memory usage over limits, replacing largest poorly "
                "aligned block with a gap.", 1)
        squeezed = replace_largest_block_with_gap(
            band[0], band[1], blocks,
            threshold=settings.force_gap_threshold)
        if squeezed is None:
            raise MemoryError(
                "Memory usage over limits (no more gaps to force); "
                "allow more RAM or decrease force-gap-threshold to "
                "continue.")
        band = squeezed
        cov = tunnel_coverage(band[0], band[1], L1, R1)
    return band, False


def _acct(t0, cells):
    """Count a single-job fill in the executor's launch counters so the
    CLI --time report derives a real GCUPS figure for sequential runs
    too (batched launches account for themselves in executor.py)."""
    import time
    from ..parallel.executor import EXEC_STATS
    EXEC_STATS["batched_cells"] += int(cells)
    EXEC_STATS["fill_seconds"] += time.perf_counter() - t0
    EXEC_STATS["single_fills"] = EXEC_STATS.get("single_fills", 0) + 1


def _acct_fanin_route(band, L, R):
    """Count an anchored fan-in fill as windowed or masked at full
    width, by the choice fanin_align_path makes for this band."""
    from ..parallel.executor import EXEC_STATS
    from .viterbi_fanin import band_window
    windowed = band_window(band, L, R)[0] is not None
    EXEC_STATS["fanin_windowed" if windowed else "fanin_banded_full"] += 1


def _band_cells(band, L, R):
    """In-band cell count (the work a banded fill actually does)."""
    import numpy as np
    if band is None:
        return L * R
    u = np.maximum(np.asarray(band[0][:L], np.int64), 0)
    lo = np.minimum(np.asarray(band[1][:L], np.int64), R - 1)
    return int(np.sum(np.clip(lo - u + 1, 0, None)))


def _debug_dump_matrices(aligner, left, right, model, settings,
                         lb, rb):
    """Noise-5 DP matrix dump (Viterbi_alignment::print_matrices,
    viterbi_alignment.cpp:369,2913-3096). When the pair was filled on
    the device (no cell structs to walk) a host oracle fill is redone
    just for the dump — noise 5 is a tiny-input debug mode, so the
    O(L*R) host loops are acceptable there."""
    from ..utils.log import get_noise
    if get_noise() < 5:
        return
    if aligner is None:
        aligner = PairAligner(left, right, model, settings, lb, rb)
        aligner.fill()
    log_out(aligner.print_matrices(), 5)


def align_pair(left, right, model, settings=None, left_branch_length=0.0,
               right_branch_length=0.0, is_reads_sequence=False,
               engine="auto", compute_consensus=False, band=None,
               use_anchors=None, anchor_min_sites=None, rng=None,
               device="cuda"):
    """Align two sequence graphs and build the ancestral graph.

    engine: "oracle" (host loops, ground truth) or "auto"/"jax" (the
    wavefront kernels on `device`). band: explicit (upper, lower)
    tunnel bounds; use_anchors / anchor_min_sites override the
    AlignSettings fields (the reference anchors every pair unless
    --no-anchors, node.cpp:87-152 — pairs are gated by size since small
    matrices are cheaper than anchor discovery).
    Returns (ancestral_graph, end_pointer).
    """
    settings = settings or AlignSettings()
    if is_reads_sequence or settings.keep_all_edges:
        # --keep-all-edges widens the skip limits for ordinary
        # alignments too (viterbi_alignment.cpp:206)
        settings = settings.for_reads()

    if settings.pair_end_reads and settings.reduced_terminal_gap_penalties:
        # strip the break markers once, up front, so every engine
        # (oracle, kernels A, B, C, D and E) sees the same read1
        # boundaries (mark_no_gap_penalty_sites, basic_alignment.h:
        # 630-676). The strip changes the graphs in place: a graph
        # stripped before keeps its sites and gives -1 here.
        from dataclasses import replace
        from .oracle import mark_no_gap_penalty_sites
        xr = mark_no_gap_penalty_sites(left)
        yr = mark_no_gap_penalty_sites(right)
        if xr >= 0 or yr >= 0:
            settings = replace(settings, x_read1_length=xr,
                               y_read1_length=yr)

    sampling = settings.sample_path or settings.sample_additional_paths > 0
    if sampling and not settings.compute_full_score:
        # sampling draws from fwd probabilities (basic_alignment.h:621-625)
        from dataclasses import replace
        settings = replace(settings, compute_full_score=True)
    if sampling or settings.compute_full_score:
        import numpy as np
        from .viterbi_sheared import is_linear_chain
        if sampling:
            rng = rng or _RNG or np.random.default_rng()
        linear_pair = is_linear_chain(left) and is_linear_chain(right)
        # every pair the device can hold takes the device fills, whatever
        # its fan-in or edge offsets (kernels D and E take runtime K, G)
        use_device = (engine != "oracle"
                      and left.num_sites() + right.num_sites() > 4)
        from ..io import plots
        import time as _time
        _t0 = _time.perf_counter()
        _Lc = left.num_sites() - 1
        _Rc = right.num_sites() - 1
        if use_device:
            # device fwd/bwd probability planes replace the oracle's
            # O(L*R) host loops
            from ..device import resolve_device
            from .fullprob import (FullProbPlanes, fullprob_viterbi_path,
                                   sample_path_planes)
            device = resolve_device(device)
            planes = FullProbPlanes(left, right, model, settings,
                                    fanin=not linear_pair, device=device)
            if plots.posterior_sink_active():
                plots.add_posterior_figure_planes(planes)
            if settings.sample_path:
                path, end = sample_path_planes(planes, settings, rng,
                                               left_branch_length,
                                               right_branch_length)
            else:
                path, end, planes = fullprob_viterbi_path(
                    left, right, model, settings,
                    left_branch_length, right_branch_length,
                    planes=planes, linear=linear_pair, device=device)

            def draw_extra():
                return sample_path_planes(planes, settings, rng,
                                          left_branch_length,
                                          right_branch_length)[0]
        else:
            aligner = PairAligner(left, right, model, settings,
                                  left_branch_length, right_branch_length)
            end = aligner.fill()
            if plots.posterior_sink_active():
                plots.add_posterior_figure(aligner)
            if settings.sample_path:
                path, _send = aligner.sample_path(rng)
            else:
                path = aligner._backtrack(PathPtr(end, True))

            def draw_extra():
                return aligner.sample_path(rng)[0]
        _acct(_t0, _Lc * _Rc)
        _debug_dump_matrices(None if use_device else aligner,
                             left, right, model, settings,
                             left_branch_length, right_branch_length)
        anc = build_ancestral_graph(left, right, path, model, settings,
                                    left_branch_length, right_branch_length,
                                    is_reads_sequence,
                                    compute_consensus=compute_consensus)
        if settings.sample_additional_paths > 0:
            from .sampling import merge_sampled_graph
            for _ in range(settings.sample_additional_paths):
                sg = build_ancestral_graph(
                    left, right, draw_extra(), model, settings,
                    left_branch_length, right_branch_length,
                    is_reads_sequence)
                merge_sampled_graph(anc, sg)
        return anc, end

    if use_anchors is None:
        use_anchors = settings.use_anchors
    if anchor_min_sites is None:
        anchor_min_sites = settings.anchor_min_sites

    path = None
    end = None
    _dbg_aligner = None
    # the device kernels fill diagonals d >= 1; a pair of two EMPTY
    # sequences (L = R = 1, corner d = 0) never reaches its corner
    # there — the host oracle handles it
    if engine != "oracle" and left.num_sites() + right.num_sites() > 4:
        import time as _time
        from ..device import resolve_device
        device = resolve_device(device)
        from .viterbi_sheared import is_linear_chain, _bucket
        L = left.num_sites() - 1
        R = right.num_sites() - 1
        if is_linear_chain(left) and is_linear_chain(right):
            if band is None and use_anchors and \
                    min(left.num_sites(), right.num_sites()) > \
                    anchor_min_sites:
                band, skipped = plan_band(left, right, settings)
                if skipped:
                    return None, None
            if band is not None:
                from .viterbi_banded import band_windows
                _ilo, Wreal = band_windows(band[0], band[1], L, R)
                if _bucket(Wreal) * 2 <= _bucket(R):
                    # thin band: the windowed banded fill (kernel C)
                    from ..parallel.executor import EXEC_STATS
                    from .viterbi_banded import banded_align_path
                    log_out("banded DP: window %d of %d cols" % (Wreal, R),
                            2)
                    EXEC_STATS["banded_fills"] += 1
                    _t0 = _time.perf_counter()
                    path, end = banded_align_path(
                        left, right, model, settings, band[0], band[1],
                        left_branch_length, right_branch_length,
                        device=device)
                    _acct(_t0, _band_cells(band, L, R))
            if path is None:
                from .viterbi_linear import linear_align_path
                _t0 = _time.perf_counter()
                path, end = linear_align_path(
                    left, right, model, settings,
                    left_branch_length, right_branch_length, band=band,
                    device=device)
                _acct(_t0, _band_cells(band, L, R))
        else:
            # graph fan-in: ring-of-diagonals kernel for ANY fan-in,
            # banded/windowed like the reference tunnels every pair
            # (tunnel_matrix.h:45-152)
            from .viterbi_fanin import (fanin_align_path,
                                        effective_anchor_gate)
            gate = anchor_min_sites
            if band is None and use_anchors:
                # scan-core-bound pairs anchor from a much smaller size
                # (the reference anchors every pair)
                gate = effective_anchor_gate(left, right, gate)
            if band is None and use_anchors and \
                    min(left.num_sites(), right.num_sites()) > gate:
                band, skipped = plan_band(left, right, settings)
                if skipped:
                    return None, None
            if band is not None:
                _acct_fanin_route(band, L, R)
            _t0 = _time.perf_counter()
            path, end = fanin_align_path(
                left, right, model, settings,
                left_branch_length, right_branch_length, band=band,
                device=device)
            _acct(_t0, _band_cells(band, L, R))

    if path is None:
        import time as _time
        _t0 = _time.perf_counter()
        aligner = PairAligner(left, right, model, settings,
                              left_branch_length, right_branch_length)
        path, end = aligner.align()
        _acct(_t0, (left.num_sites() - 1) * (right.num_sites() - 1))
        _dbg_aligner = aligner

    _debug_dump_matrices(_dbg_aligner, left, right, model, settings,
                         left_branch_length, right_branch_length)
    anc = build_ancestral_graph(left, right, path, model, settings,
                                left_branch_length, right_branch_length,
                                is_reads_sequence,
                                compute_consensus=compute_consensus)
    return anc, end
