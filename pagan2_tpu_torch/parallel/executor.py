"""Batched generation executor: one kernel launch per generation bucket.

Ported from pagan2_tpu/parallel/executor.py. The reference runs
independent guide-tree nodes concurrently on CPU threads (boost queue
node.cpp:273-345, OpenMP waves node.cpp:227-269); here one generation's
independent pairwise jobs are stacked into one launch per shape bucket:
linear-chain pairs on kernel A (align/viterbi_linear.py), fan-in graph
pairs on kernel B (align/viterbi_fanin.py), each on `device`; a
thin-band anchored linear pair runs alone on kernel C
(align/viterbi_banded.py). Full-probability and sampling jobs fill their
forward/backward planes on kernels D and E (align/fullprob_fill.py), one
launch each per bucket, beside one kernel A or B launch for the jobs
that follow the Viterbi path. Backtrack, posterior annotation, sampled
draws and ancestral-graph construction stay per job on the host, in job
order (one RNG stream, so a seeded run is reproducible).

Routing reproduces the reference's decisions (`_plan_job`): the
anchoring gates (3000 sites, 200 for scan-core-bound fan-in pairs), the
window-vs-full choice `_bucket(Wreal) * 2 <= _bucket(R)`, and the
single-job dispatch of over-cap and windowed fan-in pairs.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any

import numpy as np

from ..align.settings import AlignSettings
from ..utils import log_out

# observability: kernel-launch / job counters. fill_seconds wraps
# launch+readback wall time so the CLI's --time report can derive a
# real-run GCUPS figure; single-job fills account for themselves via
# align._acct. fanin_windowed / fanin_banded_full count anchored fan-in
# fills that ran windowed or masked at full width, banded_fills the
# windowed banded fills of thin-band linear pairs (kernel C), fp_batches
# / fanin_fp_batches the batched full-probability plane fills.
EXEC_STATS = {"launches": 0, "batched_jobs": 0, "single_jobs": 0,
              "batched_cells": 0, "fill_seconds": 0.0,
              "single_fills": 0, "fanin_batches": 0,
              "fanin_windowed": 0, "fanin_banded_full": 0,
              "banded_fills": 0, "fp_batches": 0, "fanin_fp_batches": 0}


def reset_stats():
    for k in EXEC_STATS:
        EXEC_STATS[k] = 0


@dataclass
class PairJob:
    """One pairwise alignment job (a ready tree node...). `key` is
    opaque caller context."""
    left: Any
    right: Any
    model: Any
    settings: AlignSettings
    left_branch_length: float = 0.0
    right_branch_length: float = 0.0
    is_reads_sequence: bool = False
    compute_consensus: bool = False
    key: Any = None
    # filled by planning
    band: Any = None
    skipped: bool = False


# ----------------------------------------------------------------------
def _plan_job(job: PairJob):
    """Anchor/band planning mirroring align_pair's gate: returns
    'batch' (shared kernel A launch), 'fanin' (shared kernel B launch),
    'banded' (one kernel C fill of a thin-band linear pair), 'batch_fp'
    / 'fanin_fp' (shared kernel D and E launches of full-probability
    and sampling jobs, never anchored), 'single' (align_pair one by one:
    pair-end jobs, and fan-in pairs past the caps or windowed) or
    'skipped'."""
    from ..align import plan_band
    from ..align.viterbi_sheared import is_linear_chain, _bucket

    s = job.settings
    if s.pair_end_reads:
        # align_pair strips the break markers off the graphs before any
        # fill, so every engine sees the same read1 boundaries; such
        # jobs run one by one, Viterbi and full-probability alike
        return "single"
    linear = is_linear_chain(job.left) and is_linear_chain(job.right)
    if s.compute_full_score or s.sample_path or \
            s.sample_additional_paths > 0:
        return "batch_fp" if linear else "fanin_fp"
    gate = s.anchor_min_sites
    if not linear:
        from ..align.viterbi_fanin import (fanin_stats, K_CAP, G_CAP,
                                           scan_core_bound,
                                           SCAN_ANCHOR_MIN_SITES)
        KL, OL = fanin_stats(job.left)
        KR, OR = fanin_stats(job.right)
        if KL > K_CAP or KR > K_CAP or OL + OR > G_CAP:
            return "single"
        if scan_core_bound(KL, OL, KR, OR):
            # the reference fills such pairs on its windowed scan core
            # and anchors them from a much smaller size
            gate = min(gate, SCAN_ANCHOR_MIN_SITES)
    if job.band is None and s.use_anchors and \
            min(job.left.num_sites(), job.right.num_sites()) > gate:
        job.band, job.skipped = plan_band(job.left, job.right, s)
        if job.skipped:
            return "skipped"
    if job.band is not None:
        from ..align.viterbi_banded import band_windows
        L = job.left.num_sites() - 1
        R = job.right.num_sites() - 1
        _ilo, Wreal = band_windows(job.band[0], job.band[1], L, R)
        if _bucket(Wreal) * 2 <= _bucket(R):
            return "banded" if linear else "single"
    return "batch" if linear else "fanin"


def _job_settings(job: PairJob) -> AlignSettings:
    """Per-job effective settings, mirroring align_pair's widening:
    reads jobs AND --keep-all-edges jobs take the permissive skip
    limits (viterbi_alignment.cpp:206) — batched launches must match
    the single-dispatch path or output depends on batch width."""
    s = job.settings
    if job.is_reads_sequence or s.keep_all_edges:
        s = s.for_reads()
    return s


def _run_single(job: PairJob, engine: str, device):
    from ..align import align_pair
    EXEC_STATS["single_jobs"] += 1
    return align_pair(job.left, job.right, job.model, job.settings,
                      job.left_branch_length, job.right_branch_length,
                      is_reads_sequence=job.is_reads_sequence,
                      engine=engine, band=job.band,
                      compute_consensus=job.compute_consensus,
                      device=device)


# batch size cap: cells per launch (the folded match scores, 4 B/cell,
# and the codes dominate a launch's device memory)
MAX_BATCH_CELLS = 1 << 28
# the same for a full-probability launch: six f32 planes per cell come
# back to the host, so a launch holds fewer cells
MAX_FP_BATCH_CELLS = 1 << 26


def execute_pair_jobs(jobs: list[PairJob], engine: str = "auto",
                      device="cuda"):
    """Run independent pairwise jobs, batching eligible ones into shared
    kernel launches (one per shape bucket) on `device`. Returns
    [(ancestral_graph, end_ptr)] in job order. Skipped jobs
    (anchoring-coverage heuristic) yield (None, None)."""
    from ..device import resolve_device
    device = resolve_device(device)
    results: list = [None] * len(jobs)
    if engine == "oracle":
        for i, job in enumerate(jobs):
            results[i] = _run_single(job, engine, device)
        return results

    from ..align.viterbi_sheared import _bucket

    buckets: dict[tuple, list[int]] = {}
    fanin_buckets: dict[tuple, list[int]] = {}
    fp_buckets: dict[tuple, list[int]] = {}
    fanin_fp_buckets: dict[tuple, list[int]] = {}
    for i, job in enumerate(jobs):
        kind = _plan_job(job)
        if kind == "skipped":
            results[i] = (None, None)
        elif kind in ("single", "banded"):
            results[i] = _run_single(job, engine, device)
        else:
            L = job.left.num_sites() - 1
            R = job.right.num_sites() - 1
            key = (_bucket(L), _bucket(R))
            {"batch": buckets, "fanin": fanin_buckets,
             "batch_fp": fp_buckets,
             "fanin_fp": fanin_fp_buckets}[kind].setdefault(
                 key, []).append(i)

    # buckets in the reference's order, jobs in job order inside each:
    # the sampled draws of a seeded run come from one RNG stream
    for bkt, launcher, cap in (
            (buckets, _launch_linear_batch, MAX_BATCH_CELLS),
            (fanin_buckets, _launch_fanin_batch, MAX_BATCH_CELLS),
            (fp_buckets, _launch_fullprob_batch, MAX_FP_BATCH_CELLS),
            (fanin_fp_buckets, _launch_fanin_fullprob_batch,
             MAX_FP_BATCH_CELLS)):
        for (Lp, Rp), idxs in sorted(bkt.items()):
            if len(idxs) == 1:
                # no batching win; single dispatch avoids the stack copy
                i = idxs[0]
                results[i] = _run_single(jobs[i], engine, device)
                continue
            chunk = max(1, cap // (Lp * Rp))
            for c0 in range(0, len(idxs), chunk):
                launcher(jobs, idxs[c0:c0 + chunk], results, engine,
                         device)
    return results


def _launch_linear_batch(jobs, idxs, results, engine, device):
    """One kernel A launch for a bucket of linear-chain jobs, then the
    per-job host backtrack and ancestral build."""
    import time
    from ..align.viterbi_linear import (linear_job_arrays, batch_rows,
                                        linear_batch_args, linear_fill,
                                        _add_scalar_params, _finish_linear)
    from ..align.viterbi_sheared import prepare_sheared
    from ..align.ancestral import build_ancestral_graph

    t_launch = time.perf_counter()
    inputs = []
    for i in idxs:
        job = jobs[i]
        inputs.append(_add_scalar_params(prepare_sheared(
            job.left, job.right, job.model, _job_settings(job),
            np.float32)))
    Lp = batch_rows(inputs)
    pjobs = [linear_job_arrays(inp, Lp, band=jobs[i].band)
             for inp, i in zip(inputs, idxs)]
    codes, corner = linear_fill(**linear_batch_args(pjobs, device))
    codes = codes.cpu().numpy()
    corner = corner.cpu().numpy()
    EXEC_STATS["launches"] += 1
    EXEC_STATS["batched_jobs"] += len(idxs)
    EXEC_STATS["batched_cells"] += sum(inp["L"] * inp["R"]
                                       for inp in inputs)
    log_out("batched launch: %d jobs (%d rows, kernel A)"
            % (len(idxs), Lp), 3)
    EXEC_STATS["fill_seconds"] += time.perf_counter() - t_launch
    for b, i in enumerate(idxs):
        job = jobs[i]
        L, R = inputs[b]["L"], inputs[b]["R"]
        if job.band is not None and not np.isfinite(corner[b]).any():
            # anchored fill dead-ended: full-matrix retry
            # (viterbi_alignment.cpp:298-317)
            job.band = None
            results[i] = _run_single(job, engine, device)
            continue
        path, end = _finish_linear(codes[b], corner[b], job.left,
                                   job.right, job.model, L, R,
                                   job.left_branch_length,
                                   job.right_branch_length)
        anc = build_ancestral_graph(
            job.left, job.right, path, job.model, _job_settings(job),
            job.left_branch_length, job.right_branch_length,
            job.is_reads_sequence,
            compute_consensus=job.compute_consensus)
        results[i] = (anc, end)


def _fanin_batch_paths(jobs, idxs, device):
    """One kernel B launch (full width, band bounds as masks) for a
    bucket of fan-in graph jobs. Returns [(path, end)] per idx; a None
    entry means the banded fill dead-ended and the caller must retry
    that job single (viterbi_alignment.cpp:298-317)."""
    import time
    from ..align.viterbi_fanin import (prepare_fanin, fanin_batch_args,
                                       fanin_fill, finish_fanin)
    t_launch = time.perf_counter()
    inputs = []
    for i in idxs:
        job = jobs[i]
        inp = prepare_fanin(job.left, job.right, job.model,
                            _job_settings(job), dtype=np.float32)
        if job.band is not None:
            L, R = inp["L"], inp["R"]
            inp["band_upper"] = np.clip(
                np.asarray(job.band[0][:L], np.int64), 0,
                R - 1).astype(np.int32)
            inp["band_lower"] = np.clip(
                np.asarray(job.band[1][:L], np.int64), 0,
                R - 1).astype(np.int32)
            EXEC_STATS["fanin_banded_full"] += 1
        inputs.append(inp)
    args = fanin_batch_args(inputs, device)
    KR = args["roff"].shape[2]
    bp, snap = fanin_fill(**args)
    bp = bp.cpu().numpy().view(np.uint32)
    snap = snap.cpu().numpy()
    EXEC_STATS["launches"] += 1
    EXEC_STATS["fanin_batches"] += 1
    EXEC_STATS["batched_jobs"] += len(idxs)
    EXEC_STATS["batched_cells"] += sum(inp["L"] * inp["R"]
                                       for inp in inputs)
    log_out("batched fan-in launch: %d jobs (%d rows, K%d/%d G%d, "
            "kernel B)" % (len(idxs), args["W"], args["loff"].shape[2],
                           KR, args["G"]), 3)
    EXEC_STATS["fill_seconds"] += time.perf_counter() - t_launch
    ilo = np.zeros(bp.shape[1], np.int32)
    paths: list = [None] * len(idxs)
    for b, i in enumerate(idxs):
        job = jobs[i]
        path, end = finish_fanin(
            inputs[b], bp[b], (snap[b, 0], snap[b, 1], snap[b, 2]), ilo,
            job.left, job.right, job.model, _job_settings(job),
            job.left_branch_length, job.right_branch_length,
            kr_decode=KR)
        paths[b] = None if path is None else (path, end)
    return paths


def _launch_fanin_batch(jobs, idxs, results, engine, device):
    """Batched fan-in Viterbi fills + per-job ancestral builds."""
    from ..align.ancestral import build_ancestral_graph
    paths = _fanin_batch_paths(jobs, idxs, device)
    for b, i in enumerate(idxs):
        job = jobs[i]
        if paths[b] is None:
            # banded dead end: full-matrix retry via the single path
            job.band = None
            results[i] = _run_single(job, engine, device)
            continue
        path, end = paths[b]
        anc = build_ancestral_graph(job.left, job.right, path, job.model,
                                    _job_settings(job),
                                    job.left_branch_length,
                                    job.right_branch_length,
                                    job.is_reads_sequence,
                                    compute_consensus=job.compute_consensus)
        results[i] = (anc, end)


# ----------------------------------------------------------------------
def _fullprob_settings(job: PairJob) -> AlignSettings:
    """A full-probability job's settings: sampling draws from forward
    probabilities, so it forces the full score
    (basic_alignment.h:621-625)."""
    from dataclasses import replace
    s = _job_settings(job)
    if (s.sample_path or s.sample_additional_paths > 0) and \
            not s.compute_full_score:
        s = replace(s, compute_full_score=True)
    return s


def _finish_fullprob_jobs(jobs, idxs, results, sjobs, inputs, fills,
                          vpaths, fanin: bool):
    """Per-job host finish of a filled full-probability bucket, in job
    order: planes, posterior figure, sampled or annotated Viterbi path,
    ancestral build, additional sampled paths. vpaths maps a job's slot
    to its (path, end) from the batched Viterbi fill."""
    from .. import align as al
    from ..align import fullprob as fp
    from ..align.ancestral import build_ancestral_graph
    from ..io import plots
    (f_planes, fcum), (b_planes, bcum) = fills
    for b, i in enumerate(idxs):
        job = jobs[i]
        s = sjobs[b]
        planes = fp.FullProbPlanes.from_arrays(
            job.left, job.right, job.model, inputs[b],
            f_planes[b], fcum[b], b_planes[b], bcum[b], fanin=fanin)
        if plots.posterior_sink_active():
            plots.add_posterior_figure_planes(planes)
        rng = al._RNG or np.random.default_rng()
        if s.sample_path:
            path, end = fp.sample_path_planes(
                planes, s, rng, job.left_branch_length,
                job.right_branch_length)
        else:
            path, end = vpaths[b]
            fp.annotate_path(path, planes, end)
        anc = build_ancestral_graph(
            job.left, job.right, path, job.model, s,
            job.left_branch_length, job.right_branch_length,
            job.is_reads_sequence,
            compute_consensus=job.compute_consensus)
        if s.sample_additional_paths > 0:
            from ..align.sampling import merge_sampled_graph
            for _ in range(s.sample_additional_paths):
                extra = fp.sample_path_planes(
                    planes, s, rng, job.left_branch_length,
                    job.right_branch_length)[0]
                sg = build_ancestral_graph(
                    job.left, job.right, extra, job.model, s,
                    job.left_branch_length, job.right_branch_length,
                    job.is_reads_sequence)
                merge_sampled_graph(anc, sg)
        results[i] = (anc, end)


def _to_host(fills):
    """The four outputs of a bucket's two fills as numpy arrays: one
    copy per tensor, not one per job and plane."""
    return tuple((p.cpu().numpy(), c.cpu().numpy()) for p, c in fills)


def _launch_fullprob_batch(jobs, idxs, results, engine, device):
    """One kernel D and one kernel E launch fill a bucket of linear
    full-probability / sampling jobs' scaled planes, one kernel A launch
    fills the Viterbi matrices of the jobs that do not sample their
    path; the rest finishes per job on the host."""
    import time
    from ..align import fullprob as fp
    from ..align import fullprob_fill as ff
    from ..align.viterbi_linear import (linear_job_arrays, batch_rows,
                                        linear_batch_args, linear_fill,
                                        _add_scalar_params, _finish_linear)
    from ..align.viterbi_sheared import prepare_sheared

    t_launch = time.perf_counter()
    sjobs = [_fullprob_settings(jobs[i]) for i in idxs]
    inputs = [fp.linear_fullprob_inputs(jobs[i].left, jobs[i].right,
                                        jobs[i].model) for i in idxs]
    fills = _to_host(ff.linear_plane_fills(
        **ff.linear_batch_args(inputs, device)))

    # batched Viterbi fill for the jobs that follow the best path
    # (sampling jobs draw their path from the planes instead)
    vit = [b for b in range(len(idxs)) if not sjobs[b].sample_path]
    vpaths = {}
    if vit:
        vin = [_add_scalar_params(prepare_sheared(
            jobs[idxs[b]].left, jobs[idxs[b]].right, jobs[idxs[b]].model,
            sjobs[b], np.float32)) for b in vit]
        Lp = batch_rows(vin)
        codes, corner = linear_fill(**linear_batch_args(
            [linear_job_arrays(x, Lp) for x in vin], device))
        codes = codes.cpu().numpy()
        corner = corner.cpu().numpy()
        for k, b in enumerate(vit):
            job = jobs[idxs[b]]
            vpaths[b] = _finish_linear(
                codes[k], corner[k], job.left, job.right, job.model,
                vin[k]["L"], vin[k]["R"], job.left_branch_length,
                job.right_branch_length)
    EXEC_STATS["launches"] += 1
    EXEC_STATS["fp_batches"] += 1
    EXEC_STATS["batched_jobs"] += len(idxs)
    EXEC_STATS["batched_cells"] += sum(p["L"] * p["R"] for p in inputs)
    EXEC_STATS["fill_seconds"] += time.perf_counter() - t_launch
    log_out("batched full-prob launch: %d jobs (%d rows, kernels D, E%s)"
            % (len(idxs), fills[0][0].shape[3], ", A" if vit else ""), 3)
    _finish_fullprob_jobs(jobs, idxs, results, sjobs, inputs, fills,
                          vpaths, fanin=False)


def _launch_fanin_fullprob_batch(jobs, idxs, results, engine, device):
    """One kernel D and one kernel E launch (fan-in entry points) fill a
    bucket of fan-in full-probability / sampling jobs' scaled planes,
    one kernel B launch the Viterbi matrices of the jobs that do not
    sample their path."""
    import time
    from ..align import fullprob as fp
    from ..align import fullprob_fill as ff

    t_launch = time.perf_counter()
    sjobs = [_fullprob_settings(jobs[i]) for i in idxs]
    inputs = [fp.fanin_fullprob_inputs(jobs[i].left, jobs[i].right,
                                       jobs[i].model) for i in idxs]
    fwd_kw, bwd_kw = ff.fanin_batch_args(inputs, device)
    fills = _to_host(ff.fanin_plane_fills(fwd_kw, bwd_kw))
    EXEC_STATS["launches"] += 1
    EXEC_STATS["fanin_fp_batches"] += 1
    EXEC_STATS["fill_seconds"] += time.perf_counter() - t_launch
    log_out("batched fan-in full-prob launch: %d jobs (%d rows, K%d/%d "
            "G%d, kernels D, E)"
            % (len(idxs), fills[0][0].shape[3], fwd_kw["loff"].shape[2],
               fwd_kw["roff"].shape[2], fwd_kw["G"]), 3)

    # batched fan-in Viterbi fill for the jobs that follow the best
    # path. Each job counts once in batched_jobs/cells: Viterbi jobs
    # inside _fanin_batch_paths, sampling-only jobs here.
    vit = [b for b in range(len(idxs)) if not sjobs[b].sample_path]
    EXEC_STATS["batched_jobs"] += len(idxs) - len(vit)
    EXEC_STATS["batched_cells"] += sum(
        inputs[b]["L"] * inputs[b]["R"]
        for b in range(len(idxs)) if sjobs[b].sample_path)
    vpaths = {}
    if vit:
        paths = _fanin_batch_paths(jobs, [idxs[b] for b in vit], device)
        for k, b in enumerate(vit):
            if paths[k] is None:
                raise RuntimeError("fan-in fill could not reach the end "
                                   "corner")
            vpaths[b] = paths[k]
    _finish_fullprob_jobs(jobs, idxs, results, sjobs, inputs, fills,
                          vpaths, fanin=True)
