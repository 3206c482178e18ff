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

A jobs mesh (`JobsMesh`: one torch.device per shard, across processes
too) shards each batch as the reference's `NamedSharding(P("jobs"))`
does: padded to a power of two that is a multiple of the shard count
with copies of job 0, shard s filling its contiguous slice on its own
device. On a mesh of more than one shard the reference changes more than
where the work runs, and so does the port: single-job buckets batch
too, linear batches fill on the reference's scan-core rule (kernel A's
pair-end build with no break column: M's candidates compared after the
match score is added), and a giant pair of a generation that leaves
shards idle is band-sharded (align/viterbi_shardband.py, kernels G and
H).
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any

import numpy as np
import torch

from ..align.settings import AlignSettings
from ..utils import log_out

# observability: kernel-launch / job counters. fill_seconds wraps
# launch+readback wall time so the CLI's --time report can derive a
# real-run GCUPS figure; single-job fills account for themselves via
# align._acct. fanin_windowed / fanin_banded_full count anchored fan-in
# fills that ran windowed or masked at full width, banded_fills the
# windowed banded fills of thin-band linear pairs (kernel C), fp_batches
# / fanin_fp_batches the batched full-probability plane fills,
# shardband_fills the band-sharded fills of giant pairs over a mesh.
EXEC_STATS = {"launches": 0, "batched_jobs": 0, "single_jobs": 0,
              "batched_cells": 0, "fill_seconds": 0.0,
              "single_fills": 0, "fanin_batches": 0,
              "fanin_windowed": 0, "fanin_banded_full": 0,
              "banded_fills": 0, "fp_batches": 0, "fanin_fp_batches": 0,
              "shardband_fills": 0}

# band-axis sharding threshold: a pair whose left side has at least this
# many sites (and no thin anchor band) is split over the mesh's shards
# when the generation would otherwise leave them idle
SHARDBAND_MIN_L = 1 << 16


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


@dataclass
class JobsMesh:
    """The `jobs` axis of a device mesh: one torch.device per shard, in
    shard order. In a multi-process run (parallel/multihost.py) the
    list spans every rank's devices: `ranks[s]` is the rank that owns
    shard s, `rank`/`world_size` this process's place and `group` the
    torch.distributed group; only a shard's owner launches its work. A
    list may repeat a device (`[cuda:0] * 4`: logical shards on one
    card)."""
    devices: list
    ranks: list | None = None
    rank: int = 0
    world_size: int = 1
    group: Any = field(default=None, repr=False)

    def __post_init__(self):
        self.devices = [torch.device(d) for d in self.devices]
        if not self.devices:
            raise ValueError("a jobs mesh needs at least one device")
        if self.ranks is not None and len(self.ranks) != len(self.devices):
            raise ValueError("%d ranks for %d shards"
                             % (len(self.ranks), len(self.devices)))

    @property
    def size(self) -> int:
        return len(self.devices)

    def is_local(self, s: int) -> bool:
        """Whether this process launches shard s's work."""
        return self.ranks is None or self.ranks[s] == self.rank


def _mesh_size(mesh) -> int:
    return 1 if mesh is None else mesh.size


def make_jobs_mesh(n_devices: int | None = None) -> JobsMesh:
    """A jobs mesh over the first min(n_devices, device count) CUDA
    devices (all of them when n_devices is None)."""
    n = torch.cuda.device_count()
    n = min(n_devices or n, n)
    if n < 1:
        raise RuntimeError("make_jobs_mesh: no CUDA device is visible")
    return JobsMesh([torch.device("cuda", k) for k in range(n)])


def _shard_fill(mesh: JobsMesh, items: list, fill):
    """Run one batch over the mesh's `jobs` axis as the reference's
    NamedSharding(P("jobs")) splits it: `items` padded to a power of two
    that is a multiple of the shard count with copies of items[0], shard
    s filling its contiguous slice with `fill(part, device)` (a tuple of
    tensors, batch first) on its device. Every rank ends with the whole
    result: numpy arrays in job order, the padding dropped."""
    from .multihost import gather_to_host
    n = mesh.size
    B = len(items)
    pad_to = 1
    while pad_to < B:
        pad_to *= 2
    pad_to = -(-pad_to // n) * n
    padded = list(items) + [items[0]] * (pad_to - B)
    per = pad_to // n
    outs = {s: fill(padded[s * per:(s + 1) * per], mesh.devices[s])
            for s in range(n) if mesh.is_local(s)}
    # only the rows of real jobs travel to the host
    host = gather_to_host(mesh, {
        s: [t[:max(0, min(per, B - s * per))].cpu().numpy() for t in ts]
        for s, ts in outs.items()})
    return tuple(np.concatenate([host[s][k] for s in range(n)])
                 for k in range(len(host[0])))


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


def _run_shardband(job: PairJob, mesh: JobsMesh, fanin: bool):
    """Band-axis-sharded fill of one giant pair over the mesh's shards
    (align/viterbi_shardband.py: kernel G for a linear pair, kernel H
    for a fan-in pair; codes bit-identical to the one-device fill), then
    the host ancestral build. A fan-in pair past the one-hot caps or
    with a left bridge wider than the halo raises ValueError; the caller
    runs it single."""
    import time
    from ..align import _acct, _band_cells
    from ..align.ancestral import build_ancestral_graph
    from ..align import viterbi_shardband as sb
    t0 = time.perf_counter()
    settings = _job_settings(job)
    run = sb.shardband_fanin_align_path if fanin else \
        sb.shardband_align_path
    path, end = run(job.left, job.right, job.model, settings, mesh,
                    job.left_branch_length, job.right_branch_length,
                    band=job.band)
    L = job.left.num_sites() - 1
    R = job.right.num_sites() - 1
    _acct(t0, _band_cells(job.band, L, R))
    EXEC_STATS["shardband_fills"] += 1
    EXEC_STATS["launches"] += 1
    log_out("band-sharded %sfill: %dx%d over %d shards"
            % ("fan-in " if fanin else "", L, R, mesh.size), 2)
    anc = build_ancestral_graph(job.left, job.right, path, job.model,
                                settings, job.left_branch_length,
                                job.right_branch_length,
                                job.is_reads_sequence,
                                compute_consensus=job.compute_consensus)
    return anc, end


def execute_pair_jobs(jobs: list[PairJob], engine: str = "auto",
                      device="cuda", mesh: JobsMesh | None = None):
    """Run independent pairwise jobs, batching eligible ones into shared
    kernel launches (one per shape bucket) on `device`, or sharded over
    the `jobs` axis of `mesh` (a JobsMesh whose shards are devices of
    `device`'s type; single jobs run on `device`). Returns
    [(ancestral_graph, end_ptr)] in job order. Skipped jobs
    (anchoring-coverage heuristic) yield (None, None)."""
    from ..device import resolve_device
    device = resolve_device(device)
    if mesh is not None and mesh.size == 1:
        mesh = None
    if mesh is not None and any(d.type != device.type
                                for d in mesh.devices):
        raise ValueError("mesh shards on %s, device %s"
                         % ([str(d) for d in mesh.devices], device))
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

    n_shards = _mesh_size(mesh)
    # band-axis sharding: when the generation underfills the mesh and a
    # pair is giant (no thin band: those took kernel C as 'banded'),
    # split its lane axis over the shards instead of leaving them idle
    if n_shards > 1 and sum(len(v) for v in buckets.values()) + \
            sum(len(v) for v in fanin_buckets.values()) < n_shards:
        for bkt, fanin in ((buckets, False), (fanin_buckets, True)):
            for key in list(bkt):
                keep = []
                for i in bkt[key]:
                    if jobs[i].left.num_sites() - 1 < SHARDBAND_MIN_L:
                        keep.append(i)
                        continue
                    try:
                        results[i] = _run_shardband(jobs[i], mesh, fanin)
                    except ValueError:
                        if not fanin:
                            raise
                        # past the one-hot caps or a left bridge wider
                        # than the halo: the unsharded fill
                        results[i] = _run_single(jobs[i], engine, device)
                if keep:
                    bkt[key] = keep
                else:
                    del bkt[key]

    # buckets in the reference's order, jobs in job order inside each:
    # the sampled draws of a seeded run come from one RNG stream
    for bkt, launcher, cap in (
            (buckets, _launch_linear_batch, MAX_BATCH_CELLS),
            (fanin_buckets, _launch_fanin_batch, MAX_BATCH_CELLS),
            (fp_buckets, _launch_fullprob_batch, MAX_FP_BATCH_CELLS),
            (fanin_fp_buckets, _launch_fanin_fullprob_batch,
             MAX_FP_BATCH_CELLS)):
        for (Lp, Rp), idxs in sorted(bkt.items()):
            if len(idxs) == 1 and n_shards == 1:
                # no batching win; single dispatch avoids the stack copy
                i = idxs[0]
                results[i] = _run_single(jobs[i], engine, device)
                continue
            # the reference's chunking: a multiple of the shard count
            chunk = max(n_shards, (cap // (Lp * Rp) // n_shards)
                        * n_shards or n_shards)
            for c0 in range(0, len(idxs), chunk):
                launcher(jobs, idxs[c0:c0 + chunk], results, engine,
                         device, mesh)
    return results


def _fill_linear(pjobs, device, mesh, D):
    """Codes and corners (numpy) of kernel A on a batch of
    linear_job_arrays dicts: one launch on `device`, or one a shard."""
    from ..align.viterbi_linear import linear_batch_args, linear_fill

    def fill(part, dev):
        return linear_fill(**linear_batch_args(part, dev, D=D))
    if mesh is None:
        return tuple(t.cpu().numpy() for t in fill(pjobs, device))
    return _shard_fill(mesh, pjobs, fill)


def _linear_inputs(jobs, idxs, settings, scan_rule: bool):
    """kernel A's prep of the jobs idxs (settings[k] for the k-th); with
    `scan_rule` each takes the pair-end build with no break column: the
    reference's scan-core rule (batched_sheared_fill), M's candidates
    compared after the match score is added."""
    from ..align.viterbi_linear import _add_scalar_params
    from ..align.viterbi_sheared import prepare_sheared
    out = []
    for i, s in zip(idxs, settings):
        inp = prepare_sheared(jobs[i].left, jobs[i].right, jobs[i].model,
                              s, np.float32)
        if scan_rule and not inp["pair_end"]:
            inp["pair_end"], inp["jbrk"] = True, -1
        out.append(_add_scalar_params(inp))
    return out


def _launch_linear_batch(jobs, idxs, results, engine, device, mesh):
    """One kernel A launch (one a shard on a mesh) for a bucket of
    linear-chain jobs, then the per-job host backtrack and ancestral
    build. On a mesh the jobs take the reference's scan-core rule."""
    import time
    from ..align.viterbi_linear import (linear_job_arrays, batch_rows,
                                        _finish_linear)
    from ..align.ancestral import build_ancestral_graph

    t_launch = time.perf_counter()
    inputs = _linear_inputs(jobs, idxs,
                            [_job_settings(jobs[i]) for i in idxs],
                            scan_rule=mesh is not None)
    Lp = batch_rows(inputs)
    D = max(x["L"] + x["R"] for x in inputs) - 1
    pjobs = [linear_job_arrays(inp, Lp, band=jobs[i].band)
             for inp, i in zip(inputs, idxs)]
    codes, corner = _fill_linear(pjobs, device, mesh, D)
    EXEC_STATS["launches"] += 1
    EXEC_STATS["batched_jobs"] += len(idxs)
    EXEC_STATS["batched_cells"] += sum(inp["L"] * inp["R"]
                                       for inp in inputs)
    log_out("batched launch: %d jobs (%d rows, kernel A, %d shard%s)"
            % (len(idxs), Lp, _mesh_size(mesh),
               "s" if mesh is not None else ""), 3)
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


def _fanin_batch_paths(jobs, idxs, device, mesh):
    """One kernel B launch (one a shard on a mesh; full width, band
    bounds as masks) for a bucket of fan-in graph jobs. Returns
    [(path, end)] per idx; a None entry means the banded fill dead-ended
    and the caller must retry that job single
    (viterbi_alignment.cpp:298-317)."""
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
    # the batch's shapes, shared by every shard's slice
    shape = dict(W=max(x["L"] for x in inputs),
                 G=max(x["OL"] + x["OR"] for x in inputs),
                 KL=max(x["KL"] for x in inputs),
                 KR=max(x["KR"] for x in inputs),
                 D=max(x["L"] + x["R"] - 1 for x in inputs))

    def fill(part, dev):
        return fanin_fill(**fanin_batch_args(part, dev, **shape))
    if mesh is None:
        bp, snap = (t.cpu().numpy() for t in fill(inputs, device))
    else:
        bp, snap = _shard_fill(mesh, inputs, fill)
    bp = bp.view(np.uint32)
    KR = shape["KR"]
    EXEC_STATS["launches"] += 1
    EXEC_STATS["fanin_batches"] += 1
    EXEC_STATS["batched_jobs"] += len(idxs)
    EXEC_STATS["batched_cells"] += sum(inp["L"] * inp["R"]
                                       for inp in inputs)
    log_out("batched fan-in launch: %d jobs (%d rows, K%d/%d G%d, "
            "kernel B, %d shard%s)"
            % (len(idxs), shape["W"], shape["KL"], KR, shape["G"],
               _mesh_size(mesh), "s" if mesh is not None else ""), 3)
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


def _launch_fanin_batch(jobs, idxs, results, engine, device, mesh):
    """Batched fan-in Viterbi fills + per-job ancestral builds."""
    from ..align.ancestral import build_ancestral_graph
    paths = _fanin_batch_paths(jobs, idxs, device, mesh)
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


def _plane_fills(fill, inputs, device, mesh):
    """((f_planes, fcum), (b_planes, bcum)) as numpy arrays of a
    bucket's forward and backward fills, `fill(part, dev)` giving the
    four tensors: one copy per tensor, not one per job and plane."""
    if mesh is None:
        out = tuple(t.cpu().numpy() for t in fill(inputs, device))
    else:
        out = _shard_fill(mesh, inputs, fill)
    return (out[0], out[1]), (out[2], out[3])


def _launch_fullprob_batch(jobs, idxs, results, engine, device, mesh):
    """One kernel D and one kernel E launch (one each a shard on a mesh)
    fill a bucket of linear full-probability / sampling jobs' scaled
    planes, one kernel A launch fills the Viterbi matrices of the jobs
    that do not sample their path; the rest finishes per job on the
    host. The Viterbi jobs take kernel A's pair-end build with no break
    column, on one device as on a mesh: the reference fills them on its
    scan core (batched_sheared_fill) on every backend."""
    import time
    from ..align import fullprob as fp
    from ..align import fullprob_fill as ff
    from ..align.viterbi_linear import (linear_job_arrays, batch_rows,
                                        _finish_linear)

    t_launch = time.perf_counter()
    sjobs = [_fullprob_settings(jobs[i]) for i in idxs]
    inputs = [fp.linear_fullprob_inputs(jobs[i].left, jobs[i].right,
                                        jobs[i].model) for i in idxs]
    shape = dict(Lp=ff.batch_rows(inputs),
                 D=max(p["L"] + p["R"] - 1 for p in inputs))

    def planes(part, dev):
        f, b = ff.linear_plane_fills(
            **ff.linear_batch_args(part, dev, **shape))
        return f + b
    fills = _plane_fills(planes, inputs, device, mesh)

    # batched Viterbi fill for the jobs that follow the best path
    # (sampling jobs draw their path from the planes instead)
    vit = [b for b in range(len(idxs)) if not sjobs[b].sample_path]
    vpaths = {}
    if vit:
        vin = _linear_inputs(jobs, [idxs[b] for b in vit],
                             [sjobs[b] for b in vit], scan_rule=True)
        Lp = batch_rows(vin)
        codes, corner = _fill_linear(
            [linear_job_arrays(x, Lp) for x in vin], device, mesh,
            max(x["L"] + x["R"] for x in vin) - 1)
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


def _launch_fanin_fullprob_batch(jobs, idxs, results, engine, device,
                                 mesh):
    """One kernel D and one kernel E launch (fan-in entry points; one
    each a shard on a mesh) fill a bucket of fan-in full-probability /
    sampling jobs' scaled planes, one kernel B launch the Viterbi
    matrices of the jobs that do not sample their path."""
    import time
    from ..align import fullprob as fp
    from ..align import fullprob_fill as ff

    t_launch = time.perf_counter()
    sjobs = [_fullprob_settings(jobs[i]) for i in idxs]
    inputs = [fp.fanin_fullprob_inputs(jobs[i].left, jobs[i].right,
                                       jobs[i].model) for i in idxs]
    shape = dict(Lp=ff.batch_rows(inputs),
                 D=max(p["L"] + p["R"] - 1 for p in inputs),
                 G=max(p["OLm"] + p["ORm"] for p in inputs))

    def planes(part, dev):
        f, b = ff.fanin_plane_fills(*ff.fanin_batch_args(part, dev,
                                                         **shape))
        return f + b
    fills = _plane_fills(planes, inputs, device, mesh)
    EXEC_STATS["launches"] += 1
    EXEC_STATS["fanin_fp_batches"] += 1
    EXEC_STATS["fill_seconds"] += time.perf_counter() - t_launch
    log_out("batched fan-in full-prob launch: %d jobs (%d rows, K%d/%d "
            "G%d, kernels D, E)"
            % (len(idxs), fills[0][0].shape[3],
               max(p["loffp"].shape[1] for p in inputs),
               max(p["roffp"].shape[1] for p in inputs), shape["G"]), 3)

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
        paths = _fanin_batch_paths(jobs, [idxs[b] for b in vit], device,
                                   mesh)
        for k, b in enumerate(vit):
            if paths[k] is None:
                raise RuntimeError("fan-in fill could not reach the end "
                                   "corner")
            vpaths[b] = paths[k]
    _finish_fullprob_jobs(jobs, idxs, results, sjobs, inputs, fills,
                          vpaths, fanin=True)
