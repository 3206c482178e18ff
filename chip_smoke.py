#!/usr/bin/env python3
"""Quickest proof that the PyTorch/CUDA port (pagan2_tpu_torch) runs on
an NVIDIA GPU: builds the hand-written CUDA kernels from csrc/, holds
each against its plain PyTorch version on the card, and drives the
progressive-alignment main path, the long-pair paths, the
full-probability and sampling path, the read paths (--pileup,
--pair-end), query placement (-q, --ref-seqfile, --fragments,
--align-reads-at-root), the rest of the CLI (guide-tree inference,
ancestors and events, NHX, graph plots, --translate, --checkpoint-dir,
prune and trim, anchor plots, the profiler flag) and more than one device
(a jobs mesh of logical shards, two processes over gloo, band-sharded
giant pairs) end to end through the port's CLI.

    python3 chip_smoke.py            # from the root of a checkout

Phases (any failure exits non-zero; nothing is caught and passed over):
  build        nvcc for sm_90a, one process per source, started together
  kernel_linear  kernel A vs linear_fill_plain: 8 jobs at 2047 x 2047, a
               ragged banded batch and 2 jobs past 4096 rows
               (tools/bench_linear_calls.py's linear_batches) and 4 x 120;
               codes and corner scores bit-equal,
               each batch with its launch plan and us per diagonal, every
               build of the plan (1 and 2 rows a thread, tiled) met;
               the tiled build at 12,000 x 700 and 2,500 x 2,500
               (kernel_linear_tiles); then kernel A's pair-end build (the break column, M's
               candidates compared after the score is added) on
               tools/bench_linear_calls.py's pair_end_batches: breaks at
               0, 1, mid, R - 2, R - 1 and none, with and without reduced
               terminal penalties, every build forced on the same batch,
               and 2 jobs past 4096 rows; bit-equal, each build timed in
               its pair-end and its ordinary form
  kernel_fanin   kernel B vs fanin_fill_plain: 454-style K3/3 graphs at
               16 x 2047 (kernel timed), over-cap ancestor graphs, a
               windowed case; codes and snapshots bit-equal
  kernel_banded  kernel C vs banded_fill_plain on the band shapes of
               tools/bench_banded.py: a 3,500 bp pair with its narrow
               anchored band, a window of more than 128 rows, a band
               with the pair-end break scalars set, a band that
               dead-ends (no finite corner score), a window past 1024
               rows and one too wide for shared memory; codes and corner
               scores bit-equal, each with its launch plan and us per
               diagonal, every build of the plan (window, block, global
               ring) met
  kernel_fullprob  kernels D and E vs their plain versions: linear, 8
               jobs at 2047 x 2047 and a ragged batch; fan-in, 454-style
               K3/3 graphs, over-cap ancestor pairs and a deep ring
               (40-bp deletion edges); then where their launch plans
               take their other branches: a fan-in ring with no diagonal
               on chip (6,600 rows), a right-slot table too large for
               shared memory (7,500 columns of four edge slots each
               way), these plain versions four processes side by side,
               and the linear cluster build past 2,048 lanes (a
               4,300 x 400 pair and a ragged batch, each with the plan's
               build and with both cluster sizes the plan picks (8 and
               16 CTAs) forced, two and four lanes a thread), each
               placement of D and E (ring shared, hot, global; table
               shared, device; linear lane build, cluster build) seen;
               planes bit-equal, cum within D * eps * max(1, |cum|);
               the 16,569 bp pair on the cluster build, one timed call
               each way (no plain version at that size): planes scaled
               to 1, |log fwd - log bwd| within FullProbPlanes' own
               fwd/bwd agreement; posteriors of a small
               linear and a small fan-in pair against the f64 host
               oracle
  kernel_probe   kernel F (the probe's and the bisect's ablation
               variants of the linear step, on kernel A's lane builds
               and its own four-rows and global builds)
               vs its plain versions: every flag set of both entry
               points on 4 x 511 bp pairs and on random 4 x 512 rows,
               on batches whose plan takes one row a thread (3 x 127
               ragged, 2 x 96 random rows), four (2 x 2079 ragged and
               2 x 2080 random rows: the last warp partial) and the
               global build (past 4096 rows); then at the tools' sizes
               (plain timed): the probe's seven flag sets on its
               16 x 2047 batch, the bisect's six at 8 x 1024 x 2048 and
               its full variant at 32 x 256 x 2048 and 8 x 4096 x 8192;
               codes (where defined) and corner rows bit-equal, each
               batch with its launch plan and us per diagonal, every
               flag set meeting every build of the plan; the probe's
               base case equal to kernel A on the 16 x 2047 batch
  kernel_shardband  kernels G and H (the band-sharded linear and fan-in
               fills, csrc/viterbi_shardband.cu) vs their plain versions
               taking every launch of the same launch plan on the same
               CUDA tensors, on 2 and 4 logical shards of the card: a
               400 x 380 pair (halo 8, and 32 banded), 454 graphs,
               ancestors with an indel bridge left and right and a ring
               of 64 diagonals; codes, corners and rings bit-equal; then
               G at the sharding gate (65,536 x 1,024 cells on 4 shards,
               the default halo, launches as the plan says, the launch
               loop and the gather timed apart) against kernel A's
               pair-end build with no break column: every code G defines
               equal, corner bit-equal
  small_oracle the device path against the host oracle on small pairs
  main_path    16 x 1535 bp family (bench.py's generator, seed 5) through
               the CLI with default flags on CUDA: 1535 columns, kernel A
               and kernel B launched, an anchored fan-in fill ran, no
               plain version ran; then an 8 x 511 family of the same
               generator with the kernels and with the plain versions
               forced on CUDA must give byte-identical FASTA
  fullprob_path  the 16 x 1535 family through the CLI with
               --full-probability on CUDA: 1535 columns, kernels D and E
               launched on linear and on fan-in jobs, kernels A and B for
               the Viterbi fills, no plain version, posterior support of
               the root's sites in (0, 1] (1.02 with f32 rounding); then --sample-path --seed 7:
               every row intact; then the amplicon family of ROADMAP
               Queue 3 (8 x 120 bp reads, many tied paths) with
               --full-probability: the JAX CLI's bytes (sha256), kernel
               A's pair-end build launched for the batched Viterbi jobs;
               then both flags on a 4 x 511 family
               with the kernels and with the plain versions forced on
               CUDA: byte-identical FASTA, posterior support within 1e-5
  long_family  4 x 4,000 bp family (the same generator, seed 5) through
               the CLI: 2 banded fills on kernel C, an anchored fan-in
               fill on kernel B, no plain version; then a 4 x 3,100
               family with the kernels and with the plain versions
               forced: byte-identical FASTA
  pileup_path  bench.py's 454 amplicon demo (tools/reads.py's
               amplicon_reads: 40 x 384 reads, default_rng(3)) through the
               CLI with --pileup --homopolymer --output-consensus: 40
               placed, a 496-bp consensus, out.fas and out_consensus.fas
               the JAX CLI's bytes (sha256), kernel B launched on its
               group build (fan-ins past 4 x 4), no plain version; then
               the same reads with --pileup --454 (pileup454_path): out.fas
               the JAX CLI's bytes, B's group build launched; then 160
               reads of the same generator, timed by host phase
               (read_alignment_scores, _extract, ancestral build, fan-in
               prep, kernel B calls)
  pairend_path the 40 reads as pair-end FASTQ reads (a 60-120 bp insert
               cut out of each) with --pileup --pair-end, default and
               --no-anchors: the JAX CLI's bytes, each other's bytes,
               kernel B launched on preps with a break set, kernel A's
               pair-end build launched in the --no-anchors run; then 8
               of them with --full-probability: the JAX CLI's bytes;
               then 8 x 192 reads with --both-strands --build-contigs
               and as pair-end reads with --build-contigs, each with the
               kernels and with the plain versions forced on CUDA:
               byte-identical .fas and _contigs.fas
  placement_path  main_path's out.fas the JAX CLI's bytes (sha256); with
               the family's tree it is the reference alignment for
               queries of tools/reads.py's placement_queries (of its 34:
               8 new members, 24 reads of 150-400 bp, 8 of them
               reverse-complemented, 2 random 300-bp sequences) through
               the CLI on CUDA: (a) --ref-seqfile --ref-treefile
               --both-strands --output-discarded-queries with the first
               4 members and the 2 random ones (a cut: all 34 take the JAX
               CLI over 30 minutes and the card 254-315 s a run;
               tools/bench_placement.py runs them), (b) the same with
               --fragments, (c) -s -t -q with the 8 members, (d)
               --ref-seqfile -q with the 24 reads --align-reads-at-root;
               each run's files the JAX CLI's bytes (sha256), the random
               sequences discarded, kernel B and kernel A or C launched,
               no plain version; run (a) timed by host phase; then (a)
               and (b) on the 4 x 511 family's alignment with 1 read,
               with the kernels and with the plain versions forced on
               CUDA: byte-identical .fas and .discarded
  cli_rest_path  the rest of the CLI on CUDA, each run's files the JAX
               CLI's bytes (sha256), kernels A and B launched (C in (e)),
               no plain version: (a) the 16 x 1535 family with no -t
               (the guide tree inferred) and --output-ancestors --events
               --output-nhx-tree --xml-nhx --mpost-graph-file; (b)
               --translate on a 16 x 1536 coding family of the same
               generator (.fas and .codon.fas); (c) --checkpoint-dir: a
               full run, then one with the root's and a first pair's
               node files deleted, both main_path's bytes, then another
               --indel-rate against the directory, refused; (d) -s -t -q
               with placement_path's 8 members and
               --prune-extended-alignment --prune-keep-number 4, and
               -s -t -q with 3 of its reads and --trim-extended-alignment
               (687 of 1,535 columns kept); (e)
               --plot-anchors-for-R on the 4 x 4,000 long family (its .r
               files); (f) --jax-profile on run (a)'s inputs: the trace
               names kernels A and B
  mesh_path    the CLI with its make_mesh handing it 4 logical shards of
               the card (the mesh --threads 4 makes on four cards): the
               16 x 1535 family with default flags and with
               --full-probability, and the amplicon family, each .fas the
               JAX CLI's --threads 4 bytes (sha256; on the amplicon
               family not its one-device bytes), kernels A (its pair-end
               build), B, D and E launched, no plain version
  multiprocess_path  two port CLI processes joined over gloo
               (--jax-coordinator 127.0.0.1:<port> --jax-num-processes 2
               --jax-process-id 0|1, one shard a rank on the card), on the
               amplicon family: both ranks write the JAX CLI's --threads 2
               bytes; then --threads 8 in this process (one card: no
               mesh) on it and on the 16 x 1535 family writes the
               one-device bytes
  shardband_path  giant pairs alone in their generation on 4 logical
               shards through the CLI (--no-anchors): kernel_shardband's
               gate pair (65,535 bp against a 1,023 bp read of it) on
               kernel G, every row intact; a 454 pair of 8,191 and 1,023
               bp (--454, the gate lowered to its 8,192 rows) on kernel
               H, its FASTA equal to the same run with the gate raised
               (batched over the mesh on kernel B)
  mito_path    a 16,569 bp pair (a sequence and a copy with 10% of its
               sites redrawn, tools/bench_linear_calls.py's giant_pairs)
               through the CLI with --no-anchors on one card: one launch
               of kernel A's tiled build, every row intact, its FASTA
               equal to the same run with the plain versions forced; the
               host phases timed (prep, fill, the codes' copy to the
               host, backtrack, ancestral build, write)
  fullprob_long_path  a 5,000 bp pair and a copy with 10% of its
               sites redrawn and 1% indels (tools/bench_fullprob.py's
               redrawn_pair) through the CLI with --full-probability
               and with --sample-path --seed 7: the JAX CLI's bytes
               (sha256, one for each mode), the linear fills on kernels
               D's and E's cluster build, no plain version (the timing
               phase holds the recorded linear call's planes against it)
  megabase     bench.py's megabase pair (1,048,575 bp, 1% substitutions,
               np.random.default_rng(0)) through the CLI with default
               flags: both rows intact, 1 banded fill on kernel C, no
               plain version; the host phase times
  tools        the port's measuring tools at full size, counts set to 0
               just before: probe_linear (10 cases), bisect_linear (9
               runs), sweep_linear (7 rows of kernel A) and bench_linear;
               every flag set of kernel F and kernel A launched, no plain
               version
  timing       each kernel and its plain version on every call its path
               gave it: bit-equal, ms per launch (CUDA events) and the
               lower bound; the plain versions of the held calls run
               first, four processes side by side, then the kernels
               alone (kernel C: bit-equal on the long_family calls;
               kernel, plain version and bound on the megabase call cut
               to its first 16,384 diagonals; kernel A's tiled build on
               mito_path's call, bit-equal, with its plain time and
               bound; the kernel and its bound
               on the whole megabase call; kernels D and E per entry
               point on the calls of the --full-probability run, planes
               bit-equal (the fan-in calls timed on every call, held on
               the first of each launch plan and (D, Lp)), kernel E with
               its launch plans and us per diagonal; D's and E's cluster
               build on fullprob_long_path's call (kernel_fullprob timed
               it against its plain version on the 4,300 x 400 call);
               kernels A and B on
               every call of the main path
               and of the --full-probability run, with their launch
               plans and us per diagonal, A held bit-equal on every
               call, B on the first call of each build; kernel A's ordinary
               build on the main path's call beside its 1.614 ms from
               before the pair-end build existed; kernels A, B and C on
               every call of placement_path's run (a), the first call of
               each build not held above bit-equal to the plain version,
               with its plain time and bound; kernel B's group build on
               every call of pileup_path and of pileup454_path, the first
               pileup_path call and its call of the largest K x G held
               bit-equal, with plan, plain time, bound, us per diagonal;
               kernels G and H on one launch of a fill of their
               shardband_path pairs, a shard past the first in mid-fill,
               on its tile range, bit-equal to the plain version, with
               the plan and the bound)
  trace        the main path, the --full-probability path and the pileup
               path once more under torch.profiler: the device's busy
               share, time by kernel, kernel B's device time

Prints a {"kernels": [...]} line, the nvidia-smi name/power-limit line,
and last {"ok": true, "device": {...}}.
"""
import hashlib
import json
import os
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
T0 = time.time()

# published H100 SXM peaks (NVIDIA data sheet): device memory rate and
# f32 rate outside the tensor cores
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12
# f32 compare/add/select operations per cell (counted from the sources:
# kernel A 10 adds, 6 maxima, 6 code compares, 3 masks; kernel B per
# candidate 1-2 adds and a compare/select, per cell the masks)
LINEAR_OPS_PER_CELL = 25
# f32 multiply/add/maximum operations per cell of kernels D and E
# (counted from the sources). Linear: 9 multiplies and 4 adds for X and
# Y, 7 multiplies and 2 adds for M, 3 scalings, 3 maxima (E: the same
# count with q in place of the rescaled d-2 state). Fan-in: 10 per cell
# (scalings, maxima, masks, the match product), 8 per edge slot, 12 per
# slot pair.
FULLPROB_OPS_PER_CELL = 28
FANIN_FP_OPS = (10, 8, 12)
# posteriors are f32 planes against the f64 host oracle
POSTERIOR_TOL = 1e-4
# upper limit of a site's posterior support on a 1535-site pair in f32
SUPPORT_MAX = 1.02


def fail(msg):
    print("chip_smoke: FAIL: %s" % msg, file=sys.stderr)
    sys.exit(1)


def log(msg):
    """One line of the log, with the seconds since the script started."""
    print("chip_smoke: [%7.1f s] %s" % (time.time() - T0, msg), flush=True)


def mutate(rng, base, p=0.1):
    mut = base.copy()
    idx = rng.random(len(base)) < p
    mut[idx] = rng.choice(list("ACGT"), size=int(idx.sum()))
    return "".join(mut)


def write_input(work, name, seqs, tree):
    """FASTA and Newick files of one CLI input; returns their paths."""
    fas = os.path.join(work, name + ".fas")
    with open(fas, "w") as f:
        for n, s in seqs:
            f.write(">%s\n%s\n" % (n, s))
    nh = os.path.join(work, name + ".nh")
    with open(nh, "w") as f:
        f.write(tree + "\n")
    return fas, nh


def read_fasta(path):
    rows = open(path).read().split(">")[1:]
    return [(r.splitlines()[0], "".join(r.splitlines()[1:])) for r in rows]


def same_floats(a, b):
    """Bit-equality of two f32 tensors (-inf included)."""
    import torch
    return torch.equal(a.contiguous().view(torch.int32),
                       b.contiguous().view(torch.int32))


def max_abs_err(a, b):
    import torch
    fin = torch.isfinite(a) & torch.isfinite(b)
    if not torch.equal(torch.isfinite(a), torch.isfinite(b)):
        return float("inf")
    if not bool(fin.any()):
        return 0.0
    return float((a[fin] - b[fin]).abs().max())


def fanin_launch(kw):
    """Kernel B's launch plan for one call's arguments, as text."""
    from pagan2_tpu_torch.align import viterbi_fanin as VF
    KL, KR = kw["loff"].shape[2], kw["roff"].shape[2]
    p = VF.call_plan(kw)
    return ("K %d/%d (%s), ring %s (%d of %d diagonals on chip), %d "
            "threads x %d rows" % (
                KL, KR, "templated" if p["KL"] else
                "group build, %d lanes a group, tables %s"
                % (p["group"], p["tables"]), p["placement"], p["hot"],
                kw["G"] + 1, p["threads"], p["rows"]))


def ptxas_kernels(report):
    """(kernel, registers, spill-store bytes) of each kernel of kernel
    F's nvcc -Xptxas -v report; a template's flag set and rows a thread
    read from its mangled name (global: the global build)."""
    import re
    out, name, spill = [], None, 0
    for line in report.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", line)
        if m:
            name, spill = m.group(1), 0
            continue
        m = re.search(r"(\d+) bytes spill stores", line)
        if m:
            spill = int(m.group(1))
        m = re.search(r"Used (\d+) registers", line)
        if m and name:
            args = [int(a) for a in re.findall(r"Li(\d+)E", name)]
            what = ("lanes flags %d rows %d" % tuple(args[:2])
                    if "lanes" in name and len(args) >= 2 else
                    "global flags %d" % args[0] if args else name)
            out.append((what, int(m.group(1)), spill))
            name = None
    return sorted(out)


def cuda_ms(fn, reps):
    """Milliseconds per call of fn on the current stream (CUDA events,
    after one warm-up call)."""
    import torch
    fn()
    torch.cuda.synchronize()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    for _ in range(reps):
        fn()
    t1.record()
    torch.cuda.synchronize()
    return t0.elapsed_time(t1) / reps


def plain_call(module, name, path):
    """In a process of hold_plain's pool: the plain version `name` of
    `module` on the call saved at path, run on the card and timed with
    CUDA events; its outputs are saved to path + ".out". Returns the
    ms."""
    import importlib
    import torch
    fn = getattr(importlib.import_module(module), name)
    kw = {k: v.cuda() if isinstance(v, torch.Tensor) else v
          for k, v in torch.load(path, weights_only=False).items()}
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    t0.record()
    out = fn(**kw)
    t1.record()
    torch.cuda.synchronize()
    torch.save([t.cpu() for t in out], path + ".out")
    return t0.elapsed_time(t1)


# The plain versions that hold the kernels run side by side, each in a
# process of its own on the card (hold_plain): they are bound by the
# host's Python (the card waits on each small launch), so HOLD_WORKERS
# of them run nearly as fast together as one alone. Each call's plain ms
# is its own process's, taken while the others ran. No kernel is timed
# while they run.
HOLD_WORKERS = 4


def hold_plain(jobs, folder=os.path.join(HERE, "build", "chip_smoke",
                                         "holds"), workers=HOLD_WORKERS):
    """{(plain version's name, id(call)): (the file of its outputs, its
    ms)} for jobs [(plain version, call)]: each call saved under folder
    and run by plain_call in a pool of `workers` spawned processes on
    the card, all of them ended on return."""
    import multiprocessing
    import torch
    os.makedirs(folder, exist_ok=True)
    paths = []
    for n, (_fn, kw) in enumerate(jobs):
        paths.append(os.path.join(folder, "call%d.pt" % n))
        torch.save({k: v.cpu() if isinstance(v, torch.Tensor) else v
                    for k, v in kw.items()}, paths[-1])
    pool = multiprocessing.get_context("spawn").Pool(workers)
    try:
        ms = pool.starmap(plain_call, [(fn.__module__, fn.__name__, path)
                                       for (fn, _kw), path
                                       in zip(jobs, paths)], 1)
        pool.close()
    finally:
        pool.terminate()
        pool.join()
    for path in paths:
        os.remove(path)
    return {(fn.__name__, id(kw)): (path + ".out", m)
            for (fn, kw), path, m in zip(jobs, paths, ms)}


def main():
    if not os.path.isdir(os.path.join(HERE, "pagan2_tpu_torch")):
        fail("pagan2_tpu_torch/ is not beside chip_smoke.py: run it from "
             "the root of a checkout")
    sys.path.insert(0, HERE)
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False")
    dev = torch.device("cuda:0")
    torch.cuda.set_device(dev)

    from pagan2_tpu_torch import kernels
    from pagan2_tpu_torch.align import viterbi_linear as VL
    from pagan2_tpu_torch.align import viterbi_fanin as VF
    from pagan2_tpu_torch.align import viterbi_banded as VB
    from pagan2_tpu_torch.align import fullprob as FP
    from pagan2_tpu_torch.align import fullprob_fill as FF
    from pagan2_tpu_torch.align import viterbi_shardband as SB
    from pagan2_tpu_torch.align import AlignSettings, align_pair, plan_band
    from pagan2_tpu_torch.align.viterbi_sheared import prepare_sheared
    from pagan2_tpu_torch.graph import build_leaf_graph
    from pagan2_tpu_torch.models import ModelFactory, alphabets as alph
    from pagan2_tpu_torch.parallel import executor as EX
    from pagan2_tpu_torch.parallel.executor import JobsMesh
    from pagan2_tpu_torch.tools.bench_fanin import family
    from pagan2_tpu_torch.tools.bench_banded import (band_shapes, megabase,
                                                     shape_args)
    from pagan2_tpu_torch.tools.bench_banded import \
        plan_text as banded_plan_text
    from pagan2_tpu_torch.tools.bench_fullprob import (fanin_plan_text,
                                                       plan_text)
    from pagan2_tpu_torch.tools.bench_linear_calls import (
        batch_args as linear_batch_args, call_pair_end, giant_pairs,
        lane_plans, linear_batches, pair_end_batches,
        plan_text as linear_plan_text)

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    log("card: %s; torch %s, CUDA %s" % (smi, torch.__version__,
                                          torch.version.cuda))

    # ---- build ----
    t_start = time.time()
    t0 = time.time()
    kernels.build("viterbi_linear", "viterbi_fanin", "viterbi_banded",
                  "fullprob_fwd", "fullprob_bwd", "viterbi_linear_probe",
                  "viterbi_shardband")
    log("build: %.1f s (%s)" % (time.time() - t0, ", ".join(
        "%s %.1f s" % kv for kv in sorted(kernels.BUILD_SECONDS.items(),
                                          key=lambda kv: -kv[1]))))
    import re
    for name, out in kernels.BUILD_LOG.items():
        if name == "viterbi_linear_probe":
            continue
        entry = ""
        for line in out.splitlines():
            # kernels D's and E's linear builds by <ROWS, cluster>
            m = re.search(r"linear_kernelILi(\d+)ELb(\d)E", line)
            if "Compiling entry function" in line:
                entry = ("linear<%s, %s> " % (m.group(1), "cluster" if
                                              m.group(2) == "1" else "block")
                         if m else "")
            if "registers" in line or "spill" in line or "smem" in line:
                log("ptxas %s: %s%s" % (name, entry, line.strip()))
    for fn, regs, spill in ptxas_kernels(
            kernels.BUILD_LOG.get("viterbi_linear_probe", "")):
        log("ptxas viterbi_linear_probe %s: %d registers, %d bytes spill "
            "stores" % (fn, regs, spill))

    model = ModelFactory(alph.DNA).alignment_model(0.2)
    settings = AlignSettings()
    rng = np.random.default_rng(11)

    # ---- kernel_linear ----
    def linear_bound(kw):
        """Kernel A: per needed cell its folded score read (4 B) and its
        code written (1 B); per job its L rows of the five per-row
        vectors, fscal, iscal and the corner."""
        h = {k: t.cpu().numpy().astype(np.int64) for k, t in kw.items()
             if k in ("vlox", "vloy", "vhi", "iscal")}
        lo = np.minimum(h["vlox"], h["vloy"])    # rows >= L: 2**30
        cells = float(np.clip(h["vhi"] - lo + 1, 0, None).sum())
        nbytes = (5 * cells + 5 * 4 * float(h["iscal"][:, 0].sum())
                  + len(h["iscal"]) * (2 * 8 * 4 + 3 * 4))
        return nbytes, LINEAR_OPS_PER_CELL * cells

    def build_of(plan):
        """A plan's build of kernel A: rows a thread of a lane build, or
        "tiles"."""
        return plan["rows"] if plan["diagonals"] == "registers" else \
            plan["diagonals"]
    every_a = {r for r, _top in VL.LANES} | {"tiles"}
    lin_builds = set()

    def linear_check(inps, bands, what):
        args = linear_batch_args(VL, inps, bands, dev)
        codes, corner = VL.linear_fill(**args)
        pc, pk = VL.linear_fill_plain(**args)
        torch.cuda.synchronize()
        if not torch.equal(codes, pc):
            n = int((codes != pc).sum())
            fail("kernel_linear %s: %d codes differ from the plain "
                 "version" % (what, n))
        if not same_floats(corner, pk):
            fail("kernel_linear %s: corner scores differ: %s vs %s"
                 % (what, corner.tolist(), pk.tolist()))
        if not bool(torch.isfinite(corner).any(dim=1).all()):
            fail("kernel_linear %s: a job never reached its corner" % what)
        B, D, Lp = args["ms"].shape
        plan = VL.linear_plan(Lp, args["pair_end"])
        lin_builds.add(build_of(plan))
        ms = cuda_ms(lambda: VL.linear_fill(**args), 3)
        tiles = ""
        if plan["diagonals"] == "tiles":
            tp = VL.tile_plan(args["iscal"][:, :2].tolist(), Lp, D,
                              plan["threads"])
            tiles = " (%d tiles, %d live)" % (len(tp),
                                              sum(t["live"] for t in tp))
        log("kernel_linear %s: %d jobs, Lp %d, D %d: bit-equal; %s%s, "
            "%.3f ms, %.3f us per diagonal"
            % (what, B, Lp, D, linear_plan_text(VL, Lp, args["pair_end"]),
               tiles, ms,
               1e3 * ms / D))
        return max_abs_err(corner, pk), ms

    lin_err = 0.0
    # 8 x 2047, a ragged banded batch and 2 jobs past 4096 rows (the
    # tiled build), drawn from rng as before
    for what, inps, bands in linear_batches(rng, model, settings):
        lin_err = max(lin_err, linear_check(inps, bands, what)[0])
    # one row a thread (4 x 120), from a generator of its own (2 x 3,000
    # against 700, there for four rows a thread, went with that build)
    rng_l = np.random.default_rng(13)
    for what, shape in (("4x120", [(120, 120)] * 4),):
        inps = []
        for n, m in shape:
            base = rng_l.choice(list("ACGT"), size=n)
            inps.append(VL._add_scalar_params(prepare_sheared(
                build_leaf_graph("".join(base), alph.DNA),
                build_leaf_graph(mutate(rng_l, base[:m]), alph.DNA), model,
                settings, np.float32)))
        lin_err = max(lin_err, linear_check(inps, [None] * len(inps),
                                            what)[0])
    if lin_builds != every_a:
        fail("kernel_linear: the batches met the builds %s of kernel A, "
             "not every one" % sorted(map(str, lin_builds)))
    log("kernel_linear: every build of kernel A met (%s)"
        % sorted(map(str, lin_builds)))

    # ---- kernel_linear_tiles: the tiled build at its users' sizes ----
    # a 12,000 bp sequence against a 700 bp stretch of it (a read mapped
    # onto a region: 24 tiles of 512 rows, the read's 701 columns) and a
    # square 2,500 x 2,500 pair (5 tiles, all in flight together), each
    # against the plain version (8-18 and 4-8 s of plain loop on the card;
    # mito_path holds a 16,570 x 16,570 call)
    tiles_err, tiles_ms = 0.0, {}
    rng_t = np.random.default_rng(12000)
    for what, (n, m0, m) in (("12000x700", (12000, 5000, 700)),
                             ("2500x2500", (2500, 0, 2500))):
        base = rng_t.choice(list("ACGT"), size=n)
        inp = VL._add_scalar_params(prepare_sheared(
            build_leaf_graph("".join(base), alph.DNA),
            build_leaf_graph(mutate(rng_t, base[m0:m0 + m]), alph.DNA),
            model, settings, np.float32))
        err, tiles_ms[what] = linear_check([inp], [None], what)
        tiles_err = max(tiles_err, err)
    log("kernel_linear_tiles: the tiled build bit-equal to its plain "
        "version at 12000 x 700 and 2500 x 2500")

    # pair-end batches (tools/bench_linear_calls.py's pair_end_batches,
    # their own generator): break columns 0, 1, mid, R - 2, R - 1 and
    # none, with and without reduced terminal penalties, each build of
    # the plan forced on the same batch; 2 jobs past 4096 rows on the
    # plan's tiled build. Each build is timed in its pair-end form and
    # in its ordinary form on the same inputs.
    pe_builds = set()
    pe_us = {}
    for what, inps in pair_end_batches(model):
        args = linear_batch_args(VL, inps, [None] * len(inps), dev)
        if not args["pair_end"]:
            fail("kernel_linear %s: not a pair-end batch" % what)
        pc, pk = VL.linear_fill_plain(**args)
        B, D, Lp = args["ms"].shape
        for k, (text, plan) in enumerate(lane_plans(VL, Lp,
                                                    pair_end=True)):
            codes, corner = VL._launch_linear(plan, **args)
            torch.cuda.synchronize()
            if not torch.equal(codes, pc) or not same_floats(corner, pk):
                fail("kernel_linear %s: the pair-end build %s differs from "
                     "the plain version (%d codes)"
                     % (what, text, int((codes != pc).sum())))
            if not bool(torch.isfinite(corner).any(dim=1).all()):
                fail("kernel_linear %s: a job never reached its corner"
                     % what)
            lin_err = max(lin_err, max_abs_err(corner, pk))
            pe_builds.add(build_of(plan))
            ms_pe = cuda_ms(lambda: VL._launch_linear(plan, **args), 3)
            ms_or = cuda_ms(lambda: VL._launch_linear(
                plan, **dict(args, pair_end=False)), 3)
            pe_us.setdefault(text, []).append(
                (1e3 * ms_pe / D, 1e3 * ms_or / D))
            log("kernel_linear %s: %d jobs, Lp %d, D %d, %s%s: bit-equal; "
                "pair-end build %.3f ms (%.3f us per diagonal), ordinary "
                "build on the same inputs %.3f ms (%.3f us)"
                % (what, B, Lp, D, text, " (plan)" if k == 0 else "",
                   ms_pe, 1e3 * ms_pe / D, ms_or, 1e3 * ms_or / D))
    if pe_builds != every_a:
        fail("kernel_linear: the pair-end batches met the builds %s"
             % sorted(map(str, pe_builds)))

    # ---- kernel_fanin ----
    def fanin_check(inps, what, timed=False, **kw):
        args = VF.fanin_batch_args(inps, dev, **kw)
        bp, snap = VF.fanin_fill(**args)
        pb, ps = VF.fanin_fill_plain(**args)
        torch.cuda.synchronize()
        if not torch.equal(bp, pb):
            fail("kernel_fanin %s: %d codes differ from the plain version"
                 % (what, int((bp != pb).sum())))
        if not same_floats(snap, ps):
            fail("kernel_fanin %s: corner snapshots differ" % what)
        if not bool(torch.isfinite(snap[:, 0, 0]).any()):
            fail("kernel_fanin %s: no finite corner score" % what)
        log("kernel_fanin %s: %d jobs, W %d, G %d, K %d/%d, D %d: "
            "bit-equal" % (what, len(inps), args["W"], args["G"],
                           args["loff"].shape[2], args["roff"].shape[2],
                           args["ilo"].shape[1]))
        if timed:
            D = args["ilo"].shape[1]
            fan_454_ms[0] = cuda_ms(lambda: VF.fanin_fill(**args), 3)
            log("kernel_fanin %s: kernel %.3f ms (%.3f us per diagonal); "
                "%s" % (what, fan_454_ms[0], 1e3 * fan_454_ms[0] / D,
                        fanin_launch(args)))
        return max_abs_err(snap, ps)

    fan_err = 0.0
    fan_454_ms = [None]
    inps = []
    for _ in range(16):
        base = rng.choice(list("ACGT"), size=2047)
        base[2047 // 3:2047 // 3 + 6] = "A"
        base[2 * 2047 // 3:2 * 2047 // 3 + 5] = "T"
        g1 = build_leaf_graph("".join(base), alph.DNA, mode454=True)
        g2 = build_leaf_graph(mutate(rng, base), alph.DNA, mode454=True)
        inps.append(VF.prepare_fanin(g1, g2, model, settings, np.float32))
    fan_err = max(fan_err, fanin_check(inps, "454 16x2047", timed=True))

    # over-cap ancestors: built on the card from leaves with a 12-bp
    # deletion (skip offset 13, past the JAX Pallas kernel's caps)
    seqs, _ = family(6, 600, seed=7)
    leaves = [build_leaf_graph(s, alph.DNA) for _, s in seqs]
    ancs = [align_pair(leaves[k], leaves[k + 1], model, settings,
                       device=dev)[0] for k in (0, 2, 4)]
    inps = [VF.prepare_fanin(ancs[a], ancs[b], model, settings,
                             np.float32) for a, b in ((0, 1), (1, 2))]
    if not any(VF.scan_core_bound(x["KL"], x["OL"], x["KR"], x["OR"])
               for x in inps):
        fail("kernel_fanin: the ancestor pairs are not past the caps")
    fan_err = max(fan_err, fanin_check(inps, "over-cap ancestors"))
    from pagan2_tpu_torch.align.viterbi_banded import band_windows
    x = inps[0]
    band, skipped = plan_band(ancs[0], ancs[1], settings)
    ilo_r, Wreal = band_windows(band[0], band[1], x["L"], x["R"])
    D = x["L"] + x["R"] - 1
    ilo = np.zeros(D, np.int32)
    ilo[:len(ilo_r)] = ilo_r
    ilo[len(ilo_r):] = ilo_r[-1]
    x["band_upper"] = np.clip(band[0][:x["L"]], 0, x["R"] - 1)
    x["band_lower"] = np.clip(band[1][:x["L"]], 0, x["R"] - 1)
    fan_err = max(fan_err, fanin_check([x], "windowed", W=int(Wreal),
                                       ilo=ilo))

    # ---- kernel_banded ----
    # chip_smoke's band shapes (tools/bench_banded.py): every build of
    # kernel C's launch plan is met on one of them
    def banded_check(shape):
        args, meta = shape_args(shape, model, dev)
        codes, corner = VB.banded_fill(**args)
        pc, pk = VB.banded_fill_plain(**args)
        torch.cuda.synchronize()
        what = shape["name"]
        if not torch.equal(codes, pc):
            fail("kernel_banded %s: %d codes differ from the plain version"
                 % (what, int((codes != pc).sum())))
        if not same_floats(corner, pk):
            fail("kernel_banded %s: corner scores differ: %s vs %s"
                 % (what, corner.tolist(), pk.tolist()))
        if bool(torch.isfinite(corner).any()) == shape["dead_end"]:
            fail("kernel_banded %s: corner %s" % (what, corner.tolist()))
        Dn, Wk = args["ms"].shape
        k_ms = cuda_ms(lambda: VB.banded_fill(**args), 3)
        log("kernel_banded %s: L %d, R %d, w.max() %d, Wk %d, D-1 %d, "
            "plan %s: bit-equal, corner %s; kernel %.3f ms (%.3f us per "
            "diagonal)" % (what, meta["inp"]["L"], meta["inp"]["R"],
                           meta["w"].max(), Wk, Dn,
                           banded_plan_text(VB, args), corner.tolist(),
                           k_ms, 1e3 * k_ms / Dn))
        return max_abs_err(corner, pk), meta, args, VB.banded_plan(Wk)

    ban_err = 0.0
    ban_builds = {}
    # the shapes draw from rng as this phase always has, so the later
    # phases keep their inputs: kernel_fullprob's oracle pairs come
    # from the same rng, and other draws here hand it other pairs, some
    # of which the reference's own totals fail its 1e-3 on (one such
    # pair: TOTALS_PART_PAIR in tests/test_torch_fullprob.py)
    for shape in band_shapes(rng=rng):
        e, meta, args, plan = banded_check(shape)
        ban_err = max(ban_err, e)
        ban_builds.setdefault(plan["build"], []).append(shape["name"])
        if shape["name"] == "10% subs" and meta["w"].max() <= 128:
            fail("kernel_banded: the 10%% pair's window is %d rows"
                 % meta["w"].max())
        if shape["pair_end"] and int(args["iscal"][3]) < 0:
            fail("kernel_banded: the pair-end break scalar ybrk is not set")
        if shape["name"] == "global ring" and plan["build"] != "global":
            fail("kernel_banded: the wide case did not take the global ring")
    if set(ban_builds) != set(VB.BUILDS):
        fail("kernel_banded: builds %s met, not all of %s"
             % (sorted(ban_builds), VB.BUILDS))
    log("kernel_banded: every build met and bit-equal: %s"
        % json.dumps(ban_builds))

    # ---- kernel_fullprob ----
    EPS32 = 1.1920929e-07

    def same_fills(out, ref):
        """Planes bit-equal, cum within D * eps * max(1, max|cum|)."""
        D = ref[1].shape[1]
        tol = D * EPS32 * max(1.0, float(ref[1].abs().max()))
        return same_floats(out[0], ref[0]) and \
            float((out[1] - ref[1]).abs().max()) <= tol

    def fills_err(out, ref):
        return max(max_abs_err(out[0], ref[0]), max_abs_err(out[1], ref[1]))

    # the bound of a call: read by kernel_fullprob's 16,569 bp pair and
    # by the timing phase
    def fullprob_bound(kw):
        """Kernels D and E: per needed cell its match value read (4 B)
        and M, X, Y written (12 B); per diagonal cum (4 B); per job its
        scalars, and for the fan-in entry points the slot arrays of its
        L rows and R columns and the seed rows."""
        iscal = kw["iscal"].cpu().numpy().astype(np.int64)
        nbytes = ops = 0.0
        for b, (L, R) in enumerate(iscal):
            cells = float(L * R)
            nbytes += 16 * cells + 4 * (L + R - 1) + 8 * 4 + 2 * 4
            if "ms2" in kw:
                ops += FULLPROB_OPS_PER_CELL * cells
                continue
            lo = kw["loff" if "loff" in kw else "lfoff"][b, :L]
            ro = kw["roff" if "roff" in kw else "rfoff"][b, :R]
            kl = float((lo > 0).sum())       # edge slots in use, all rows
            kr = float((ro > 0).sum())
            c0, c1, c2 = FANIN_FP_OPS
            ops += c0 * cells + c1 * (R * kl + L * kr) + c2 * kl * kr
            nbytes += 8 * (L * lo.shape[1] + R * ro.shape[1])
            if "seed" in kw:
                nbytes += 4 * L * kw["seed"].shape[1]
        return nbytes, ops

    fp_err = {"fwd": 0.0, "bwd": 0.0}
    # kernels D's and E's placements met in kernel_fullprob: ring shared /
    # hot / global, table shared / device, linear lane build (buffers
    # shared) / cluster build
    seen = {"D": set(), "E": set()}
    # the cluster build apart: its max |err| by direction, the cluster
    # sizes forced, and the 16,569 bp pair's timed calls
    cl_err = {"fwd": 0.0, "bwd": 0.0}
    cl_sizes = {"fwd": set(), "bwd": set()}
    cl_giant = {}

    def note_plan(name, kw):
        """Kernel D's or E's plan of one call as text; notes its
        placements."""
        kernel, direction = ("D", "fwd") if name.startswith("fullprob_fwd") \
            else ("E", "bwd")
        if name.endswith("_fanin"):
            lo, ro = (kw["loff"], kw["roff"]) if kernel == "D" else \
                (kw["lfoff"], kw["rfoff"])
            p = getattr(FF, direction + "_fanin_plan")(
                lo.shape[1], kw["G"], lo.shape[2], ro.shape[2], ro.shape[1])
            seen[kernel].update(("ring " + p["placement"], "table " + (
                "shared" if p["rtab"] else "device")))
        else:
            p = getattr(FF, direction + "_linear_plan")(kw["ms2"].shape[2])
            seen[kernel].add("linear cluster build" if p["cluster"]
                             else "linear buffers shared")
        text = plan_text(FF, name, kw)
        return "; " + text if text else ""

    fp_checks = []

    def fullprob_check(what, calls):
        """calls: [(direction, wrapper, plain version, kwargs)], held by
        fullprob_checks_run."""
        fp_checks.append((what, calls))

    def fullprob_checks_run():
        """Each call of fullprob_check's against its plain version, the
        plain versions run first side by side (hold_plain)."""
        plains = hold_plain([(plain_fn, kw) for _what, calls in fp_checks
                             for _d, _fn, plain_fn, kw in calls])
        for what, calls in fp_checks:
            for direction, fn, plain_fn, kw in calls:
                fullprob_hold(what, direction, fn, kw,
                              plains[plain_fn.__name__, id(kw)][0])
        fp_checks.clear()

    def fullprob_hold(what, direction, fn, kw, path):
        out = fn(**kw)
        ref = [v.to(dev) for v in torch.load(path)]
        os.remove(path)
        torch.cuda.synchronize()
        if not same_fills(out, ref):
            fail("kernel_fullprob %s: %s differs from its plain version "
                 "(planes max |err| %g, cum max |err| %g)"
                 % (what, fn.__name__, max_abs_err(out[0], ref[0]),
                    max_abs_err(out[1], ref[1])))
        if float(out[0].max()) != 1.0 or \
                not bool(torch.isfinite(out[1]).all()):
            fail("kernel_fullprob %s: %s planes are not scaled to 1"
                 % (what, fn.__name__))
        fp_err[direction] = max(fp_err[direction], fills_err(out, ref))
        log("kernel_fullprob %s: %s B, 3, D, Lp = %s%s: planes "
            "bit-equal, cum max |err| %g%s"
            % (what, fn.__name__, tuple(out[0].shape),
               ", G %d" % kw["G"] if "G" in kw else "",
               max_abs_err(out[1], ref[1]), note_plan(fn.__name__, kw)))

    def linear_fp_calls(pairs):
        kw = FF.linear_batch_args(
            [FP.linear_fullprob_inputs(a, b, model) for a, b in pairs], dev)
        return [("fwd", FF.fullprob_fwd, FF.fullprob_fwd_plain, kw),
                ("bwd", FF.fullprob_bwd, FF.fullprob_bwd_plain, kw)]

    def fanin_fp_calls(pairs):
        fkw, bkw = FF.fanin_batch_args(
            [FP.fanin_fullprob_inputs(a, b, model) for a, b in pairs], dev)
        return [("fwd", FF.fullprob_fwd_fanin, FF.fullprob_fwd_fanin_plain,
                 fkw),
                ("bwd", FF.fullprob_bwd_fanin, FF.fullprob_bwd_fanin_plain,
                 bkw)]

    pairs = []
    for _ in range(8):
        base = rng.choice(list("ACGT"), size=2047)
        pairs.append((build_leaf_graph("".join(base), alph.DNA),
                      build_leaf_graph(mutate(rng, base), alph.DNA)))
    fullprob_check("linear 8x2047", linear_fp_calls(pairs))
    pairs = []
    for n in (300, 777, 1200, 1531):
        base = rng.choice(list("ACGT"), size=n)
        pairs.append((build_leaf_graph("".join(base), alph.DNA),
                      build_leaf_graph(mutate(rng, base)[: n - n // 17],
                                       alph.DNA)))
    fullprob_check("linear ragged", linear_fp_calls(pairs))
    pairs = []
    for _ in range(4):
        base = rng.choice(list("ACGT"), size=2047)
        base[2047 // 3:2047 // 3 + 6] = "A"
        base[2 * 2047 // 3:2 * 2047 // 3 + 5] = "T"
        pairs.append((build_leaf_graph("".join(base), alph.DNA,
                                       mode454=True),
                      build_leaf_graph(mutate(rng, base), alph.DNA,
                                       mode454=True)))
    fullprob_check("fan-in 454 4x2047", fanin_fp_calls(pairs))
    fullprob_check("fan-in over-cap ancestors",
                   fanin_fp_calls([(ancs[0], ancs[1]), (ancs[1], ancs[2])]))
    # a deep ring: ancestors whose skip edges pass a 40-bp deletion
    base = rng.choice(list("ACGT"), size=500)
    deep = []
    for k in range(4):
        s = mutate(rng, base)
        if k % 2:
            s = s[:200] + s[240:]
        deep.append(build_leaf_graph(s, alph.DNA))
    deep = [align_pair(deep[k], deep[k + 1], model, settings,
                       device=dev)[0] for k in (0, 2)]
    calls = fanin_fp_calls([(deep[0], deep[1])])
    if calls[0][3]["G"] < 42:
        fail("kernel_fullprob: the deep-ring pair has ring depth %d"
             % calls[0][3]["G"])
    fullprob_check("fan-in deep ring", calls)
    # kernels D's and E's other plan branches: a fan-in ring with no
    # diagonal on chip (no 3 diagonals of 6,600 rows fit) and a
    # right-slot table too large for shared memory: 7,500 columns with
    # four backward- and four forward-edge slots, one pair for both
    # kernels (before the cli_rest_path phase came, E took 15,000
    # columns of two homopolymer slots on a pair of its own: cut for its
    # time); then the linear cluster build (past 2,048 lanes)
    def seq(n):
        return "".join(rng.choice(list("ACGT"), size=n))
    cluster_pair = (build_leaf_graph(seq(4300), alph.DNA),
                    build_leaf_graph(seq(400), alph.DNA))
    fullprob_check("fan-in 6600 rows", fanin_fp_calls(
        [(build_leaf_graph(seq(6600), alph.DNA),
          build_leaf_graph(seq(30), alph.DNA))]))
    wide = build_leaf_graph(seq(7500), alph.DNA)
    for i in range(5, 7496, 7):
        for o in (2, 3, 4):
            wide.add_edge(i - o, i, 0.05 * o)
            wide.add_edge(i, i + o, 0.05 * o)
    fullprob_check("fan-in 7500 columns", fanin_fp_calls(
        [(build_leaf_graph(seq(40), alph.DNA), wide)]))
    fullprob_checks_run()

    def cluster_check(what, pairs, timed=False):
        """The cluster build on one batch: the plan's own through the
        wrapper, then both sizes the plan picks (FF.CLUSTER_SIZES, 8 and
        16 CTAs) forced with two and four lanes a thread, each held
        against the plain version (planes bit-equal, cum within D * eps
        * max(1, |cum|)).
        timed: the plan's build and the plain version timed there, with
        the call's bound (the kernels line's cluster entries)."""
        for direction, fn, plain_fn, kw in linear_fp_calls(pairs):
            name = fn.__name__
            Lp = kw["ms2"].shape[2]
            cell = 32 if direction == "fwd" else 16
            t0 = torch.cuda.Event(enable_timing=True)
            t1 = torch.cuda.Event(enable_timing=True)
            t0.record()
            ref = plain_fn(**kw)
            t1.record()
            forced = [("plan", None)] + [
                ("%d x %d" % (C, rows), p) for C in FF.CLUSTER_SIZES
                for rows in (2, 4)
                for p in [FF.cluster_build(Lp, C, rows, cell)] if p]
            for text, p in forced:
                out = fn(**kw) if p is None else \
                    FF._launch_linear(name, p, **kw)
                torch.cuda.synchronize()
                if not same_fills(out, ref) or float(out[0].max()) != 1.0:
                    fail("kernel_fullprob %s: %s's cluster build (%s) "
                         "differs from its plain version (planes max |err| "
                         "%g, cum max |err| %g)"
                         % (what, name, text, max_abs_err(out[0], ref[0]),
                            max_abs_err(out[1], ref[1])))
                cl_err[direction] = max(cl_err[direction],
                                        fills_err(out, ref))
                if p is not None:
                    cl_sizes[direction].add(p["cluster"])
                del out
            note_plan(name, kw)
            log("kernel_fullprob %s: %s B, 3, D, Lp = %s; %s; planes "
                "bit-equal and cum within tolerance at the plan's build "
                "and at C x rows %s"
                % (what, name, (kw["ms2"].shape[0], 3) + tuple(
                    kw["ms2"].shape[1:]), plan_text(FF, name, kw),
                   ", ".join(t for t, _p in forced[1:])))
            if timed:
                k_ms = cuda_ms(lambda: fn(**kw), 3)
                nbytes, ops = fullprob_bound(kw)
                tb, to = nbytes / HBM_BYTES_PER_S, ops / F32_OPS_PER_S
                B_c, D_c, Lp_c = kw["ms2"].shape
                cl_t[direction] = dict(
                    ms=k_ms, plain_ms=t0.elapsed_time(t1),
                    bound_ms=1e3 * max(tb, to),
                    bound_by="bytes" if tb >= to else "operations",
                    timed_on="kernel_fullprob's %s call, B, D, Lp = %d, "
                             "%d, %d" % (what, B_c, D_c, Lp_c),
                    plan=plan_text(FF, name, kw),
                    us_per_diagonal=1e3 * k_ms / D_c)
                log("kernel_fullprob %s: %s kernel %.3f ms (%.4f us per "
                    "diagonal), plain %.1f ms, bound %.5f ms (%s)"
                    % (what, name, k_ms, 1e3 * k_ms / D_c,
                       cl_t[direction]["plain_ms"],
                       cl_t[direction]["bound_ms"],
                       cl_t[direction]["bound_by"]))
    cl_t = {}
    cluster_check("linear 4300 rows", [cluster_pair], timed=True)
    crng = np.random.default_rng(4097)
    cluster_check("linear ragged past 4096 lanes", [
        (build_leaf_graph("".join(crng.choice(list("ACGT"), n)), alph.DNA),
         build_leaf_graph("".join(crng.choice(list("ACGT"), m)), alph.DNA))
        for n, m in ((4500, 300), (4150, 380), (900, 420))])
    for direction in ("fwd", "bwd"):
        if cl_sizes[direction] != set(FF.CLUSTER_SIZES):
            fail("kernel_fullprob: the %s cluster build met sizes %s, not "
                 "%s" % (direction, sorted(cl_sizes[direction]),
                         list(FF.CLUSTER_SIZES)))
    want = {"ring shared", "ring hot", "ring global", "table shared",
            "table device", "linear buffers shared",
            "linear cluster build"}
    for kernel in ("D", "E"):
        if not want <= seen[kernel]:
            fail("kernel_fullprob: kernel %s's plans never chose %s"
                 % (kernel, sorted(want - seen[kernel])))
        log("kernel_fullprob: kernel %s's placements seen: %s"
            % (kernel, ", ".join(sorted(seen[kernel]))))

    # the cluster build at a mitochondrion's length: the 16,569 bp pair
    # of tools/bench_fullprob.py's giant_calls, one timed call each way
    # (no plain version at this size: its loop of 33,137 diagonals takes
    # minutes), planes scaled to 1, and the forward and backward totals
    # (FullProbPlanes' formulas, read from the corner cells on the card)
    from pagan2_tpu_torch.tools.bench_fullprob import redrawn_pair
    ga, gb = redrawn_pair(16569, 16569)
    g_inp = FP.linear_fullprob_inputs(build_leaf_graph(ga, alph.DNA),
                                      build_leaf_graph(gb, alph.DNA), model)
    gkw = FF.linear_batch_args([g_inp], dev)
    B_g, D_g, Lp_g = gkw["ms2"].shape
    Lg, Rg = g_inp["L"], g_inp["R"]
    g_out = {}
    for direction, fn in (("fwd", FF.fullprob_fwd), ("bwd", FF.fullprob_bwd)):
        ms = cuda_ms(lambda: fn(**gkw), 2)
        planes, cum = fn(**gkw)
        torch.cuda.synchronize()
        if float(planes.max()) != 1.0 or \
                not bool(torch.isfinite(cum).all()):
            fail("kernel_fullprob: the 16,569 bp pair's %s planes are not "
                 "scaled to 1" % direction)
        if direction == "fwd":
            d, i = Lg + Rg - 2, Lg - 1
            cell = [float(planes[0, k, d, i]) for k in range(3)]
            g_out["fwd"] = float(np.log(
                model.non_gap() * g_inp["w_lstop"] * g_inp["w_rstop"]
                * cell[0] + model.gap_close() * cell[1]
                + model.gap_close() * cell[2]) + float(cum[0, d]))
        else:
            g_out["bwd"] = float(np.log(float(planes[0, 0, 0, 0]))
                                 + float(cum[0, 0]))
        nbytes, ops = fullprob_bound(gkw)
        cl_giant[direction] = dict(
            ms=ms, us_per_diagonal=1e3 * ms / D_g,
            plan=plan_text(FF, fn.__name__, gkw),
            bound_ms=1e3 * max(nbytes / HBM_BYTES_PER_S,
                               ops / F32_OPS_PER_S),
            bound_whole_tensors_ms=1e3 * (4 * B_g * D_g * Lp_g * 4
                                          + 4 * B_g * D_g)
            / HBM_BYTES_PER_S)
        del planes, cum
        log("kernel_fullprob 16,569 bp pair: %s B, D, Lp = %d, %d, %d; %s: "
            "%.3f ms (%.4f us per diagonal), bound %.5f ms (cells; %.5f ms "
            "for the whole tensors), planes scaled to 1"
            % (fn.__name__, B_g, D_g, Lp_g, cl_giant[direction]["plan"], ms,
               1e3 * ms / D_g, cl_giant[direction]["bound_ms"],
               cl_giant[direction]["bound_whole_tensors_ms"]))
    # Both totals carry their f32 cum, a running sum of D logarithms of
    # thousands of nats, each addition rounded (the plain versions on
    # the CPU: 0.0041 at 5,000 bp, 0.078 at 9,000; this pair 0.78 on the
    # H100), so 1e-3 is out of reach of the arithmetic the kernels share
    # with the plain versions and the reference. The limit is the
    # package's own fwd/bwd agreement (FullProbPlanes._finish: the
    # reference's 1% window plus 4 eps sqrt(D) |log total|).
    dlog = abs(g_out["fwd"] - g_out["bwd"])
    dlog_tol = float(np.log(1.01) + 4 * EPS32 * np.sqrt(D_g)
                     * abs(g_out["fwd"]))
    cl_giant.update(log_fwd=g_out["fwd"], log_bwd=g_out["bwd"], dlog=dlog,
                    dlog_tol=dlog_tol)
    log("kernel_fullprob 16,569 bp pair: log fwd %.6f, log bwd %.6f, "
        "|log fwd - log bwd| %.3g (limit %.3g: FullProbPlanes' fwd/bwd "
        "agreement)" % (g_out["fwd"], g_out["bwd"], dlog, dlog_tol))
    if not dlog <= dlog_tol:
        fail("kernel_fullprob: the 16,569 bp pair's |log fwd - log bwd| "
             "%g passes %g" % (dlog, dlog_tol))
    del gkw
    torch.cuda.empty_cache()

    # posteriors and totals against the f64 host oracle
    from dataclasses import replace as _replace
    from pagan2_tpu_torch.align.oracle import PairAligner as _Oracle
    from pagan2_tpu_torch.align.settings import X_MAT, Y_MAT, M_MAT
    fs_settings = _replace(settings, compute_full_score=True)
    for kw in ({}, {"homopolymer": True}):
        base = rng.choice(list("ACGT"), size=60)
        g1 = build_leaf_graph("".join(base), alph.DNA, **kw)
        g2 = build_leaf_graph(mutate(rng, base)[4:], alph.DNA, **kw)
        planes = FP.FullProbPlanes(g1, g2, model, fs_settings, device=dev)
        orc = _Oracle(g1, g2, model, fs_settings)
        orc.fill()
        worst = 0.0
        for mat, arr in ((M_MAT, orc.M), (X_MAT, orc.X), (Y_MAT, orc.Y)):
            for i in range(planes.L):
                for j in range(planes.R):
                    worst = max(worst, abs(planes.posterior(mat, i, j)
                                           - arr[i][j].full_score))
        dlog = abs(planes.log_total - planes.log_total_bwd)
        if worst > POSTERIOR_TOL or dlog > 1e-3:
            fail("kernel_fullprob: %s pair against the host oracle: "
                 "posterior max |err| %g, |log fwd - log bwd| %g"
                 % ("fan-in" if planes.fanin else "linear", worst, dlog))
        log("kernel_fullprob %s pair against the f64 host oracle: "
            "posterior max |err| %.3g (tolerance %g), log total %.4f, "
            "|log fwd - log bwd| %.3g"
            % ("fan-in" if planes.fanin else "linear", worst, POSTERIOR_TOL,
               planes.log_total, dlog))

    # ---- kernel_probe: kernel F against its plain versions ----
    probe_err = {"probe": 0.0, "bisect": 0.0}
    from pagan2_tpu_torch.align import viterbi_linear_probe as VP
    from pagan2_tpu_torch.tools import common as TC
    from pagan2_tpu_torch.tools.bench_probe import plan_text as \
        probe_plan_text
    from pagan2_tpu_torch.tools.bisect_linear import bisect_inputs
    # the builds of kernel F's plan each flag set met
    probe_builds = {"%s:%s" % (t, v): set() for t, vs in (
        ("probe", VP.PROBE_VARIANTS), ("bisect", VP.BISECT_VARIANTS))
        for v in vs}

    def probe_run(tool, v, kw, plain=False):
        """One flag set of kernel F's probe or bisect entry point, or its
        plain version."""
        if tool == "probe":
            opts = () if v == "base" else tuple(v.split("+"))
            return (VP.probe_fill_plain(**kw, opts=opts) if plain
                    else VP.probe_fill(**kw, opts=opts))
        return (VP.bisect_fill_plain(**kw, variant=v) if plain
                else VP.bisect_fill(**kw, variant=v))

    def probe_check(tool, what, kw, variants):
        """Codes (where defined: not under the probe's nobp) and corner
        rows of every flag set bit-equal to the plain version's, each
        kernel launch timed; returns the plain version's ms per flag
        set."""
        plain_ms, us = {}, {}
        Dpk, B, Lp = kw["ms"].shape
        for v in variants:
            t0 = torch.cuda.Event(enable_timing=True)
            t1 = torch.cuda.Event(enable_timing=True)
            t0.record()
            ref = probe_run(tool, v, kw, plain=True)
            t1.record()
            out = probe_run(tool, v, kw)
            torch.cuda.synchronize()
            codes = tool == "bisect" or "nobp" not in v
            if codes and not torch.equal(out[0], ref[0]):
                fail("kernel_probe %s %s %s: %d codes differ from the plain "
                     "version" % (tool, what, v,
                                  int((out[0] != ref[0]).sum())))
            for o, r, row in zip(out[1:], ref[1:], "MXY"):
                if not same_floats(o, r):
                    fail("kernel_probe %s %s %s: corner row f%s differs "
                         "from the plain version" % (tool, what, v, row))
                probe_err[tool] = max(probe_err[tool], max_abs_err(o, r))
            plain_ms[v] = t0.elapsed_time(t1)
            del out, ref
            us[v] = 1e3 * cuda_ms(lambda: probe_run(tool, v, kw), 3) / Dpk
            probe_builds["%s:%s" % (tool, v)].add(
                VP.probe_plan(Lp)["rows"])
        log("kernel_probe %s %s: B %d, Dpk %d, Lp %d, %s: %s bit-equal; us "
            "per diagonal %s (plain ms %s)"
            % (tool, what, B, Dpk, Lp, probe_plan_text(VP, Lp),
               ", ".join(variants), ", ".join("%.4f" % us[v]
                                              for v in variants),
               ", ".join("%.1f" % plain_ms[v] for v in variants)))
        return plain_ms

    def bisect_kw(*shape):
        return bisect_inputs(*shape, dev)

    def probe_kw(pairs, seed):
        """probe_args of pairs of (left, right) sites: a random left side
        and, as its right side, its first sites with 10% redrawn."""
        rng_p = np.random.default_rng(seed)
        inps = []
        for n1, n2 in pairs:
            base = rng_p.choice(list("ACGT"), size=n1)
            inps.append(VL._add_scalar_params(prepare_sheared(
                build_leaf_graph("".join(base), alph.DNA),
                build_leaf_graph(mutate(rng_p, base[:n2]), alph.DNA),
                model, settings, np.float32)))
        return VP.probe_args(TC.job_arrays(inps), dev)

    inps, _c = TC.pair_jobs(4, 511)
    probe_check("probe", "4x511", VP.probe_args(TC.job_arrays(inps), dev),
                VP.PROBE_VARIANTS)
    probe_check("bisect", "4x512x1024", bisect_kw(4, 512, 1024),
                VP.BISECT_VARIANTS)
    # one row a thread (Lp 128, one job filling it, the others leaving
    # rows past L), four (Lp 2080: the last warp partial, row Lp - 1
    # live) and the global build past 4096 rows (a 4,200-site left side
    # cut to its first 512 diagonals); the bisect's at 96, 2080 and 4224
    # rows, Dpk past Lp so that the wrap from row Lp - 1 is live
    probe_check("probe", "3x127 ragged", probe_kw(
        [(127, 40), (90, 70), (60, 20)], 14), VP.PROBE_VARIANTS)
    probe_check("bisect", "2x96x256", bisect_kw(2, 96, 256),
                VP.BISECT_VARIANTS)
    probe_check("probe", "2x2079 ragged", probe_kw(
        [(2079, 30), (1500, 60)], 15), VP.PROBE_VARIANTS)
    probe_check("bisect", "2x2080x2304", bisect_kw(2, 2080, 2304),
                VP.BISECT_VARIANTS)
    kw = probe_kw([(4200, 64)], 12)
    kw["ms"] = kw["ms"][:512].contiguous()
    probe_check("probe", "4200 rows", kw, VP.PROBE_VARIANTS)
    probe_check("bisect", "1x4224x256", bisect_kw(1, 4224, 256),
                VP.BISECT_VARIANTS)
    # at the tools' sizes, every flag set each tool runs there against
    # its plain version (timed): the probe's seven on its 16 x 2047 batch
    # (its TD cases only pad to the same Dpk 4096), the bisect's six at
    # 8 x 1024 x 2048 and its full variant at 32 x 256 x 2048 and at
    # 8 x 4096 x 8192 (the top of the lane builds); then the probe's
    # base case against kernel A
    inps, _c = TC.pair_jobs(16, 2047)
    jobs16 = TC.job_arrays(inps)
    kw = VP.probe_args(jobs16, dev)
    probe_plain_ms = probe_check("probe", "16x2047", kw,
                                 VP.PROBE_VARIANTS)["base"]
    bisect_plain_ms = probe_check("bisect", "8x1024x2048",
                                  bisect_kw(8, 1024, 2048),
                                  VP.BISECT_VARIANTS)["full"]
    for shape in ((32, 256, 2048), (8, 4096, 8192)):
        probe_check("bisect", "x".join(map(str, shape)), bisect_kw(*shape),
                    ("full",))
    every = {r for r, _top in VP.PROBE_LANES} | {0}
    short = {k: sorted(every - b) for k, b in probe_builds.items()
             if b != every}
    if short:
        fail("kernel_probe: flag sets that missed builds of kernel F's "
             "plan: %s" % json.dumps(short))
    log("kernel_probe: every flag set of both entry points met every build "
        "of kernel F's plan (rows a thread %s)" % sorted(every))
    bp, fM, fX, fY = VP.probe_fill(**kw)
    codes, corner = VL.linear_fill(**VL.linear_batch_args(jobs16, dev))
    torch.cuda.synchronize()
    D = codes.shape[1]
    # the probe rolls row 0's x/m bits in from row Lp - 1; kernel A has
    # none there: every other bit compares
    a16 = codes[:, 1:].transpose(0, 1).to(torch.int16)
    p16 = bp[:D - 1].to(torch.int16)
    a16[:, :, 0] &= 0x30
    p16[:, :, 0] &= 0x30
    Lc = inps[0]["L"]
    got = torch.stack([fM[:, Lc - 1], fX[:, Lc - 1], fY[:, Lc - 1]], dim=1)
    if not torch.equal(a16, p16) or not same_floats(got, corner):
        fail("kernel_probe: the probe's base case differs from kernel A on "
             "16x2047 (%d codes)" % int((a16 != p16).sum()))
    log("kernel_probe: the probe's base case equals kernel A on 16x2047 "
        "(codes of %d diagonals, corner cells)" % (D - 1))
    del bp, fM, fX, fY, codes, a16, p16

    # ---- kernel_shardband: kernels G and H against their plain versions ----
    # Small shapes on 2 and 4 logical shards of this card (400 x 380 and
    # 300-site 454 pairs; 700 x 650 and 400 sites cost 15 s more of plain
    # versions), each fill run
    # with the kernels and again with the plain versions taking every
    # launch of the same launch plan on the same CUDA tensors (the fill's
    # `block`): codes, corners and rings bit-equal. Then G at the gate
    # (65,536 left sites, the default halo) against kernel A's pair-end
    # build with no break column on the same pair.
    sb_plain = {"linear": SB.shardband_linear_block_plain,
                "fanin": SB.shardband_fanin_block_plain}
    sb_err = {"linear": 0.0, "fanin": 0.0}

    def sb_forced(kind, fn, *a):
        """A band-sharded fill, every launch through `fn` when given."""
        out = (SB.shardband_fill if kind == "linear"
               else SB.shardband_fanin_fill)(*a, block=fn)
        torch.cuda.synchronize()
        return out

    def sb_check(kind, what, n, *a):
        t = time.time()
        k = sb_forced(kind, None, *a)
        tk = time.time() - t
        launched = SB.FILL_STATS["launches"]
        t = time.time()
        p = sb_forced(kind, sb_plain[kind], *a)
        tp = time.time() - t
        fl = [x.view(np.uint32) if x.dtype == np.float32 else x
              for x in k + p]
        if not (np.array_equal(fl[0], fl[2]) and np.array_equal(fl[1],
                                                               fl[3])):
            fail("kernel_shardband %s %s on %d shards: kernel and plain "
                 "differ" % (kind, what, n))
        sb_err[kind] = max(sb_err[kind], max_abs_err(
            torch.from_numpy(k[1]), torch.from_numpy(p[1])))
        log("kernel_shardband %s %s on %d shards: bit-equal (kernel fill "
            "%.2f s, %d launches of %d blocks x %d shards; plain %.2f s by "
            "the host clock)" % (kind, what, n, tk, launched,
                                 SB.FILL_STATS["blocks"], n, tp))

    def sb_linear_case(n, n1, n2, H, band, seed):
        base = rng_sb.choice(list("ACGT"), size=n1)
        g1 = build_leaf_graph("".join(base), alph.DNA)
        g2 = build_leaf_graph(mutate(rng_sb, base)[:n2], alph.DNA)
        L, R = g1.num_sites() - 1, g2.num_sites() - 1
        bnd = None
        if band:
            c = np.arange(L) * R // L
            bnd = (np.maximum(c - 40, 0), np.minimum(c + 40, R - 1))
        H = min(H, SB._lane_split(L, n))
        shards, meta = SB.shardband_args(g1, g2, model, settings, n,
                                         band=bnd, H=H)
        return JobsMesh([dev] * n), shards, meta

    def sb_fanin_case(n, case):
        if case == "454":
            base = rng_sb.choice(list("AACCGGTT"), size=300)
            g1 = build_leaf_graph("".join(base), alph.DNA, mode454=True)
            g2 = build_leaf_graph(mutate(rng_sb, base), alph.DNA,
                                  mode454=True)
        else:
            base = "".join(rng_sb.choice(list("ACGT"), size=300))
            cut = 40 if case == "deep_ring" else 12
            anc, _e = align_pair(build_leaf_graph(base, alph.DNA),
                                 build_leaf_graph(base[:90] + base[90 + cut:],
                                                  alph.DNA),
                                 model, settings, use_anchors=False,
                                 device=dev)
            leaf = build_leaf_graph(base, alph.DNA)
            g1, g2 = (anc, leaf) if case == "bridge_left" else (leaf, anc)
        inp = VF.prepare_fanin(g1, g2, model, settings, np.float32)
        OLm, ORm = max(inp["OL"], 1), max(inp["OR"], 1)
        G = SB._g_bucket(OLm + ORm)
        H = min(32, SB._lane_split(inp["L"], n))
        shards, meta = SB.shardband_fanin_args(inp, n, H=H)
        return JobsMesh([dev] * n), shards, meta, G, max(1, H // OLm)

    rng_sb = np.random.default_rng(15)
    for n, H, band in ((2, 8, False), (4, 32, True)):
        sb_check("linear", "400 x 380%s, H %d" % (" banded" if band else "",
                                                 H), n,
                 *sb_linear_case(n, 400, 380, H, band, 0))
    for n, case in ((2, "454"), (4, "bridge_left"), (2, "bridge_right"),
                    (4, "deep_ring")):
        mesh_, shards_, meta_, G_, T_ = sb_fanin_case(n, case)
        sb_check("fanin", "%s (G %d, %d steps a block)" % (case, G_, T_), n,
                 mesh_, shards_, meta_, G_, T_)

    # G at the gate: a 65,535 bp sequence against a 1,023 bp read of it
    # (65,536 x 1,024 cells) on 4 logical shards, against kernel A's
    # pair-end build with no break column (the reference's scan-core
    # rule); every code field G defines is A's (G masks what A leaves
    # raw), the corners bit-equal
    rng_gate = np.random.default_rng(65536)
    gate_base = rng_gate.choice(list("ACGT"), size=EX.SHARDBAND_MIN_L - 1)
    gate_read = mutate(rng_gate, gate_base[20000:21023])
    gg1 = build_leaf_graph("".join(gate_base), alph.DNA)
    gg2 = build_leaf_graph(gate_read, alph.DNA)
    gshards, gmeta = SB.shardband_args(gg1, gg2, model, settings, 4)
    SB.LAUNCHES["shardband_linear_block"] = 0
    t = time.time()
    gcodes, gcorner = SB.shardband_fill(JobsMesh([dev] * 4), gshards, gmeta)
    torch.cuda.synchronize()
    gate_g_s = time.time() - t
    gate_g_launches = SB.LAUNCHES["shardband_linear_block"]
    gate_stats = dict(SB.FILL_STATS)
    if gate_g_launches != gate_stats["launches"]:
        fail("kernel_shardband: %d launches of G, the plan's %d"
             % (gate_g_launches, gate_stats["launches"]))
    ginp = prepare_sheared(gg1, gg2, model, settings, np.float32)
    ginp["pair_end"], ginp["jbrk"] = True, -1
    VL._add_scalar_params(ginp)
    gargs = VL.linear_batch_args(
        [VL.linear_job_arrays(ginp, VL.batch_rows([ginp]))], dev)
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    acodes, acorner = VL.linear_fill(**gargs)
    t1.record()
    torch.cuda.synchronize()
    gate_a_ms = t0.elapsed_time(t1)
    # A's bound at the gate: its cells (linear_bound), and writing the
    # whole codes tensor once
    nbytes, ops = linear_bound(gargs)
    gate_a_bound = (1e3 * max(nbytes / HBM_BYTES_PER_S,
                              ops / F32_OPS_PER_S),
                    1e3 * acodes.numel() / HBM_BYTES_PER_S)
    del gargs
    Lg, Rg = gmeta["L"], gmeta["R"]
    step = 4096
    diff = 0
    for d0 in range(0, Lg + Rg - 1, step):
        g = torch.from_numpy(gcodes[d0:d0 + step, :Lg]).to(dev)
        a_ = acodes[0, d0:d0 + step, :Lg]
        for sh in (0, 2, 4):
            f = (g >> sh) & 3
            diff += int(((f != 3) & (f != ((a_ >> sh) & 3))).sum())
    if diff or not torch.equal(torch.from_numpy(gcorner).to(dev).view(
            torch.int32), acorner[0].contiguous().view(torch.int32)):
        fail("kernel_shardband: G at the gate differs from kernel A's "
             "pair-end build (%d code fields)" % diff)
    log("kernel_shardband: G at the gate (%d x %d cells, 4 shards of %d "
        "lanes, H %d): %d launches (%d tiles, %d halos passed) of %d "
        "blocks in %.2f s (host clock: launch loop %.3f s, gather of the "
        "codes %.3f s); every code field it defines equals kernel A's "
        "pair-end build (%s, %.3f ms; bound %.5f ms for its cells, %.3f "
        "ms to write its whole codes tensor), corner bit-equal"
        % (Lg, Rg, gmeta["w"], gmeta["H"], gate_g_launches,
           gate_stats["tiles"], gate_stats["passes"], gate_stats["blocks"],
           gate_g_s, gate_stats["loop_s"], gate_stats["gather_s"],
           linear_plan_text(VL, acodes.shape[2], True), gate_a_ms,
           gate_a_bound[0], gate_a_bound[1]))
    del acodes, gcodes

    # ---- small_oracle ----
    def sig(path):
        return [(p.mp.matrix, p.mp.x_ind, p.mp.y_ind, p.mp.x_edge_ind,
                 p.mp.y_edge_ind) for p in path]
    from pagan2_tpu_torch.align.oracle import PairAligner
    from pagan2_tpu_torch.align.viterbi_linear import linear_align_path
    from pagan2_tpu_torch.align.viterbi_fanin import fanin_align_path
    for kind in ("linear", "fanin"):
        for k in range(3):
            base = rng.choice(list("ACGT"), size=60 + 10 * k)
            s1, s2 = "".join(base), mutate(rng, base)[5:]
            kw = {} if kind == "linear" else {"homopolymer": True}

            def pair():
                return (build_leaf_graph(s1, alph.DNA, **kw),
                        build_leaf_graph(s2, alph.DNA, **kw))
            opath, oend = PairAligner(*pair(), model, settings).align()
            fn = linear_align_path if kind == "linear" else \
                fanin_align_path
            dpath, dend = fn(*pair(), model, settings, device=dev)
            if sig(dpath) != sig(opath) or \
                    abs(dend.score - oend.score) > 1e-3:
                fail("small_oracle: %s pair %d differs from the host "
                     "oracle" % (kind, k))
    log("small_oracle: 3 linear + 3 fan-in pairs match the host oracle")

    # ---- main_path ----
    from pagan2_tpu_torch import cli as CLI
    from pagan2_tpu_torch import align as ALIGN
    from pagan2_tpu_torch.align import anchors as ANCH
    from pagan2_tpu_torch.pipeline import progressive as PROG
    work = os.path.join(HERE, "build", "chip_smoke")
    os.makedirs(work, exist_ok=True)

    from pagan2_tpu_torch import pipeline as PIPE
    from pagan2_tpu_torch.pipeline import pileup as PILE
    from pagan2_tpu_torch.pipeline import placement as PLACE
    # each wrapper's module and name; A, B and C count in module-level
    # integers, the four entry points of D and E in dicts by name
    KERNELS = {"linear": (VL, "linear_fill"), "fanin": (VF, "fanin_fill"),
               "banded": (VB, "banded_fill"),
               "fp_fwd": (FF, "fullprob_fwd"),
               "fp_bwd": (FF, "fullprob_bwd"),
               "fp_fwd_fanin": (FF, "fullprob_fwd_fanin"),
               "fp_bwd_fanin": (FF, "fullprob_bwd_fanin"),
               "sb_linear": (SB, "shardband_linear_block"),
               "sb_fanin": (SB, "shardband_fanin_block")}
    real = {k: getattr(m, n) for k, (m, n) in KERNELS.items()}
    plain = {k: getattr(m, n + "_plain") for k, (m, n) in KERNELS.items()}

    def zero_counts():
        for m, n in KERNELS.values():
            if isinstance(m.LAUNCHES, dict):
                m.LAUNCHES[n] = m.PLAIN_CALLS[n] = 0
            else:
                m.LAUNCHES = m.PLAIN_CALLS = 0

    def read_count(m, n, which):
        c = getattr(m, which)
        return c[n] if isinstance(c, dict) else c

    def recording(rec):
        """The wrappers, each appending its calls' arguments to rec."""
        def make(k):
            def fill(**kw):
                rec[k].append(kw)
                return real[k](**kw)
            return fill
        return {k: make(k) for k in KERNELS}

    def run_cli(what, fas, nh, out, fills, extra=()):
        """One CLI run with `fills` in the wrappers' places and every
        count set to 0 just before it; returns (wall s, launches per
        kernel, plain-version calls, EXEC_STATS) read just after; the
        launches hold kernel A's tiled ones apart as "linear_tiles" too
        (counted in "linear" as well), and kernel B's group build's as
        "fanin_groups" (counted in "fanin" as well). With nh None, fas
        is the read file of a --pileup run; with both None, `extra`
        holds every input flag. Kernels D's and E's cluster launches are
        held apart as "fp_fwd_cluster" and "fp_bwd_cluster" too (counted
        in "fp_fwd" and "fp_bwd" as well)."""
        EX.reset_stats()
        zero_counts()
        VL.PAIR_END_LAUNCHES = VL.TILE_LAUNCHES = 0
        VF.GROUP_LAUNCHES = 0
        for n in FF.CLUSTER_LAUNCHES:
            FF.CLUSTER_LAUNCHES[n] = 0
        for k, (m, n) in KERNELS.items():
            setattr(m, n, fills[k])
        captured = [(PIPE, "align_progressive"), (PILE, "pileup_align"),
                    (PLACE, "place_queries")]
        saved = [getattr(m, n) for m, n in captured]

        def capture(fn):
            def run(*a, **kw):
                last_result[0] = fn(*a, **kw)
                return last_result[0]
            return run
        for (m, n), fn in zip(captured, saved):
            setattr(m, n, capture(fn))
        argv = (["-s", fas, "-t", nh] if nh else
                ["--pileup", "-q", fas] if fas else [])
        t = time.time()
        try:
            rc = CLI.main(argv + ["-o", out, "--silent", "--time"]
                          + list(extra))
            torch.cuda.synchronize()
        finally:
            for (m, n), fn in zip(captured, saved):
                setattr(m, n, fn)
            for k, (m, n) in KERNELS.items():
                setattr(m, n, real[k])
        if rc != 0:
            fail("%s: CLI returned %d" % (what, rc))
        launches = {k: read_count(m, n, "LAUNCHES")
                    for k, (m, n) in KERNELS.items()}
        launches["linear_tiles"] = VL.TILE_LAUNCHES
        launches["fanin_groups"] = VF.GROUP_LAUNCHES
        launches["fp_fwd_cluster"] = FF.CLUSTER_LAUNCHES["fullprob_fwd"]
        launches["fp_bwd_cluster"] = FF.CLUSTER_LAUNCHES["fullprob_bwd"]
        return (time.time() - t, launches,
                sum(read_count(m, n, "PLAIN_CALLS")
                    for m, n in KERNELS.values()),
                dict(EX.EXEC_STATS))

    # the ProgressiveResult (PileupResult, PlacementOutcome) of the last
    # run_cli (its root graph carries the posterior support of a
    # --full-probability run)
    last_result = [None]

    def check_rows(what, out, seqs):
        """The output's rows are the inputs with gaps added, all of one
        length; returns that length."""
        rows = read_fasta(out + ".fas")
        lens = {len(r) for _n, r in rows}
        if [n for n, _r in rows] != [n for n, _s in seqs] or \
                len(lens) != 1:
            fail("%s: %d rows of lengths %s" % (what, len(rows),
                                                sorted(lens)))
        for (n, r), (_n, s) in zip(rows, seqs):
            if r.replace("-", "") != s:
                fail("%s: row %s is not its input once gaps are removed"
                     % (what, n))
        return lens.pop()

    def same_output(what, kernel_out, seqs, fas, nh, extra=()):
        """The same input with the plain versions in the wrappers'
        places, on the same CUDA tensors, gives byte-identical output."""
        out = os.path.join(work, what + "_plain")
        wall, counts, _p, _s = run_cli(what, fas, nh, out, plain, extra)
        if any(counts.values()):
            fail("%s: kernels launched in the forced-plain run" % what)
        if open(kernel_out + ".fas", "rb").read() != \
                open(out + ".fas", "rb").read():
            fail("%s: kernel and plain FASTA differ" % what)
        log("%s: plain versions on CUDA (%.1f s) give byte-identical FASTA"
            % (what, wall))

    seqs, tree = family(16, 1535)
    fas, nh = write_input(work, "family", seqs, tree)
    recorded = {k: [] for k in KERNELS}
    out_kernel = os.path.join(work, "out_kernel")
    wall, counts, plain_calls, stats = run_cli(
        "main_path", fas, nh, out_kernel, recording(recorded))
    cols = check_rows("main_path", out_kernel, seqs)
    log("main_path: %d rows x %d cols in %.1f s; launches A=%d B=%d; "
        "stats %s" % (len(seqs), cols, wall, counts["linear"],
                      counts["fanin"], json.dumps(stats)))
    if cols != 1535:
        fail("main_path: expected 1535 columns, got %d" % cols)
    if counts["linear"] < 1 or counts["fanin"] < 1:
        fail("main_path: a kernel was never launched (%s)" % counts)
    if plain_calls:
        fail("main_path: %d plain-version calls on CUDA" % plain_calls)
    if stats["fanin_windowed"] + stats["fanin_banded_full"] < 1:
        fail("main_path: no anchored fan-in fill ran")
    a = open(out_kernel + ".fas", "rb").read()
    # the forced-plain comparisons run on an 8 x 511 family of the same
    # generator: the plain versions take over a minute at 16 x 1535
    seqs8, tree8 = family(8, 511)
    fas8, nh8 = write_input(work, "family8", seqs8, tree8)
    out8 = os.path.join(work, "main8_kernel")
    _w, c8, plain_calls, stats8 = run_cli("main8", fas8, nh8, out8, real)
    check_rows("main8", out8, seqs8)
    if c8["linear"] < 1 or c8["fanin"] < 1 or plain_calls or \
            stats8["fanin_windowed"] + stats8["fanin_banded_full"] < 1:
        fail("main8: launches %s, %d plain-version calls, stats %s"
             % (c8, plain_calls, stats8))
    same_output("main8", out8, seqs8, fas8, nh8)

    # ---- fullprob_path: --full-probability and --sample-path ----
    def support():
        """Posterior support of the root graph's real sites."""
        g = last_result[0].tree.graph
        return np.asarray(g.posterior_support[1:g.num_sites() - 1],
                          np.float64)

    FP_KEYS = ("fp_fwd", "fp_bwd", "fp_fwd_fanin", "fp_bwd_fanin")
    rec_fp = {k: [] for k in KERNELS}
    out_fp = os.path.join(work, "out_fullprob")
    wall, counts_fp, plain_calls, stats = run_cli(
        "fullprob_path", fas, nh, out_fp, recording(rec_fp),
        ["--full-probability"])
    cols = check_rows("fullprob_path", out_fp, seqs)
    sup = support()
    log("fullprob_path: %d rows x %d cols in %.1f s; launches D=%d+%d "
        "E=%d+%d (linear + fan-in) A=%d B=%d; posterior support of %d root "
        "sites in [%.6f, %.6f]; FASTA %s main_path's; stats %s"
        % (len(seqs), cols, wall, counts_fp["fp_fwd"],
           counts_fp["fp_fwd_fanin"], counts_fp["fp_bwd"],
           counts_fp["fp_bwd_fanin"], counts_fp["linear"],
           counts_fp["fanin"], len(sup), sup.min(), sup.max(),
           "equals" if open(out_fp + ".fas", "rb").read() == a
           else "differs from", json.dumps(stats)))
    if cols != 1535:
        fail("fullprob_path: expected 1535 columns, got %d" % cols)
    if min(counts_fp[k] for k in FP_KEYS + ("linear", "fanin")) < 1:
        fail("fullprob_path: a kernel was never launched (%s)" % counts_fp)
    if plain_calls:
        fail("fullprob_path: %d plain-version calls on CUDA" % plain_calls)
    # A support is exp(fcum + bcum - log_total) times a plane product.
    # At this width the three logarithms are thousands of nats in f32
    # (spacing 1.2e-4 to 4.9e-4), so a certain site may pass 1 by their
    # rounding: the upper limit allows 2%.
    if not (np.isfinite(sup).all() and sup.min() > 0
            and sup.max() <= SUPPORT_MAX):
        fail("fullprob_path: posterior support outside (0, %g]"
             % SUPPORT_MAX)

    out_sp = os.path.join(work, "out_sampled")
    wall, counts_sp, plain_calls, stats = run_cli(
        "fullprob_path sampled", fas, nh, out_sp, real,
        ["--sample-path", "--seed", "7"])
    cols = check_rows("fullprob_path sampled", out_sp, seqs)
    log("fullprob_path: --sample-path --seed 7: %d rows x %d cols in %.1f "
        "s, every row intact; launches D=%d+%d E=%d+%d A=%d B=%d"
        % (len(seqs), cols, wall, counts_sp["fp_fwd"],
           counts_sp["fp_fwd_fanin"], counts_sp["fp_bwd"],
           counts_sp["fp_bwd_fanin"], counts_sp["linear"],
           counts_sp["fanin"]))
    if min(counts_sp[k] for k in FP_KEYS) < 1 or plain_calls:
        fail("fullprob_path sampled: launches %s, %d plain-version calls"
             % (counts_sp, plain_calls))
    if counts_sp["linear"] or counts_sp["fanin"]:
        fail("fullprob_path sampled: a Viterbi fill ran for a sampled path")

    # ROADMAP Queue 3's amplicon family (tools/reads.py's
    # amplicon_reads(8, 120, 400, seed=7) under a balanced 8-leaf tree)
    # with --full-probability: the batched Viterbi jobs take kernel A's
    # pair-end build with no break column, the reference's scan-core
    # rule, and the FASTA is the JAX CLI's (sha256 of python -c
    # "$REFERENCE_FP" -s amp.fas -t amp.nh --full-probability, on the CPU
    # with its Pallas kernels in interpret mode; the Pallas rule writes
    # other bytes from byte 225)
    from pagan2_tpu_torch.tools.reads import amplicon_reads, write_reads
    AMP_TREE = ("(((r000:0.1,r001:0.1):0.05,(r002:0.1,r003:0.1):0.05):0.05,"
                "((r004:0.1,r005:0.1):0.05,(r006:0.1,r007:0.1):0.05):0.05);")
    AMP_ONE_FAS = ("ce07e834c43b4ec2fb8e2daca832a69a"
                   "5ab7ff0ba0a65bf5bdbb71aa4002b832")
    AMP_MESH_FAS = ("b7b12f2c3ce5e8beced84bb008b4f44a"
                    "d3b0ebd9665a55fbed9439279d647ffb")
    AMP_FP_FAS = ("5b45b3e4792a8fac7c4be5e5944af3ce"
                  "aef0e413a4205a5abcc61f780dce0ac5")
    amp_seqs = amplicon_reads(8, 120, 400, seed=7)
    fas_amp = write_reads(os.path.join(work, "amp.fas"), amp_seqs)
    nh_amp = os.path.join(work, "amp.nh")
    with open(nh_amp, "w") as f:
        f.write(AMP_TREE + "\n")
    out_ampfp = os.path.join(work, "amp_fullprob")
    _w, c_ampfp, plain_calls, _s = run_cli(
        "fullprob_amplicon", fas_amp, nh_amp, out_ampfp, real,
        ["--full-probability"])
    c_ampfp["linear_pair_end"] = VL.PAIR_END_LAUNCHES
    got = hashlib.sha256(open(out_ampfp + ".fas", "rb").read()).hexdigest()
    log("fullprob_amplicon: the amplicon family with --full-probability "
        "in %.1f s: sha256 %s the JAX CLI's; launches %s"
        % (_w, "equals" if got == AMP_FP_FAS else "DIFFERS FROM",
           json.dumps(c_ampfp)))
    if got != AMP_FP_FAS or plain_calls or c_ampfp["linear_pair_end"] < 1:
        fail("fullprob_amplicon: sha256 %s (want %s), %d plain-version "
             "calls, %d pair-end launches of kernel A"
             % (got, AMP_FP_FAS, plain_calls, c_ampfp["linear_pair_end"]))

    # kernels against forced plain versions, both flags, on a 4 x 511
    # family of the generator (8 x 511 before the placement phases came:
    # cut for their time)
    seqs4fp, tree4fp = family(4, 511)
    fas4fp, nh4fp = write_input(work, "family4", seqs4fp, tree4fp)
    for tag, extra in (("fullprob4", ["--full-probability"]),
                       ("sampled4", ["--sample-path", "--seed", "7"])):
        out4 = os.path.join(work, tag + "_kernel")
        _w, c4, plain_calls, _s = run_cli(tag, fas4fp, nh4fp, out4, real,
                                          extra)
        check_rows(tag, out4, seqs4fp)
        if min(c4[k] for k in FP_KEYS) < 1 or plain_calls:
            fail("%s: launches %s, %d plain-version calls"
                 % (tag, c4, plain_calls))
        sup_kernel = support()
        same_output(tag, out4, seqs4fp, fas4fp, nh4fp, extra)
        d = float(np.abs(sup_kernel - support()).max())
        log("%s: posterior support kernel vs plain max |err| %.3g" % (tag, d))
        if d > 1e-5:
            fail("%s: posterior support differs from the plain run's" % tag)

    # ---- long_family: anchored long leaf pairs on kernel C ----
    seqs4, tree4 = family(4, 4000)
    fas4, nh4 = write_input(work, "long_family", seqs4, tree4)
    rec_long = {k: [] for k in KERNELS}
    out_long = os.path.join(work, "long_kernel")
    wall, counts_long, plain_calls, stats = run_cli(
        "long_family", fas4, nh4, out_long, recording(rec_long))
    cols = check_rows("long_family", out_long, seqs4)
    log("long_family: 4 rows x %d cols in %.1f s; launches A=%d B=%d "
        "C=%d; stats %s" % (cols, wall, counts_long["linear"],
                            counts_long["fanin"], counts_long["banded"],
                            json.dumps(stats)))
    if counts_long["banded"] != 2 or stats["banded_fills"] != 2:
        fail("long_family: expected 2 banded fills on kernel C, got %d "
             "launches (%d fills)" % (counts_long["banded"],
                                     stats["banded_fills"]))
    if counts_long["fanin"] < 1 or \
            stats["fanin_windowed"] + stats["fanin_banded_full"] < 1:
        fail("long_family: no anchored fan-in fill on kernel B")
    if plain_calls:
        fail("long_family: %d plain-version calls on CUDA" % plain_calls)
    # the plain versions forced on a 4 x 3,100 family of the generator
    # (4 x 4,000 before the cli_rest_path phase came: cut for its time),
    # each pair still past the anchoring gate of 3,000 sites
    seqs31, tree31 = family(4, 3100)
    fas31, nh31 = write_input(work, "long_family31", seqs31, tree31)
    out31 = os.path.join(work, "long31_kernel")
    _w, c31, plain_calls, _s = run_cli("long31", fas31, nh31, out31, real)
    check_rows("long31", out31, seqs31)
    if c31["banded"] != 2 or plain_calls:
        fail("long31: launches %s, %d plain-version calls"
             % (c31, plain_calls))
    same_output("long31", out31, seqs31, fas31, nh31)

    # ---- pileup_path: bench.py's 454 amplicon demo through the CLI ----
    # sha256 of the JAX CLI's outputs on the same read files, made on
    # the CPU with its Pallas kernels in interpret mode and x64 off
    # (REFERENCE in tests/test_torch_pileup.py), the reads written by
    # pagan2_tpu_torch/tools/reads.py as below:
    #   python -c "$REFERENCE" --pileup --homopolymer --output-consensus \
    #       -q reads40.fas -o ref                  (41 rows, 0 discarded)
    #   python -c "$REFERENCE" --pileup --454 -q reads40.fas -o ref
    #   python -c "$REFERENCE" --pileup --pair-end [--no-anchors] \
    #       -q reads40.fastq -o ref                (40 rows, 0 discarded)
    #   python -c "$REFERENCE" --pileup --pair-end --full-probability \
    #       -q reads8.fastq -o ref                 (8 rows, 0 discarded)
    PILEUP40_FAS = ("f8503a9dd6e54ddbb510d0cb6c7a3ce1"
                    "f8623b86b93beec2bd1f65d00a1876ea")
    PILEUP40_CONSENSUS = ("9d6ddc86c2b7fc9cd261567a7dc181ef"
                          "da4d4ba92ba926ea5c481663d06c3b6e")
    PILEUP40_454_FAS = ("48421de8822028e306951d38137bc24e"
                        "95e69bcec13e947ae8f2eb4bc7250a35")
    PAIREND40_FAS = ("075d770b8790b9fba9ba98a359aa67bf"
                     "083e1e8133957b2e512132bf4a320c71")
    PAIREND8_FP_FAS = ("dd3ad3fdfe2ad01f4aac26440eb6dba6"
                       "57490c820a7ea6d01ff984c88efc3ae7")
    from pagan2_tpu_torch.tools.reads import (amplicon_reads,
                                              pair_end_reads,
                                              placement_queries,
                                              write_reads)

    def sha(path):
        return hashlib.sha256(open(path, "rb").read()).hexdigest()

    def route_text(counts, stats):
        return ("launches A=%d (pair-end build %d) B=%d C=%d; routes: %d "
                "batched fan-in launches, %d windowed + %d full-width "
                "anchored fan-in fills, %d banded linear fills, %d single "
                "jobs" % (counts["linear"], VL.PAIR_END_LAUNCHES,
                          counts["fanin"], counts["banded"],
                          stats["fanin_batches"], stats["fanin_windowed"],
                          stats["fanin_banded_full"], stats["banded_fills"],
                          stats["single_jobs"]))

    path_launches = {"main_path": counts, "fullprob_path": counts_fp,
                     "long_family": counts_long,
                     "fullprob_amplicon": c_ampfp}
    reads40 = amplicon_reads(40, 384, 420)
    fas40 = write_reads(os.path.join(work, "reads40.fas"), reads40)
    out_pile = os.path.join(work, "pileup40")
    rec_pile = {k: [] for k in KERNELS}
    wall, counts_pile, plain_calls, stats = run_cli(
        "pileup_path", fas40, None, out_pile, recording(rec_pile),
        ["--homopolymer", "--output-consensus"])
    pres = last_result[0]
    placed = len(reads40) - len(pres.discarded)
    log("pileup_path: 40 x 384 reads --homopolymer --output-consensus, %d "
        "placed, consensus %d bp, in %.1f s; %s"
        % (placed, len(pres.consensus or ""), wall,
           route_text(counts_pile, stats)))
    if placed != 40 or len(pres.consensus or "") != 496:
        fail("pileup_path: %d placed, consensus %d bp (the JAX CLI: 40, "
             "496)" % (placed, len(pres.consensus or "")))
    if sha(out_pile + ".fas") != PILEUP40_FAS or \
            sha(out_pile + "_consensus.fas") != PILEUP40_CONSENSUS:
        fail("pileup_path: the output differs from the JAX CLI's")
    if counts_pile["fanin_groups"] < 1 or plain_calls:
        fail("pileup_path: launches %s, %d plain-version calls"
             % (counts_pile, plain_calls))
    log("pileup_path: out.fas and out_consensus.fas are the JAX CLI's "
        "bytes; %d of %d kernel-B launches on its group build"
        % (counts_pile["fanin_groups"], counts_pile["fanin"]))
    path_launches["pileup_path"] = counts_pile

    # the same reads with --pileup --454: most fills past the templates
    out454 = os.path.join(work, "pileup454")
    rec_454 = {k: [] for k in KERNELS}
    wall, counts454, plain_calls, stats = run_cli(
        "pileup454_path", fas40, None, out454, recording(rec_454), ["--454"])
    log("pileup454_path: 40 x 384 reads --454 in %.1f s; %s; %d of them "
        "on B's group build" % (wall, route_text(counts454, stats),
                                counts454["fanin_groups"]))
    if sha(out454 + ".fas") != PILEUP40_454_FAS:
        fail("pileup454_path: the output differs from the JAX CLI's")
    if counts454["fanin_groups"] < 1 or plain_calls:
        fail("pileup454_path: launches %s, %d plain-version calls"
             % (counts454, plain_calls))
    log("pileup454_path: out.fas is the JAX CLI's bytes")
    path_launches["pileup454_path"] = counts454

    # the scale point: 160 reads of the same generator, timed by phase
    host = {}

    def timed_host(fn, key, sync=False):
        def run(*a, **kw):
            t = time.time()
            out = fn(*a, **kw)
            if sync:
                torch.cuda.synchronize()
            host[key] = host.get(key, 0.0) + time.time() - t
            return out
        return run
    reads160 = amplicon_reads(160, 384, 420)
    fas160 = write_reads(os.path.join(work, "reads160.fas"), reads160)
    fills = dict(real)
    fills["fanin"] = timed_host(real["fanin"], "kernel B calls", True)
    patches = [(PILE, "read_alignment_scores", "read_alignment_scores"),
               (PILE, "_extract", "_extract"),
               (ALIGN, "build_ancestral_graph", "ancestral build"),
               (VF, "prepare_fanin", "prepare_fanin")]
    saved = [(m, n, getattr(m, n)) for m, n, _k in patches]
    for m, n, key in patches:
        setattr(m, n, timed_host(getattr(m, n), key))
    try:
        wall, counts160, plain_calls, stats = run_cli(
            "pileup_160", fas160, None, os.path.join(work, "pileup160"),
            fills, ["--homopolymer", "--output-consensus"])
    finally:
        for m, n, fn in saved:
            setattr(m, n, fn)
    placed = len(reads160) - len(last_result[0].discarded)
    log("pileup_160: 160 x 384 reads, %d placed, consensus %d bp, in %.1f "
        "s; %s; %d plain-version calls" % (
            placed, len(last_result[0].consensus or ""), wall,
            route_text(counts160, stats), plain_calls))
    for key, v in host.items():
        log("pileup_160 host phase %-24s %8.3f s" % (key, v))
    if counts160["fanin"] < 1 or plain_calls:
        fail("pileup_160: launches %s, %d plain-version calls"
             % (counts160, plain_calls))
    path_launches["pileup_160"] = counts160

    # ---- pairend_path: the same reads as pair-end FASTQ reads ----
    pe40 = pair_end_reads(reads40, 60, 120)
    fq40 = write_reads(os.path.join(work, "reads40.fastq"), pe40)
    preps = []
    prepare_fanin = VF.prepare_fanin

    def counting_prep(*a, **kw):
        inp = prepare_fanin(*a, **kw)
        preps.append(bool(inp["pair_end"]))
        return inp
    pe_out = {}
    for tag, extra in (("pairend_path", []),
                       ("pairend_no_anchors", ["--no-anchors"])):
        del preps[:]
        VF.prepare_fanin = counting_prep
        try:
            wall, c_pe, plain_calls, stats = run_cli(
                tag, fq40, None, os.path.join(work, tag), real,
                ["--pair-end"] + extra)
        finally:
            VF.prepare_fanin = prepare_fanin
        pe_out[tag] = open(os.path.join(work, tag + ".fas"), "rb").read()
        log("%s: 40 pair-end reads (a 60-120 bp insert cut out of each), "
            "%d placed, in %.1f s; %s; %d of %d fan-in preps with a break "
            "set" % (tag, 40 - len(last_result[0].discarded), wall,
                     route_text(c_pe, stats), sum(preps), len(preps)))
        if hashlib.sha256(pe_out[tag]).hexdigest() != PAIREND40_FAS:
            fail("%s: the output differs from the JAX CLI's" % tag)
        if c_pe["fanin"] < 1 or not any(preps) or plain_calls:
            fail("%s: kernel B never launched with a break set, or %d "
                 "plain-version calls" % (tag, plain_calls))
        if extra and VL.PAIR_END_LAUNCHES < 1:
            fail("%s: kernel A's pair-end build never launched" % tag)
        path_launches[tag] = dict(c_pe, linear_pair_end=VL.PAIR_END_LAUNCHES)
    if pe_out["pairend_path"] != pe_out["pairend_no_anchors"]:
        fail("pairend_path: default and --no-anchors runs differ")
    fq8 = write_reads(os.path.join(work, "reads8.fastq"), pe40[:8])
    wall, c_fp, plain_calls, stats = run_cli(
        "pairend_fullprob", fq8, None, os.path.join(work, "pairend_fp"),
        real, ["--pair-end", "--full-probability"])
    log("pairend_fullprob: 8 pair-end reads --full-probability in %.1f s; "
        "launches D=%d+%d E=%d+%d (linear + fan-in); %s"
        % (wall, c_fp["fp_fwd"], c_fp["fp_fwd_fanin"], c_fp["fp_bwd"],
           c_fp["fp_bwd_fanin"], route_text(c_fp, stats)))
    if sha(os.path.join(work, "pairend_fp.fas")) != PAIREND8_FP_FAS:
        fail("pairend_fullprob: the output differs from the JAX CLI's")
    if plain_calls or c_fp["fp_fwd"] + c_fp["fp_fwd_fanin"] < 1:
        fail("pairend_fullprob: launches %s, %d plain-version calls"
             % (c_fp, plain_calls))
    log("pairend_path: default, --no-anchors and --full-probability runs "
        "give the JAX CLI's bytes")
    path_launches["pairend_fullprob"] = c_fp

    # ---- the read paths with the plain versions forced, at a small
    # depth: 8 x 192 reads of the same generator (12 before the
    # cli_rest_path phase came: cut for its time) ----
    reads12 = amplicon_reads(8, 192, 220)
    for tag, rfile, extra in (
            ("pileup12", write_reads(os.path.join(work, "reads12.fas"),
                                     reads12),
             ["--both-strands", "--build-contigs"]),
            ("pairend12", write_reads(os.path.join(work, "reads12.fastq"),
                                      pair_end_reads(reads12, 30, 60)),
             ["--pair-end", "--build-contigs"])):
        outs = {}
        for kind, fl in (("kernel", real), ("plain", plain)):
            o = os.path.join(work, "%s_%s" % (tag, kind))
            wall, c12, plain_calls, _st = run_cli(tag, rfile, None, o, fl,
                                                  extra)
            outs[kind] = [open(o + sfx, "rb").read()
                          for sfx in (".fas", "_contigs.fas")]
            # the plain versions stand in the wrappers' places, so a
            # forced-plain run counts neither launches nor plain calls
            launched = sum(c12.values())
            if (kind == "kernel") != bool(launched) or plain_calls:
                fail("%s %s: launches %s, %d plain-version calls"
                     % (tag, kind, c12, plain_calls))
            log("%s: %s (%.1f s): launches %s" % (tag, kind, wall,
                                                  json.dumps(c12)))
        if outs["kernel"] != outs["plain"]:
            fail("%s: kernel and plain .fas/_contigs.fas differ" % tag)
        log("%s: the plain versions on CUDA give byte-identical .fas and "
            "_contigs.fas" % tag)

    # ---- placement_path: queries placed onto the main path's alignment ----
    # The main path's out.fas is the JAX CLI's: sha256 of its output on
    # the same input, made on the CPU as PILEUP40_FAS was (python -c
    # "$REFERENCE" -s family.fas -t family.nh -o ref). With the family's
    # tree it is the reference alignment of the runs below. The queries
    # come from tools/reads.py's placement_queries(1535, 8, 24, 150, 400,
    # 8, 2, 300): 8 new members of the family, 24 reads of 150-400 bp (8
    # of them reverse-complemented) and 2 random 300-bp sequences, 34 in
    # all. Runs (a) and (b) take a cut of them: the first 4 queries and
    # the 2 random ones (q6.fas; the first 8 and the 2 random ones before
    # the cli_rest_path phase came: cut for its time). On all 34 the JAX
    # CLI needs more than 30 minutes on the CPU, and the card 254 s and
    # 245 s for (a) and (b), more than this script's budget;
    # tools/bench_placement.py makes and times the 34-query runs. The
    # sha256 of each run's files are the JAX CLI's on the same flags:
    #   (a) --ref-seqfile ref.fas --ref-treefile family.nh -q q6.fas
    #       --both-strands --output-discarded-queries
    #   (b) the same with --fragments
    #   (c) -s family.fas -t family.nh -q q8.fas       (the 8 members)
    #   (d) --ref-seqfile ref.fas --ref-treefile family.nh -q r24.fas
    #       --align-reads-at-root                     (the 24 reads)
    MAIN16_FAS = ("8a1010095f33bd993d5770f91aa6d158"
                  "3ae303380ea648fb576c502841c5e418")
    PLACE_SHA = {
        "a": {".fas": "b509d5948ab7b0c1df5e7b056b42b6d1"
                      "700321da5baaf47cc19b905ee2935800",
              ".discarded": "4b4db78aef0f21d3ea010b8869d9914e"
                            "f66173833d4f8fe2fe0fa1db3557a7f0"},
        "b": {".fas": "3be57bf569c7911625c46dc41b3e95fd"
                      "c129bd1df3873c50fa793bf0a454b088",
              ".discarded": "4b4db78aef0f21d3ea010b8869d9914e"
                            "f66173833d4f8fe2fe0fa1db3557a7f0"},
        "c": {".fas": "48d82d74f7d10191e28d0a9aa6d36f72"
                      "c7ebc089b8ce789f798651456741cd96"},
        "d": {".fas": "f597a3f72da6059a422e6d3940efb819"
                      "660f05c9e179013afbe16a319bc38b1d"}}
    t_place = time.time()
    if sha(out_kernel + ".fas") != MAIN16_FAS:
        fail("placement_path: main_path's out.fas differs from the JAX "
             "CLI's")
    log("placement_path: main_path's 16 x 1535 out.fas is the JAX CLI's "
        "bytes")
    pq = placement_queries(1535, 8, 24, 150, 400, 8, 2, 300)
    q6 = write_reads(os.path.join(work, "q6.fas"), pq[:4] + pq[32:])
    q8 = write_reads(os.path.join(work, "q8.fas"), pq[:8])
    r24 = write_reads(os.path.join(work, "r24.fas"), pq[8:32])
    ref16 = ["--ref-seqfile", out_kernel + ".fas", "--ref-treefile", nh]
    place_runs = (
        ("a", "placement_path", ref16 + [
            "-q", q6, "--both-strands", "--output-discarded-queries"]),
        ("b", "placement_fragments", ref16 + [
            "-q", q6, "--both-strands", "--output-discarded-queries",
            "--fragments"]),
        ("c", "placement_after_progressive", ["-s", fas, "-t", nh,
                                              "-q", q8]),
        ("d", "placement_at_root", ref16 + ["-q", r24,
                                            "--align-reads-at-root"]))
    # run (a)'s host phases, each timed where placement calls it
    host.clear()
    place_patches = [
        (PLACE, "_build_score_jobs", "scoring prep (graph deep copies)"),
        (EX, "execute_pair_jobs", "execute_pair_jobs"),
        (PLACE, "_match_score_from_anc", "_match_score_from_anc"),
        (PLACE, "align_pair", "splice align_pair"),
        (PLACE, "read_alignment_scores", "read_alignment_scores"),
        (PLACE, "_correct_sites_index", "_correct_sites_index"),
        (PLACE, "extract_alignment", "extract_alignment")]
    rec_place = {k: [] for k in KERNELS}
    for run, tag, flags in place_runs:
        out = os.path.join(work, "place_" + run)
        saved = [(m, n, getattr(m, n)) for m, n, _k in place_patches]
        if run == "a":
            for m, n, key in place_patches:
                setattr(m, n, timed_host(getattr(m, n), key))
        try:
            wall, c_pl, plain_calls, stats = run_cli(
                tag, None, None, out,
                recording(rec_place) if run == "a" else real, flags)
        finally:
            for m, n, fn in saved:
                setattr(m, n, fn)
        res = last_result[0]
        if run == "d":      # a PileupResult: the reads at the root
            placed, gone = 24 - len(res.discarded), list(res.discarded)
        else:
            placed, gone = len(res.placed), [e.name for e in res.discarded]
        files = [".fas"] + ([".discarded"] if run in "ab" else [])
        differ = [sfx for sfx in files
                  if sha(out + sfx) != PLACE_SHA[run][sfx]]
        log("%s: run (%s) %d placed, %d discarded (%s) in %.1f s; %s; %d "
            "plain-version calls; %s the JAX CLI's bytes"
            % (tag, run, placed, len(gone), ",".join(gone), wall,
               route_text(c_pl, stats), plain_calls,
               " and ".join(files) + (" differ from" if differ else
                                      " are")))
        if differ:
            fail("%s: %s differ from the JAX CLI's" % (tag, differ))
        # a query against a leaf fills on kernel A, or on kernel C when
        # anchored with a thin band; against an ancestor on kernel B
        if plain_calls or c_pl["fanin"] < 1 or \
                (run != "d" and c_pl["linear"] + c_pl["banded"] < 1):
            fail("%s: launches %s, %d plain-version calls"
                 % (tag, c_pl, plain_calls))
        if run in "ab" and not {"x0", "x1"} <= set(gone):
            fail("%s: a random sequence was placed" % tag)
        path_launches[tag] = c_pl
    for key, v in host.items():
        log("placement_path host phase %-34s %8.3f s" % (key, v))

    # runs (a) and (b) with the plain versions forced on CUDA, on the 4 x
    # 511 family's --full-probability alignment (fullprob4) with a
    # reverse-complemented read of the generator: under 200 bp it does
    # not anchor, so its scoring jobs batch into a few fills (the plain
    # versions take 1-7 s a fill on the card; 8 queries on the 8 x 511
    # alignment took 160 s, 2 reads 50-63 s, 1 read 8.4 s)
    ref4 = ["--ref-seqfile", os.path.join(work, "fullprob4_kernel.fas"),
            "--ref-treefile", nh4fp, "-q", write_reads(
                os.path.join(work, "r1_511.fas"),
                placement_queries(511, 1, 2, 120, 180, 1, 0, 0)[1:2]),
            "--both-strands", "--output-discarded-queries"]
    for tag, extra in (("placement4", []),
                       ("placement4_fragments", ["--fragments"])):
        outs = {}
        for kind, fl in (("kernel", real), ("plain", plain)):
            o = os.path.join(work, "%s_%s" % (tag, kind))
            wall, c8, plain_calls, _st = run_cli(tag, None, None, o, fl,
                                                 ref4 + extra)
            outs[kind] = [open(o + sfx, "rb").read() if
                          os.path.exists(o + sfx) else None
                          for sfx in (".fas", ".discarded")]
            launched = sum(c8.values())
            if (kind == "kernel") != bool(launched) or plain_calls:
                fail("%s %s: launches %s, %d plain-version calls"
                     % (tag, kind, c8, plain_calls))
            log("%s: %s (%.1f s): launches %s" % (tag, kind, wall,
                                                  json.dumps(c8)))
        if outs["kernel"] != outs["plain"]:
            fail("%s: kernel and plain .fas/.discarded differ" % tag)
        log("%s: the plain versions on CUDA give byte-identical .fas and "
            ".discarded" % tag)
    log("placement_path: %.1f s in all" % (time.time() - t_place))

    # ---- cli_rest_path: the rest of the CLI on the card ----
    # sha256 of the JAX CLI's outputs on the same inputs, made on the CPU
    # as PILEUP40_FAS was (python -c "$REFERENCE" ... --silent -o ref):
    #   (a) -s family.fas --output-ancestors --events --output-nhx-tree
    #       --xml-nhx --mpost-graph-file ref_g.mp     (no -t: inferred)
    #   (b) -s coding.fas -t coding.nh --translate    (family(16, 1536))
    #   (d) -s family.fas -t family.nh -q q8.fas --prune-extended-alignment
    #       --prune-keep-number 4                     (the 8 members), and
    #       -s family.fas -t family.nh -q r3.fas --trim-extended-alignment
    #       (reads r01, r04 and r07: the trim keeps 687 of 1,535 columns)
    #   (e) -s long_family.fas -t long_family.nh --plot-anchors-for-R
    #       ref_anchors                 (4 x 4,000; one .r an anchored pair)
    REST_SHA = {
        "a": {".fas": "814e4bfcc14c8e7200256e1ce75f2f4a"
                      "4cac5c1f7939d8f93cf67b949d6703e6",
              ".anctree": "6e896a84aee66fdea69ce1dc77a60577"
                          "220fe36a328d4e3f27c41c6b1b26fc46",
              ".events": "91d07358ff552a9b7d88545842eeb8ba"
                         "2eff939bca754ff9b937777034bcccec",
              ".nhx_tree": "4a05a718c687895505d354e5cfa6f6d3"
                           "736c3c229ffeeb0a97b6cde6671a203b",
              ".xml": "0ea186bdc64b3b3666a23fb18bcd8b66"
                      "51f037a53418b22f010c2ed38fd6daea",
              "_g.mp": "7cd1299e600df2e754c8cdabbdadb835"
                       "eb311a1f50eac834be385d364652a66b"},
        "b": {".fas": "1e6be42b82cc89c9792cae419365df77"
                      "dbf34a35fe92c573aa772124d323af1b",
              ".codon.fas": "cd6bd39c325f42b99e07c8fc2e3cfa29"
                            "34d1b8e9fa90ca72d3e24c60f290b058"},
        "dp": {".fas": "48d82d74f7d10191e28d0a9aa6d36f72"
                       "c7ebc089b8ce789f798651456741cd96",
               ".pruned.fas": "c70e845b677123beb9c5a0c09dc4a02c"
                              "2fe4471eb84cf1668d49337240489e98",
               ".pruned.tre": "03b799578c4d6d42f2a1e38ebb6e1068"
                              "35e2466ff7b983c6bf8c502a9d5ec348"},
        "dt": {".fas": "7c5564febd61d9720aad6bd7a9bdc2eb"
                       "db2d39330f39286f9ab2c9c278f5928b",
               ".trimmed.fas": "6913ca073c66f72bfe7887bd453705b9"
                               "da027d50f0ea31724efb5b6f31f0ed07"},
        "e": {".fas": "ded329babe0fcaddcef99b7d244cb71e"
                      "0de900801ec1a8f227a77a2ffa969ba3",
              "_anchors_1.r": "15e3dc582209716058dacdd937f0b383"
                              "5f72a1bee5e51db3e71d35044f8682af",
              "_anchors_2.r": "a5d8451c4b74f5c55f1acf3993d390c8"
                              "cda03f3e7cdf2ff81661e67772b80abd",
              "_anchors_3.r": "040bde5073fa335952c3bd9280e038fc"
                              "1b03ab1b2f8234318aaebb2e269a347e"},
        "f": {}}
    # (f) writes run (a)'s alignment
    REST_SHA["f"][".fas"] = REST_SHA["a"][".fas"]
    t_rest = time.time()
    rest = os.path.join(work, "rest")
    os.makedirs(rest, exist_ok=True)
    rest_launches = {}

    def rest_run(run, tag, flags, files, kernels_used):
        """One run of the phase: its pinned files the JAX CLI's bytes,
        each kernel of `kernels_used` launched, no plain version."""
        out = os.path.join(rest, run)
        wall, c, plain_calls, stats = run_cli(
            tag, None, None, out, real,
            [a.replace("{o}", out) for a in flags])
        differ = [sfx for sfx in files
                  if sha(out + sfx) != REST_SHA[run][sfx]]
        log("%s: run (%s) in %.1f s; %s; %d plain-version calls; %s %s "
            "the JAX CLI's bytes" % (
                tag, run, wall, route_text(c, stats), plain_calls,
                " ".join(files), "differ from" if differ else "are"))
        if differ:
            fail("%s: %s differ from the JAX CLI's" % (tag, differ))
        if plain_calls or min(c[k] for k in kernels_used) < 1:
            fail("%s: launches %s, %d plain-version calls"
                 % (tag, c, plain_calls))
        for k, v in c.items():
            rest_launches[k] = rest_launches.get(k, 0) + v
        return out, wall, c
    rest_a = ["-s", fas, "--output-ancestors", "--events",
              "--output-nhx-tree", "--xml-nhx", "--mpost-graph-file",
              "{o}_g.mp"]
    rest_run("a", "cli_rest_infer", rest_a,
             (".fas", ".anctree", ".events", ".nhx_tree", ".xml", "_g.mp"),
             ("linear", "fanin"))
    seqs_c, tree_c = family(16, 1536)
    fas_c, nh_c = write_input(work, "coding", seqs_c, tree_c)
    rest_run("b", "cli_rest_translate",
             ["-s", fas_c, "-t", nh_c, "--translate"],
             (".fas", ".codon.fas"), ("linear", "fanin"))
    # (c) --checkpoint-dir: a full run, then one without the root's and a
    # first pair's .npz (those two recomputed), both main_path's bytes;
    # the same directory under another --indel-rate is refused
    import shutil
    from pagan2_tpu_torch.tree.newick import parse_newick
    ck = os.path.join(rest, "ck")
    shutil.rmtree(ck, ignore_errors=True)
    t16 = parse_newick(tree)
    t16.name_internal()
    gone = [t16.name, next(n.name for n in t16.nodes_postorder()
                           if not n.is_leaf)]
    for k in range(2):
        out = os.path.join(rest, "c%d" % k)
        wall, c, plain_calls, _st = run_cli(
            "cli_rest_checkpoint", fas, nh, out, real,
            ["--checkpoint-dir", ck])
        npz = sorted(f for f in os.listdir(ck) if f.endswith(".npz"))
        log("cli_rest_checkpoint: run %d in %.1f s, %d node files; "
            "launches %s" % (k + 1, wall, len(npz), json.dumps(c)))
        if sha(out + ".fas") != MAIN16_FAS or plain_calls or \
                len(npz) != 15 or (k == 1 and c["fanin"] < 1):
            fail("cli_rest_checkpoint: run %d: FASTA %s main_path's, %d "
                 "node files, launches %s, %d plain-version calls"
                 % (k + 1, "equals" if sha(out + ".fas") == MAIN16_FAS
                    else "differs from", len(npz), c, plain_calls))
        for key, v in c.items():
            rest_launches[key] = rest_launches.get(key, 0) + v
        for name in gone if k == 0 else ():
            os.remove(os.path.join(ck, name.replace("#", "n") + ".npz"))
    try:
        run_cli("cli_rest_checkpoint", fas, nh, os.path.join(rest, "c2"),
                real, ["--checkpoint-dir", ck, "--indel-rate", "0.02"])
        fail("cli_rest_checkpoint: another run's settings took the "
             "directory")
    except ValueError as e:
        if "different run" not in str(e):
            raise
    log("cli_rest_checkpoint: the resumed run gives main_path's bytes; "
        "another --indel-rate is refused")
    ref16q = ["-s", fas, "-t", nh, "-q", q8]
    rest_run("dp", "cli_rest_prune", ref16q + [
        "--prune-extended-alignment", "--prune-keep-number", "4"],
        (".fas", ".pruned.fas", ".pruned.tre"), ("linear", "fanin"))
    # the trim keeps the span of the reads' columns: three forward-strand
    # reads of placement_queries (sites 605-1263 of their members)
    r3 = write_reads(os.path.join(work, "r3.fas"), [pq[9], pq[12], pq[15]])
    out_t, _w, _c = rest_run(
        "dt", "cli_rest_trim", ["-s", fas, "-t", nh, "-q", r3,
                                "--trim-extended-alignment"],
        (".fas", ".trimmed.fas"), ("linear", "fanin"))
    widths = [len(read_fasta(out_t + sfx)[0][1])
              for sfx in (".fas", ".trimmed.fas")]
    log("cli_rest_trim: %d of %d columns kept" % (widths[1], widths[0]))
    out_e, _w, c_e = rest_run(
        "e", "cli_rest_anchors",
        ["-s", fas4, "-t", nh4, "--plot-anchors-for-R", "{o}_anchors"],
        tuple(sorted(REST_SHA["e"])), ("banded",))
    # (f) --jax-profile: a torch.profiler trace of run (a)'s inputs
    trace_json = os.path.join(rest, "f_trace.json")
    out_f, _w, _c = rest_run("f", "cli_rest_profile", rest_a + [
        "--jax-profile", trace_json], (".fas",), ("linear", "fanin"))
    text = open(trace_json).read()
    names = sorted({n for n in ("viterbi_linear", "viterbi_fanin")
                    if n in text})
    log("cli_rest_profile: trace %d bytes, names %s" % (len(text), names))
    if names != ["viterbi_fanin", "viterbi_linear"]:
        fail("cli_rest_profile: the trace does not name kernels A and B")
    path_launches["cli_rest_path"] = rest_launches
    log("cli_rest_path: %.1f s in all; launches %s"
        % (time.time() - t_rest, json.dumps(rest_launches)))

    # ---- mesh_path: the jobs mesh (--threads/--devices) ----
    # The CLI makes no mesh on one card (make_mesh: --threads 8 writes the
    # one-device bytes, multiprocess_path below). Here make_mesh hands the
    # CLI 4 logical shards of this card, JobsMesh([cuda:0] * 4), the mesh
    # --threads 4 makes over four cards: each generation's batches split
    # four ways, single-job buckets batched, linear batches on kernel A's
    # pair-end build (the reference's mesh rule). The .fas files are the
    # JAX CLI's with --threads 4 on 8 virtual CPU devices (sha256, made
    # on the CPU in interpret mode): on the 16 x 1535 family, with and
    # without --full-probability, its one-device bytes (MAIN16_FAS: no
    # tie there between the two rules); on the amplicon family other
    # bytes than its one-device run (AMP_MESH_FAS, not AMP_ONE_FAS).
    t_mesh = time.time()
    saved_make_mesh = CLI.make_mesh
    CLI.make_mesh = lambda args, device: JobsMesh([dev] * 4)
    mesh_launches = {}
    try:
        for tag, inputs, extra, want, used in (
                ("mesh_family", (fas, nh), [], MAIN16_FAS,
                 ("linear", "fanin")),
                ("mesh_family_fullprob", (fas, nh), ["--full-probability"],
                 MAIN16_FAS, FP_KEYS + ("linear", "fanin")),
                ("mesh_amplicon", (fas_amp, nh_amp), [], AMP_MESH_FAS,
                 ("linear", "fanin"))):
            out_m = os.path.join(work, tag)
            wall, c_m, plain_calls, st = run_cli(tag, *inputs, out_m, real,
                                                 extra)
            c_m["linear_pair_end"] = VL.PAIR_END_LAUNCHES
            got = sha(out_m + ".fas")
            log("mesh_path %s: %.1f s wall; sha256 %s the JAX CLI's "
                "--threads 4; launches %s; %d batched, %d single jobs"
                % (tag, wall, "equals" if got == want else "DIFFERS FROM",
                   json.dumps(c_m), st["batched_jobs"], st["single_jobs"]))
            if got != want or plain_calls or \
                    min(c_m[k] for k in used) < 1 or \
                    c_m["linear_pair_end"] < 1:
                fail("mesh_path %s: sha256 %s (want %s), %d plain-version "
                     "calls, launches %s" % (tag, got, want, plain_calls,
                                             c_m))
            mesh_launches[tag] = c_m
    finally:
        CLI.make_mesh = saved_make_mesh
    path_launches.update(mesh_launches)
    log("mesh_path: %.1f s in all" % (time.time() - t_mesh))

    # ---- multiprocess_path: ranks joined over gloo, and --threads 8 ----
    # Two port CLI processes with --jax-coordinator 127.0.0.1:<port>
    # --jax-num-processes 2 --jax-process-id 0|1, each its own -o: the
    # global mesh is one shard a rank (both on this card), each rank fills
    # its half of every batch and gathers the other's, and both write
    # the JAX CLI's --threads 2 bytes on the amplicon family (the same
    # sha256 as its --threads 4, AMP_MESH_FAS; the 16 x 1535 family's
    # two ranks, 10.4 s, were cut for the script's time). Then --threads
    # 8 in this process: one card, no mesh, the one-device bytes.
    import socket
    t_mp = time.time()
    for tag, inputs, want in (("mp_amplicon", (fas_amp, nh_amp),
                               AMP_MESH_FAS),):
        with socket.socket() as sock:
            sock.bind(("127.0.0.1", 0))
            port = sock.getsockname()[1]
        env = dict(os.environ, PYTHONPATH=HERE, PAGAN2_STRICT="1")
        procs = [subprocess.Popen(
            [sys.executable, "-m", "pagan2_tpu_torch", "-s", inputs[0],
             "-t", inputs[1], "--time", "--silent",
             "--jax-coordinator", "127.0.0.1:%d" % port,
             "--jax-num-processes", "2", "--jax-process-id", str(r),
             "-o", os.path.join(work, "%s_rank%d" % (tag, r))],
            cwd=HERE, env=env, stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True) for r in range(2)]
        t = time.time()
        try:
            outs = [p.communicate(timeout=300)[0] for p in procs]
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
        wall = time.time() - t
        for r, (p, out) in enumerate(zip(procs, outs)):
            if p.returncode != 0:
                fail("multiprocess_path %s: rank %d returned %d:\n%s"
                     % (tag, r, p.returncode, out[-3000:]))
            line = [ln for ln in out.splitlines() if "launches" in ln]
            log("multiprocess_path %s rank %d: %s" % (tag, r,
                                                      "; ".join(line)))
        shas = [sha(os.path.join(work, "%s_rank%d.fas" % (tag, r)))
                for r in range(2)]
        log("multiprocess_path %s: 2 ranks in %.1f s wall (their start "
            "included); sha256 %s" % (tag, wall, "both the JAX CLI's "
                                      "--threads 2" if shas == [want] * 2
                                      else shas))
        if shas != [want] * 2:
            fail("multiprocess_path %s: sha256 %s, want %s" % (tag, shas,
                                                                want))
    for tag, inputs, want in (("threads8_amplicon", (fas_amp, nh_amp),
                               AMP_ONE_FAS),
                              ("threads8_family", (fas, nh), MAIN16_FAS)):
        out_t = os.path.join(work, tag)
        wall, c_t, plain_calls, st = run_cli(tag, *inputs, out_t, real,
                                             ["--threads", "8"])
        got = sha(out_t + ".fas")
        log("multiprocess_path %s: --threads 8 on one card in %.1f s, "
            "sha256 %s the one-device bytes; launches %s"
            % (tag, wall, "equals" if got == want else "DIFFERS FROM",
               json.dumps(c_t)))
        if got != want or plain_calls:
            fail("multiprocess_path %s: sha256 %s, want %s"
                 % (tag, got, want))
        path_launches[tag] = c_t
    log("multiprocess_path: %.1f s in all" % (time.time() - t_mp))

    # ---- shardband_path: giant pairs band-sharded over 4 shards ----
    # A pair past the sharding gate alone in its generation on a mesh of
    # 4 logical shards: the linear pair of kernel_shardband (65,535 bp
    # against a 1,023 bp read of it, the gate's 65,536 rows, whose codes
    # there equal kernel A's pair-end build) through the CLI with
    # --no-anchors on kernel G, every row intact; a 454 pair (8,191 bp
    # against a 1,023 bp read) with --454 --no-anchors on kernel H, the
    # gate lowered to its 8,192 rows (a cut: at 65,536 rows its int32
    # codes alone take 17.4 GB, and the gather to the host twice that),
    # its FASTA equal to the same run with the gate raised (batched over
    # the mesh on kernel B). The linear pair's batched run (four
    # launches of kernel A, one a shard, each with the 4.4 GB of its
    # shard's codes to gather) stays cut for the script's time.
    t_sb = time.time()
    read454 = mutate(rng_gate, gate_base[3000:4023])
    fas_g = write_reads(os.path.join(work, "gate.fas"),
                        [("ref", "".join(gate_base)), ("read", gate_read)])
    fas_h = write_reads(os.path.join(work, "gate454.fas"),
                        [("ref", "".join(gate_base[:8191])),
                         ("read", read454[:1023])])
    nh_sb = os.path.join(work, "gate.nh")
    with open(nh_sb, "w") as f:
        f.write("(ref:0.1,read:0.1);\n")
    saved_gate = EX.SHARDBAND_MIN_L
    CLI.make_mesh = lambda args, device: JobsMesh([dev] * 4)
    sb_walls = {}
    try:
        for tag, fas_x, extra, gate, key in (
                ("shardband_linear", fas_g, ["--no-anchors"],
                 saved_gate, "sb_linear"),
                ("shardband_fanin", fas_h, ["--454", "--no-anchors"], 8192,
                 "sb_fanin")):
            EX.SHARDBAND_MIN_L = gate
            out_s = os.path.join(work, tag)
            wall, c_s, plain_calls, st = run_cli(tag, fas_x, nh_sb, out_s,
                                                 real, extra)
            sb_stats = dict(SB.FILL_STATS)
            check_rows(tag, out_s, read_fasta(fas_x))
            same, wall_b, c_b, plain_b = True, None, {}, 0
            if key == "sb_fanin":
                EX.SHARDBAND_MIN_L = 1 << 30
                out_b = os.path.join(work, tag + "_batched")
                wall_b, c_b, plain_b, st_b = run_cli(
                    tag + "_batched", fas_x, nh_sb, out_b, real, extra)
                same = open(out_s + ".fas", "rb").read() == \
                    open(out_b + ".fas", "rb").read()
            log("shardband_path %s: %.1f s wall, %d band-sharded fill(s) "
                "(launch loop %.3f s, gather %.3f s, %d blocks, %d tiles), "
                "launches %s, every row intact%s"
                % (tag, wall, st["shardband_fills"], sb_stats["loop_s"],
                   sb_stats["gather_s"], sb_stats["blocks"],
                   sb_stats["tiles"], json.dumps(c_s),
                   "" if wall_b is None else
                   "; the batched run on the mesh (%.1f s, launches %s) %s"
                   % (wall_b, json.dumps(c_b), "writes the same FASTA"
                      if same else "DIFFERS")))
            if not same or plain_calls or plain_b or c_s[key] < 1 or \
                    st["shardband_fills"] != 1 or c_b.get(key):
                fail("shardband_path %s: FASTA %s, launches %s / %s"
                     % (tag, "equal" if same else "differs", c_s, c_b))
            path_launches[tag] = c_s
            sb_walls[tag] = (wall, wall_b, sb_stats)
    finally:
        EX.SHARDBAND_MIN_L = saved_gate
        CLI.make_mesh = saved_make_mesh
    log("shardband_path: %.1f s in all" % (time.time() - t_sb))

    # ---- mito_path: a 16,569 bp pair without anchors on one card ----
    # tools/bench_linear_calls.py's giant_pairs: a 16,569 bp sequence (a
    # human mitochondrion's length) and a copy with 10% of its sites
    # redrawn, --no-anchors: one linear pair past 4,096 rows, so kernel
    # A's tiled build (16,570 x 16,570 cells); its FASTA equal to the
    # same run with the plain versions forced; the host phases timed
    # where the CLI calls them
    _g, (_n, mito_a, mito_b) = giant_pairs()
    fas_mt, nh_mt = write_input(work, "mito", [("a", mito_a),
                                               ("b", mito_b)],
                                "(a:0.1,b:0.1);")
    mito_phases = {}

    def phase_timer(fn, key, sync=False):
        def run(*a, **kw):
            t = time.time()
            out = fn(*a, **kw)
            if sync:
                torch.cuda.synchronize()
            mito_phases[key] = mito_phases.get(key, 0.0) + time.time() - t
            return out
        return run

    mito_patches = [
        (PROG, "build_leaf_graph", "graph build", False),
        (VL, "prepare_sheared", "prep: prepare_sheared (host)", False),
        (VL, "linear_batch_args", "prep: match scores folded and sheared "
         "on the card", True),
        (VL, "_finish_linear", "backtrack", False),
        (VL, "linear_align_path", "linear_align_path", True),
        (ALIGN, "build_ancestral_graph", "ancestral build", False),
        (PROG, "extract_alignment", "extract alignment", False),
        (CLI, "write_outputs", "write", False)]
    # the fill's outputs in the kernel run and in the forced-plain run,
    # and the plain fill's time (host clock, synchronized)
    mito_out = {}

    def keep(tag, fn):
        def run(**kw):
            t = time.time()
            out = fn(**kw)
            torch.cuda.synchronize()
            mito_out[tag] = out, 1e3 * (time.time() - t)
            return out
        return run

    rec_mito = {k: [] for k in KERNELS}
    fills = recording(rec_mito)
    fills["linear"] = phase_timer(keep("kernel", fills["linear"]),
                                  "fill (kernel A)", True)
    saved = [(m, n, getattr(m, n)) for m, n, _k, _s in mito_patches]
    for m, n, key, sync in mito_patches:
        setattr(m, n, phase_timer(getattr(m, n), key, sync))
    out_mt = os.path.join(work, "mito_kernel")
    try:
        wall_mt, c_mt, plain_calls, st_mt = run_cli(
            "mito_path", fas_mt, nh_mt, out_mt, fills, ["--no-anchors"])
    finally:
        for m, n, fn in saved:
            setattr(m, n, fn)
    path_launches["mito_path"] = c_mt
    check_rows("mito_path", out_mt, [("a", mito_a), ("b", mito_b)])
    if c_mt["linear"] != 1 or c_mt["linear_tiles"] != 1 or plain_calls:
        fail("mito_path: launches %s, %d plain-version calls (one tiled "
             "launch of kernel A wanted)" % (c_mt, plain_calls))
    mito_kw = rec_mito["linear"][0]
    log("mito_path: %.1f s wall; B, D, Lp = %s, %s; launches %s"
        % (wall_mt, tuple(mito_kw["ms"].shape),
           linear_plan_text(VL, mito_kw["ms"].shape[2]),
           json.dumps(c_mt)))
    rest = mito_phases["linear_align_path"] - sum(
        mito_phases[k] for k in mito_phases if k.startswith("prep")
        or k in ("fill (kernel A)", "backtrack"))
    mito_phases["codes and corner to the host (the rest of "
                "linear_align_path)"] = rest
    for key, v in mito_phases.items():
        log("mito_path host phase %-58s %8.3f s" % (key, v))
    # the same run with the plain versions forced: the same FASTA, and
    # the plain fill's codes and corner those of the tiled build (its
    # hold at this call's shape; ~20-50 s of plain loop)
    out_mp = os.path.join(work, "mito_plain")
    wall_mp, c_mp, _p, _s = run_cli(
        "mito_path", fas_mt, nh_mt, out_mp,
        dict(plain, linear=keep("plain", plain["linear"])),
        ["--no-anchors"])
    (k_codes, k_corner), _k_ms = mito_out.pop("kernel")
    (p_codes, p_corner), tiles_plain_ms = mito_out.pop("plain")
    if any(c_mp.values()) or open(out_mt + ".fas", "rb").read() != \
            open(out_mp + ".fas", "rb").read():
        fail("mito_path: the forced-plain run launched %s or wrote other "
             "FASTA" % c_mp)
    if not torch.equal(k_codes, p_codes) or not same_floats(k_corner,
                                                            p_corner):
        fail("mito_path: the tiled build's codes (%d differ) or corner "
             "differ from the plain version's"
             % int((k_codes != p_codes).sum()))
    tiles_err = max(tiles_err, max_abs_err(k_corner, p_corner))
    del k_codes, p_codes
    log("mito_path: plain versions on CUDA (%.1f s) give byte-identical "
        "FASTA; the plain fill (%.1f ms) gives the tiled build's codes "
        "and corner" % (wall_mp, tiles_plain_ms))

    # ---- fullprob_long_path: a pair past the lane builds ----
    # tools/bench_fullprob.py's redrawn_pair with indels 0.01: a 5,000 bp
    # sequence and a copy with 10% of its sites redrawn and 1-3 sites
    # lost or gained after 1% of them, through the CLI with
    # --full-probability and with --sample-path --seed 7: its linear
    # fills take kernels D's and E's cluster build; each .fas the JAX
    # CLI's bytes (sha256 of python -c "$REFERENCE_FP" on the same files,
    # on the CPU, f32, every Pallas module in interpret mode; tests/
    # test_torch_fullprob_long.py holds the port's CPU run to them). The
    # sampled path differs from the Viterbi path in 16 columns; the
    # timing phase holds the planes of the --full-probability run's
    # linear call against the plain versions.
    LONG_FP_SHA = {
        "full_probability": ("918197e66244fbb1cc600cb569b52b77"
                             "e4a3f193e073d91c2a41df2514e4e9b8"),
        "sample_path": ("79bf57f982345aca93e91cf16bdae4b9"
                        "47a30fae6aa6bbcb9af685953ab4b150")}
    from pagan2_tpu_torch.tools.bench_fullprob import redrawn_pair
    la, lb = redrawn_pair(5000, indels=0.01)
    fas_lp, nh_lp = write_input(work, "long5000", [("a", la), ("b", lb)],
                                "(a:0.1,b:0.1);")
    rec_lp = {k: [] for k in KERNELS}
    for tag, extra in (("full_probability", ["--full-probability"]),
                       ("sample_path", ["--sample-path", "--seed", "7"])):
        out_lp = os.path.join(work, "long_" + tag)
        wall_lp, c_lp, plain_calls, _s = run_cli(
            "fullprob_long_path", fas_lp, nh_lp, out_lp,
            recording(rec_lp) if tag == "full_probability" else real, extra)
        path_launches["fullprob_long_" + tag] = c_lp
        got = sha(out_lp + ".fas")
        log("fullprob_long_path: %s on the 5,000 bp pair in %.1f s: sha256 "
            "%s the JAX CLI's; launches D=%d (cluster %d) E=%d (cluster %d) "
            "A=%d; %d plain-version calls"
            % (" ".join(extra), wall_lp, "equals" if got == LONG_FP_SHA[tag]
               else "DIFFERS FROM", c_lp["fp_fwd"], c_lp["fp_fwd_cluster"],
               c_lp["fp_bwd"], c_lp["fp_bwd_cluster"], c_lp["linear"],
               plain_calls))
        if got != LONG_FP_SHA[tag] or plain_calls or \
                c_lp["fp_fwd_cluster"] < 1 or c_lp["fp_bwd_cluster"] < 1:
            fail("fullprob_long_path %s: sha256 %s (want %s), %d plain-"
                 "version calls, launches %s (the cluster build wanted)"
                 % (tag, got, LONG_FP_SHA[tag], plain_calls,
                    json.dumps(c_lp)))

    # ---- megabase: the slice at full width ----
    # bench.py's bench_megabase pair, seeded by default_rng(0) alone
    mega, mtree = megabase()
    fasm, nhm = write_input(work, "megabase", mega, mtree)
    phases = {}

    def timed(fn, key, sync=False):
        def run(*a, **kw):
            t = time.time()
            out = fn(*a, **kw)
            if sync:
                torch.cuda.synchronize()
            phases[key] = phases.get(key, 0.0) + time.time() - t
            return out
        return run

    # host phases, each timed where the CLI calls it
    patches = [(PROG, "build_leaf_graph", "graph build", False),
               (VB, "banded_args", "banded_args (prep, schedule, fold)",
                True),
               (VB, "fold_banded_stripe", "fold", True),
               (VB, "_host_fold", "fold", True),
               (VB, "_backtrack_arrays", "backtrack", False),
               (ALIGN, "build_ancestral_graph", "ancestral build", False),
               (PROG, "extract_alignment", "extract alignment", False),
               (CLI, "write_outputs", "write", False)]
    rec_mega = {k: [] for k in KERNELS}
    fills = recording(rec_mega)
    fills["banded"] = timed(fills["banded"], "fill", sync=True)
    saved = [(m, n, getattr(m, n)) for m, n, _k, _s in patches]
    for m, n, key, sync in patches:
        setattr(m, n, timed(getattr(m, n), key, sync))
    out_mega = os.path.join(work, "megabase_kernel")
    try:
        mrun = run_cli("megabase", fasm, nhm, out_mega, fills)
    finally:
        for m, n, fn in saved:
            setattr(m, n, fn)
    wall, counts_mega, plain_calls, stats = mrun
    path_launches["megabase"] = counts_mega
    cols = check_rows("megabase", out_mega, mega)
    if counts_mega["banded"] != 1 or stats["banded_fills"] != 1:
        fail("megabase: expected 1 banded fill on kernel C, got %d "
             "launches" % counts_mega["banded"])
    if plain_calls:
        fail("megabase: %d plain-version calls on CUDA" % plain_calls)
    msched = rec_mega["banded"][0]["sched"].cpu().numpy()
    log("megabase: 2 rows x %d cols in %.1f s; launches A=%d B=%d C=%d; "
        "w.max() %d (mean %.2f), Wk %d, %d diagonals, %d window cells, %d "
        "in-band cells" % (cols, wall, counts_mega["linear"],
                           counts_mega["fanin"], counts_mega["banded"],
                           msched[:, 1].max(), msched[:, 1].mean(),
                           rec_mega["banded"][0]["ms"].shape[1],
                           len(msched), msched[:, 1].astype(np.int64).sum(),
                           stats["batched_cells"]))
    for key in ("anchor_scan_s", "band_smooth_s"):
        log("megabase host phase %-36s %8.3f s (anchors.PREP_TIMINGS)"
            % (key, ANCH.PREP_TIMINGS.get(key, 0.0)))
    for key, v in phases.items():
        log("megabase host phase %-36s %8.3f s" % (key, v))

    # ---- tools: the measuring tools' entry points at full size ----
    from pagan2_tpu_torch.tools import (probe_linear, bisect_linear,
                                        sweep_linear, bench_linear)
    TOOLS = (("probe", probe_linear, 10), ("bisect", bisect_linear, 9),
             ("sweep", sweep_linear, 7), ("bench", bench_linear, 1))
    for k in VP.LAUNCHES:
        VP.LAUNCHES[k] = VP.PLAIN_CALLS[k] = 0
    VL.LAUNCHES = VL.PLAIN_CALLS = 0
    t = time.time()
    tool_res = {name: mod.main(["--device", "cuda"])
                for name, mod, _n in TOOLS}
    torch.cuda.synchronize()
    tool_launches = dict(VP.LAUNCHES)
    tool_plain = sum(VP.PLAIN_CALLS.values()) + VL.PLAIN_CALLS
    log("tools: probe, bisect, sweep and bench in %.1f s; kernel F "
        "launches %s, kernel A %d" % (time.time() - t,
                                       json.dumps(tool_launches),
                                       VL.LAUNCHES))
    for name, _mod, n in TOOLS:
        res = tool_res[name]
        if len(res) != n or not all(np.isfinite(r["ms"]) and r["ms"] > 0
                                    for r in res):
            fail("tools: %s printed %d cases of %d" % (name, len(res), n))
    if min(tool_launches.values()) < 1 or VL.LAUNCHES < 1 or tool_plain:
        fail("tools: a flag set of kernel F or kernel A never launched, or "
             "%d plain-version calls" % tool_plain)
    probe_base = tool_res["probe"][0]
    bisect_full = tool_res["bisect"][0]
    if probe_base["case"] != "base TD=16" or bisect_full["case"] != "full":
        fail("tools: unexpected first cases %s, %s"
             % (probe_base["case"], bisect_full["case"]))

    # ---- timing on each path's own inputs ----
    # The bounds count only what the function needs for this run's data:
    # the cells it must fill (in the matrix, in the band, in the window),
    # each job's inputs read once and its outputs written once; padding
    # rows, columns and lanes are not counted.
    def fanin_bound(kw):
        """Kernel B: per needed cell its 4-B code written and ~2 f32
        operations for each of its 3 (kl + kr + kl kr) candidates (kl,
        kr its row's and column's fan-in); M/X/Y of the needed cells on
        the last G diagonals (the corner snapshot); per job its L rows,
        R columns and D diagonals of inputs, its table and scalars."""
        W, G = kw["W"], kw["G"]
        h = {k: t.cpu().numpy() for k, t in kw.items()
             if isinstance(t, torch.Tensor)}
        KL, KR = h["loff"].shape[2], h["roff"].shape[2]
        nf = h["table"].shape[1]
        nbytes = ops = 0.0
        for b in range(h["ilo"].shape[0]):
            L, R = (int(v) for v in h["iscal"][b])
            D = L + R - 1
            # rows and columns of the window's lanes, as fanin_fill_plain
            rows = h["ilo"][b, :D, None].astype(np.int64) + np.arange(W)
            cols = np.arange(D)[:, None] - rows
            ri, cj = np.clip(rows, 0, L - 1), np.clip(cols, 0, R - 1)
            need = ((rows < L) & (cols >= 0) & (cols < R)
                    & (cols >= h["bup"][b, ri]) & (cols <= h["blo"][b, ri]))
            kl = (h["loff"][b, :L] > 0).sum(-1).astype(np.float64)[ri[need]]
            kr = (h["roff"][b, :R] > 0).sum(-1).astype(np.float64)[cj[need]]
            ops += 2 * 3 * float((kl + kr + kl * kr).sum())
            nbytes += (4 * float(need.sum())
                       + 3 * 4 * float(need[max(D - G, 0):].sum())
                       + L * (3 * 4 * KL + 4 * 4) + R * (3 * 4 * KR + 2 * 4)
                       + 4 * D + 4 * nf * nf + 4 * 4)
        return nbytes, ops

    def banded_bound(kw):
        """Kernel C: per in-band cell its folded score read (4 B) and its
        code written (1 B); per diagonal its window start and width (8 B:
        the source offsets follow from the starts, the rest of a
        schedule row is padding); fscal, iscal and the corner."""
        cells = float(kw["sched"][:, 1].sum())
        nbytes = 5 * cells + 8 * kw["sched"].shape[0] + 2 * 8 * 4 + 3 * 4
        return nbytes, LINEAR_OPS_PER_CELL * cells

    def shape(kw, ms=None, name=None):
        """A recorded call's shape as text (kernels B and E with their
        launch plans and, given ms, the time per diagonal; `name`: the
        wrapper, which tells D's and E's linear calls apart)."""
        if "ms2" in kw or "msp" in kw:
            t = kw["ms2"] if "ms2" in kw else kw["msp"]
            slots = [kw[k].shape[2] for k in ("loff", "roff", "lfoff",
                                              "rfoff") if k in kw]
            return "B, D, Lp = %s%s%s%s" % (
                tuple(t.shape), ", K %d/%d, G %d" % (slots[0], slots[1],
                                                     kw["G"])
                if "G" in kw else "",
                "; " + plan_text(FF, name, kw) if name and
                plan_text(FF, name, kw) else "",
                "" if ms is None else ", %.3f us per diagonal"
                % (1e3 * ms / t.shape[1]))
        if "sched" in kw:
            return "D-1, Wk = %s, w.max() %d; %s%s" % (
                tuple(kw["ms"].shape), int(kw["sched"][:, 1].max()),
                banded_plan_text(VB, kw), "" if ms is None else
                ", %.3f us per diagonal" % (1e3 * ms / kw["ms"].shape[0]))
        if "ms" in kw:
            return "B, D, Lp = %s; %s%s" % (
                tuple(kw["ms"].shape),
                linear_plan_text(VL, kw["ms"].shape[2], call_pair_end(kw)),
                "" if ms is None
                else ", %.3f us per diagonal" % (1e3 * ms / kw["ms"].shape[1]))
        B, D = kw["ilo"].shape
        return "B %d, D %d, W %d, G %d, %s%s" % (
            B, D, kw["W"], kw["G"], fanin_launch(kw),
            "" if ms is None else ", %.3f us per diagonal" % (1e3 * ms / D))

    # kernel B on the main path's calls and on the full-width calls of
    # the --full-probability run: every call timed; the first call of
    # each build (templated fan-in, ring placement, rows a thread) held
    # bit-equal to its plain version, timed with it and given its bound
    # (the others repeat a build at another width or batch: 5 of the
    # main path's 7 calls held, 1 of the --full-probability run's 3;
    # every call was held until the mesh, multiprocess and shardband
    # phases came, ~40 s of plain versions on a fast host)
    def first_of_build(calls):
        seen, first = set(), []
        for kw in calls:
            p = VF.call_plan(kw)
            key = (p["KL"], p["KR"], p["placement"], p["rows"])
            if key not in seen:
                seen.add(key)
                first.append(kw)
        return first

    def first_of_shape(calls):
        """The calls that open a launch plan and a (D, Lp) shape: the
        others repeat one of them on other jobs."""
        seen, first = set(), []
        for kw in calls:
            key = (fanin_plan_text(FF, kw), tuple(kw["msp"].shape[1:]))
            if key not in seen:
                seen.add(key)
                first.append(kw)
        return first

    def build_of(name, kw):
        if name == "linear":
            p = VL.linear_plan(kw["ms"].shape[2], call_pair_end(kw))
            return "tiled build" if p["diagonals"] == "tiles" else \
                "%d rows a thread" % p["rows"]
        if name == "banded":
            return VB.banded_plan(kw["ms"].shape[1])["build"]
        p = VF.call_plan(kw)
        return "%s, ring %s" % (p["build"], p["placement"])

    def build_key(name, kw):
        """The build a call launches, as kernel B's holds above count
        builds (A: rows a thread; C: its build)."""
        if name == "fanin":
            p = VF.call_plan(kw)
            return (p["KL"], p["KR"], p["placement"], p["rows"])
        return build_of(name, kw)

    fan_held = first_of_build(recorded["fanin"])
    fan_fp_held = first_of_build(rec_fp["fanin"])
    # kernel B's group build (fan-ins past 4 x 4) on pileup_path's
    # calls: the first and the one of the largest K x G held
    pile = rec_pile["fanin"]
    if any(VF.call_plan(kw)["build"] != "groups" for kw in pile):
        fail("timing: a pileup_path call is not on B's group build")
    big = max(range(len(pile)), key=lambda n: pile[n]["loff"].shape[2]
              * pile[n]["roff"].shape[2] * pile[n]["G"])
    pile_held = [pile[0]] + ([pile[big]] if big else [])
    # the linear calls of the --full-probability run held on every call;
    # the fan-in calls (the run's three repeat one plan and (D, Lp) on 4,
    # 2 and 1 jobs) held on the first of each plan and (D, Lp) and timed
    # on every call. kernel_fullprob holds every plan of D and E; the
    # kernels line's ms, plain_ms and bound_ms are means over the held
    # calls, its us per diagonal over every call.
    fp_held = {k: first_of_shape(rec_fp[k]) if k.endswith("_fanin")
               else rec_fp[k] for k in FP_KEYS}
    # builds already held bit-equal on the main, --full-probability and
    # long paths: placement's calls hold only the others
    held_keys = {
        "linear": {build_key("linear", kw) for kw in
                   recorded["linear"] + rec_fp["linear"]},
        "fanin": {build_key("fanin", kw) for kw in fan_held + fan_fp_held},
        "banded": {build_key("banded", kw) for kw in
                   rec_long["banded"] + rec_mega["banded"]}}
    place_held = {}
    for name in ("linear", "fanin", "banded"):
        first = {}
        for kw in rec_place[name]:
            if build_key(name, kw) not in held_keys[name]:
                first.setdefault(build_key(name, kw), kw)
        place_held[name] = list(first.values())
    # kernel C on the megabase call cut to its first NPRE diagonals (the
    # fill is causal, so the prefix is the same work at the same width;
    # the corner moves to the prefix's last in-window cell)
    mkw = rec_mega["banded"][0]
    NPRE = 16384
    pre = {"fscal": mkw["fscal"], "sched": mkw["sched"][:NPRE],
           "ms": mkw["ms"][:NPRE], "iscal": mkw["iscal"].clone()}
    pre["iscal"][4] = NPRE
    pre["iscal"][5] = pre["sched"][-1, 1] - 1
    holds = ([(plain["linear"], kw)
              for kw in recorded["linear"] + rec_fp["linear"]
              + place_held["linear"]]
             + [(plain["fanin"], kw) for kw in fan_held + fan_fp_held
                + pile_held + place_held["fanin"]]
             + [(plain[k], kw) for k in FP_KEYS for kw in fp_held[k]]
             + [(plain[k], rec_lp[k][0]) for k in ("fp_fwd", "fp_bwd")]
             + [(plain["banded"], kw) for kw in rec_long["banded"] + [pre]
                + place_held["banded"]])
    # their plain versions first, side by side; the kernels are launched
    # and timed after the last of them ended
    t = time.time()
    plains = hold_plain(holds)
    log("timing: the plain versions of the %d held calls in %.1f s, %d "
        "processes" % (len(holds), time.time() - t, HOLD_WORKERS))

    def time_kernel(calls, real, bound, same, reps):
        """Per-launch means over a path's recorded calls: kernel ms,
        plain ms, bound ms and what bounds it, then the error, the
        bound's two times and each call's kernel ms. Every call is held
        bit-equal to the plain version (its outputs and ms from
        hold_plain) and gives the plain mean."""
        k_ms = p_ms = b_ms = err = by_bytes = by_ops = 0.0
        per_call = []
        for n, kw in enumerate(calls):
            path, p = plains[real.__name__ + "_plain", id(kw)]
            dev = next(v for v in kw.values()
                       if isinstance(v, torch.Tensor)).device
            ref = [v.to(dev) for v in torch.load(path)]
            os.remove(path)
            out = real(**kw)
            torch.cuda.synchronize()
            if not (torch.equal(out[0], ref[0]) and same(out[1], ref[1])):
                fail("timing: recorded call %d of %s differs from its "
                     "plain version" % (n, real.__name__))
            err = max(err, max_abs_err(out[1], ref[1]))
            del out, ref
            p_ms += p
            k = cuda_ms(lambda: real(**kw), reps)
            per_call.append(k)
            nbytes, ops = bound(kw)
            tb, to = nbytes / HBM_BYTES_PER_S, ops / F32_OPS_PER_S
            log("timing %s call %d (%s): kernel %.3f ms, plain %.1f ms, "
                "bound %.5f ms (%.0f bytes, %.0f operations)"
                % (real.__name__, n, shape(kw, k, real.__name__), k, p,
                   1e3 * max(tb, to), nbytes, ops))
            k_ms, b_ms = k_ms + k, b_ms + 1e3 * max(tb, to)
            by_bytes, by_ops = by_bytes + tb, by_ops + to
        n = len(calls)
        return (k_ms / n, p_ms / n, b_ms / n,
                "bytes" if by_bytes >= by_ops else "operations", err,
                by_bytes, by_ops, per_call)

    lin_t = time_kernel(recorded["linear"], VL.linear_fill, linear_bound,
                        same_floats, 5)
    log("timing linear_fill: kernel A's ordinary build on the main path's "
        "call takes %.3f ms a launch (1.614 ms before the pair-end build "
        "existed, on an NVIDIA H100 80GB HBM3 at 700.00 W)" % lin_t[0])
    fan_t = time_kernel(fan_held, VF.fanin_fill, fanin_bound, same_floats,
                        3)
    fan_ms = [cuda_ms(lambda kw=kw: VF.fanin_fill(**kw), 3)
              for kw in recorded["fanin"]]
    fan_fp_t = time_kernel(fan_fp_held, VF.fanin_fill, fanin_bound,
                           same_floats, 3)
    fan_fp_ms = [cuda_ms(lambda kw=kw: VF.fanin_fill(**kw), 3)
                 for kw in rec_fp["fanin"]]
    # kernel A also on the call of the --full-probability run, held
    # bit-equal to its plain version
    lin_fp_t = time_kernel(rec_fp["linear"], VL.linear_fill, linear_bound,
                           same_floats, 5)
    log("timing linear_fill: the %d call(s) of the fullprob_path run take "
        "%.3f ms a launch, bit-equal" % (len(rec_fp["linear"]),
                                         lin_fp_t[0]))
    # kernel A's tiled build on mito_path's call (16,570 x 16,570 cells),
    # held bit-equal to its plain version there, which was timed in the
    # forced-plain run
    tiles_k_ms = cuda_ms(lambda: VL.linear_fill(**mito_kw), 3)
    nbytes, ops = linear_bound(mito_kw)
    tb, to = nbytes / HBM_BYTES_PER_S, ops / F32_OPS_PER_S
    tiles_bound = (1e3 * max(tb, to), "bytes" if tb >= to else "operations")
    B_mt, D_mt, Lp_mt = mito_kw["ms"].shape
    # the whole codes tensor written once, padding included
    tiles_whole_ms = 1e3 * B_mt * D_mt * Lp_mt / HBM_BYTES_PER_S
    log("timing linear_fill: the tiled build on mito_path's call takes "
        "%.3f ms (%.4f us per diagonal), plain %.1f ms, bound %.5f ms (%s: "
        "%.0f bytes, %.0f operations; %.3f ms to write the whole codes "
        "tensor), bit-equal"
        % (tiles_k_ms, 1e3 * tiles_k_ms / D_mt, tiles_plain_ms,
           tiles_bound[0], tiles_bound[1], nbytes, ops, tiles_whole_ms))
    lin_err = max(lin_err, lin_t[4], lin_fp_t[4])
    fan_err = max(fan_err, fan_t[4], fan_fp_t[4])
    log("timing fanin_fill: the %d full-width calls of the fullprob_path "
        "run take %.3f ms together; %d held bit-equal"
        % (len(fan_fp_ms), sum(fan_fp_ms), len(fan_fp_t[7])))
    log("timing linear: kernel %.3f ms/launch over %d main-path calls, "
        "plain %.1f ms (every call), bound %.5f ms (%s), bit-equal"
        % (lin_t[0], len(recorded["linear"]), lin_t[1], lin_t[2],
           lin_t[3]))
    log("timing fanin: kernel %.3f ms/launch over the %d main-path calls; "
        "on the %d held (one a build): kernel %.3f ms, plain %.1f ms, "
        "bound %.5f ms (%s), bit-equal"
        % (sum(fan_ms) / len(fan_ms), len(fan_ms), len(fan_t[7]),
           fan_t[0], fan_t[1], fan_t[2], fan_t[3]))
    # kernel B's group build on pileup_path's calls: every call timed;
    # the two held timed with their plain versions and given their
    # bound; pileup454_path's calls of the group build timed
    grp_t = time_kernel(pile_held, VF.fanin_fill, fanin_bound, same_floats,
                        3)
    grp_ms = [cuda_ms(lambda kw=kw: VF.fanin_fill(**kw), 3) for kw in pile]
    grp_us = 1e3 * sum(grp_ms) / sum(kw["ilo"].shape[1] for kw in pile)
    g454 = [kw for kw in rec_454["fanin"]
            if VF.call_plan(kw)["build"] == "groups"]
    g454_ms = [cuda_ms(lambda kw=kw: VF.fanin_fill(**kw), 3) for kw in g454]
    g454_us = 1e3 * sum(g454_ms) / max(1, sum(kw["ilo"].shape[1]
                                                for kw in g454))
    log("timing fanin_fill's group build: pileup_path's %d calls %.3f ms "
        "a launch (%.4f us per diagonal), calls 0 and %d held bit-equal "
        "(kernel %.3f ms, plain %.1f ms, bound %.5f ms, %s); "
        "pileup454_path's %d group-build calls %.3f ms a launch (%.4f us "
        "per diagonal)" % (len(pile), sum(grp_ms) / len(pile), grp_us, big,
                           grp_t[0], grp_t[1], grp_t[2], grp_t[3],
                           len(g454), sum(g454_ms) / max(1, len(g454)),
                           g454_us))

    # kernels D and E on the calls the --full-probability run made:
    # each entry point timed on its own calls (planes bit-equal, cum
    # within D * eps * max(1, |cum|)); a kernel's line takes the mean
    # over all its launches, linear and fan-in
    def cum_close(a, b):
        return float((a - b).abs().max()) <= \
            a.shape[1] * EPS32 * max(1.0, float(b.abs().max()))

    fp_t, fp_ms = {}, {}
    for k in FP_KEYS:
        m, n = KERNELS[k]
        held = fp_held[k]
        fp_t[k] = time_kernel(held, getattr(m, n), fullprob_bound,
                              cum_close, 3)
        fp_ms[k] = [cuda_ms(lambda kw=kw: getattr(m, n)(**kw), 3)
                    for kw in rec_fp[k]]
        log("timing %s: kernel %.3f ms/launch over %d fullprob_path calls; "
            "on the %d held: kernel %.3f ms, plain %.1f ms, bound %.5f ms "
            "(%s), planes bit-equal, cum max |err| %g"
            % (n, sum(fp_ms[k]) / len(fp_ms[k]), len(rec_fp[k]), len(held),
               fp_t[k][0], fp_t[k][1], fp_t[k][2], fp_t[k][3], fp_t[k][4]))

    # kernels D's and E's cluster build on fullprob_long_path's
    # --full-probability call (the 5,000 bp pair): held against its plain
    # version on the same inputs (planes bit-equal, cum within D * eps *
    # max(1, |cum|); the plain version takes about 10 s a direction
    # here) and timed, for the kernels line's cluster entries;
    # kernel_fullprob held both sizes the plan picks and timed the
    # 4,300 x 400 call and the 16,569 bp pair
    cl_path = {}
    for direction in ("fwd", "bwd"):
        k = "fp_" + direction
        m, n = KERNELS[k]
        kw = rec_lp[k][0]
        cl_path[direction] = time_kernel([kw], getattr(m, n), fullprob_bound,
                                         cum_close, 3)
        cl_err[direction] = max(cl_err[direction], cl_path[direction][4])
        log("timing %s's cluster build on fullprob_long_path's call (B, D, "
            "Lp = %s; %s): %.3f ms (%.4f us per diagonal), plain %.1f ms, "
            "planes bit-equal, cum max |err| %g"
            % (n, tuple(kw["ms2"].shape), plan_text(FF, n, kw),
               cl_path[direction][0],
               1e3 * cl_path[direction][0] / kw["ms2"].shape[1],
               cl_path[direction][1], cl_path[direction][4]))

    # kernels A, B and C on run (a)'s calls of placement_path: every call
    # timed on the kernel; the first call of each build not held above
    # held bit-equal to the plain version, timed with it and given its
    # bound (the plain versions take 3-7 s a call at this width, and run
    # (a) makes hundreds of calls)
    place_t = {}
    for name, bound in (("linear", linear_bound), ("fanin", fanin_bound),
                        ("banded", banded_bound)):
        calls = rec_place[name]
        if not calls:
            continue
        first = place_held[name]
        ms = [cuda_ms(lambda kw=kw: real[name](**kw), 1) for kw in calls]
        place_t[name] = {
            "calls": len(calls), "ms_all_calls": sum(ms) / len(calls),
            "builds": sorted({build_of(name, kw) for kw in calls}),
            "builds_held_here": len(first)}
        if first:
            held = time_kernel(first, real[name], bound, same_floats, 3)
            place_t[name].update(ms=held[0], plain_ms=held[1],
                                 bound_ms=held[2], bound_by=held[3],
                                 max_abs_err=held[4])
        log("timing %s on placement_path run (a): kernel %.3f ms/launch "
            "over its %d calls (builds %s); %d build(s) not held above "
            "held bit-equal here" % (name, place_t[name]["ms_all_calls"],
                                     len(calls),
                                     "; ".join(place_t[name]["builds"]),
                                     len(first)))
    lin_err = max(lin_err, place_t.get("linear", {}).get("max_abs_err", 0))
    fan_err = max(fan_err, place_t.get("fanin", {}).get("max_abs_err", 0))
    ban_err = max(ban_err, place_t.get("banded", {}).get("max_abs_err", 0))

    def by_path(*keys):
        """Launches of the wrappers `keys` on each path's run."""
        return {path: sum(c.get(k, 0) for k in keys)
                for path, c in path_launches.items()}

    def kernel_entry(name, source, replaces, direction):
        """The kernels-line entry of D or E: per-launch means over its
        held linear and fan-in calls on the fullprob_path run."""
        keys = ["fp_" + direction, "fp_%s_fanin" % direction]
        n = {k: len(fp_t[k][7]) for k in keys}
        tot = sum(n.values())

        def mean(col):
            return sum(fp_t[k][col] * n[k] for k in keys) / tot
        by_bytes = sum(fp_t[k][5] for k in keys)
        by_ops = sum(fp_t[k][6] for k in keys)
        entry = {"name": name, "route": "cuda", "source": source,
                 "replaces": replaces,
                 "launches": sum(counts_fp[k] for k in keys)
                 - counts_fp["fp_%s_cluster" % direction],
                 "max_abs_err": max([fp_err[direction]]
                                    + [fp_t[k][4] for k in keys]),
                 "ms": mean(0), "plain_ms": mean(1), "bound_ms": mean(2),
                 "bound_by": "bytes" if by_bytes >= by_ops
                 else "operations", "library_ms": None,
                 "linear_ms": fp_t[keys[0]][0],
                 "fanin_ms": fp_t[keys[1]][0],
                 "calls_held": n,
                 "builds": "the lane builds and the fan-in builds; the "
                           "linear cluster build's launches are under "
                           "%s_cluster" % name,
                 "launches_by_path": {
                     path: sum(c.get(k, 0) for k in keys)
                     - c.get("fp_%s_cluster" % direction, 0)
                     for path, c in path_launches.items()}}
        entry["linear_plans"] = [plan_text(FF, keys[0].replace(
            "fp_", "fullprob_"), kw) for kw in rec_fp[keys[0]]]
        entry["linear_us_per_diagonal"] = [
            1e3 * ms / kw["ms2"].shape[1]
            for ms, kw in zip(fp_ms[keys[0]], rec_fp[keys[0]])]
        entry["fanin_plans"] = [fanin_plan_text(FF, kw)
                                for kw in rec_fp[keys[1]]]
        entry["fanin_us_per_diagonal"] = [
            1e3 * ms / kw["msp"].shape[1]
            for ms, kw in zip(fp_ms[keys[1]], rec_fp[keys[1]])]
        return entry

    # kernel C: bit-equal to its plain version on the long_family calls
    # and on the megabase call cut to its first NPRE diagonals (the fill
    # is causal, so the prefix is the same work at the same width; the
    # corner moves to the prefix's last in-window cell); the kernel line
    # takes kernel, plain and bound on that prefix. The whole megabase
    # call is timed on the kernel alone (its plain version would take
    # about half an hour).
    long_t = time_kernel(rec_long["banded"], VB.banded_fill, banded_bound,
                         same_floats, 3)
    ban_err = max(ban_err, long_t[4])
    log("timing banded: on the %d long_family calls kernel %.3f ms/launch, "
        "plain %.1f ms, bound %.5f ms (%s), bit-equal"
        % (len(rec_long["banded"]), long_t[0], long_t[1], long_t[2],
           long_t[3]))
    ban_t = time_kernel([pre], VB.banded_fill, banded_bound, same_floats, 5)
    ban_err = max(ban_err, ban_t[4])
    log("timing banded: on the megabase call's first %d diagonals kernel "
        "%.3f ms (%.3f us per diagonal), plain %.1f ms, bound %.5f ms "
        "(%s), bit-equal" % (NPRE, ban_t[0], 1e3 * ban_t[0] / NPRE,
                             ban_t[1], ban_t[2], ban_t[3]))
    mega_ms = cuda_ms(lambda: VB.banded_fill(**mkw), 2)
    nbytes, ops = banded_bound(mkw)
    tbb, tbo = nbytes / HBM_BYTES_PER_S, ops / F32_OPS_PER_S
    mega_bound = 1e3 * max(tbb, tbo)
    mega_by = "bytes" if tbb >= tbo else "operations"
    log("timing banded: on the whole megabase call (%s) kernel %.3f "
        "ms/launch (%.3f us per diagonal), bound %.5f ms (%s: %.0f bytes, "
        "%.0f operations)" % (shape(mkw), mega_ms,
                              1e3 * mega_ms / mkw["ms"].shape[0],
                              mega_bound, mega_by, nbytes, ops))

    # kernels G and H on one launch each kept from the middle of a fill
    # (a shard past the first, the block's carry as it was, a tile range
    # of the launch plan, so a live call). The fill is a re-run at the
    # shapes of shardband_path's pairs, not the CLI's own call: G's on
    # kernel_shardband's gate prep, H's on a prepare_fanin of the 454
    # pair, both with this script's model (the CLI's model takes the
    # data's base frequencies). The kernel and the plain version run on
    # copies of the kept call, every output bit-equal, then the kernel
    # is timed alone
    class SbKept(Exception):
        pass

    def sb_kept(k, run):
        """The first launch of a shard past the first from the middle of
        the fill `run(block)` (every launch through `block`), its
        carries copied; the fill stops there."""
        kept = {}

        def block(**kw):
            if kw["base"] > 0 and kw["d0"] >= (kw["L"] + kw["R"]) // 2:
                kept.update({n: v.clone() if n in ("cin", "cout", "corner",
                                                   "snap") else v
                             for n, v in kw.items() if n != "codes"})
                raise SbKept
            return real[k](**kw)
        try:
            run(block)
        except SbKept:
            pass
        if not kept:
            fail("timing: no launch of %s kept" % k)
        return kept
    inp454 = VF.prepare_fanin(
        build_leaf_graph("".join(gate_base[:8191]), alph.DNA, mode454=True),
        build_leaf_graph(read454[:1023], alph.DNA, mode454=True), model,
        settings, np.float32)
    olm454 = max(inp454["OL"], 1)
    g454 = SB._g_bucket(olm454 + max(inp454["OR"], 1))
    h454 = SB.fanin_halo(SB.HALO, g454, SB._lane_split(inp454["L"], 4))
    s454, m454 = SB.shardband_fanin_args(inp454, 4, H=h454)
    sb_keep = {
        "sb_linear": sb_kept("sb_linear", lambda block: SB.shardband_fill(
            JobsMesh([dev] * 4), gshards, gmeta, block=block)),
        "sb_fanin": sb_kept("sb_fanin",
                            lambda block: SB.shardband_fanin_fill(
                                JobsMesh([dev] * 4), s454, m454, g454,
                                max(1, h454 // olm454), block=block))}
    del s454

    def sb_plan(k, kw):
        return SB.linear_block_plan(kw["H"]) if k == "sb_linear" else \
            SB.fanin_block_plan(kw["H"], kw["cin"].shape[1])

    def sb_bound(k, kw):
        """Kernels G and H: per cell of the block that lies in the matrix
        (and band) on the shard's owned lanes, its code written (1 B,
        H: 4 B) and, for G, its match score read (4 B; H looks its score
        up in the nf x nf table); the carry read and written (G: six
        vectors, H: three rings of G diagonals); the owned lanes'
        vectors and the columns the block touches; G: LINEAR_OPS_PER_CELL
        operations a cell, H: 2 for each of its 3 (kl + kr + kl kr)
        candidates."""
        H, base, d0, n = kw["H"], kw["base"], kw["d0"], kw["nsteps"]
        wloc = kw["cin"].shape[-1]
        tt = sb_plan(k, kw)["tile"]
        t0_, t1_ = kw["tiles"]
        li = np.arange(H + t0_ * tt, min(H + (t1_ + 1) * tt, wloc))
        ii = base + li
        d = np.arange(d0, d0 + n)[:, None]
        j = d - ii[None, :]
        vlo = kw["vlo"].cpu().numpy()[li]
        vhi = kw["vhi"].cpu().numpy()[li]
        cell = (j >= 0) & (j < kw["R"]) & (ii < kw["L"]) & (j >= vlo) & \
            (j <= vhi)
        cells = float(cell.sum())
        ncols = len(np.unique(j[cell])) if cells else 0
        lanes = len(li)
        if k == "sb_linear":
            nbytes = 5 * cells + 2 * 6 * 4 * lanes + 4 * 4 * lanes + \
                2 * 4 * ncols + 3 * 4
            return nbytes, LINEAR_OPS_PER_CELL * cells
        G = kw["cin"].shape[1]
        KL, KR = kw["loff"].shape[1], kw["roff"].shape[1]
        rows, cols = np.nonzero(cell)
        kl = (kw["loff"].cpu().numpy()[li[cols]] > 0).sum(-1)
        kr = (kw["roff"].cpu().numpy()[np.clip(j[rows, cols], 0,
                                               kw["R"] - 1)] > 0).sum(-1)
        ops = 2 * 3 * float((kl + kr + kl * kr).sum())
        nf = kw["table"].shape[0]
        nbytes = 4 * cells + 2 * 3 * G * 4 * lanes + \
            lanes * (3 * 4 * KL + 4 * 4) + ncols * (3 * 4 * KR + 2 * 4) \
            + 4 * nf * nf
        return nbytes, ops

    sb_t = {}
    for k, dt, out_key in (("sb_linear", torch.uint8, "corner"),
                           ("sb_fanin", torch.int32, "snap")):
        kw = sb_keep[k]
        d0, rows = kw["d0"], kw["d0"] + kw["nsteps"]
        w = kw["cin"].shape[-1] - kw["H"]

        def copy():
            return dict(kw, cout=kw["cout"].clone(),
                        codes=torch.zeros((rows, w), dtype=dt, device=dev),
                        **{out_key: kw[out_key].clone()})
        kk, pp = copy(), copy()
        t0 = torch.cuda.Event(enable_timing=True)
        t1 = torch.cuda.Event(enable_timing=True)
        t0.record()
        plain[k](**pp)
        t1.record()
        real[k](**kk)
        torch.cuda.synchronize()
        if not (same_floats(kk["cout"], pp["cout"])
                and torch.equal(kk["codes"][d0:], pp["codes"][d0:])
                and same_floats(kk[out_key], pp[out_key])):
            fail("timing: kernel %s's kept call differs from its plain "
                 "version" % k)
        err = max_abs_err(kk["cout"], pp["cout"])
        k_ms = cuda_ms(lambda: real[k](**kk), 20)
        nbytes, ops = sb_bound(k, kw)
        tb, to = nbytes / HBM_BYTES_PER_S, ops / F32_OPS_PER_S
        plan = dict(sb_plan(k, kw), tiles=list(kw["tiles"]))
        sb_t[k] = dict(ms=k_ms, plain_ms=t0.elapsed_time(t1),
                       bound_ms=1e3 * max(tb, to),
                       bound_by="bytes" if tb >= to else "operations",
                       err=err, plan=plan, d0=d0, nsteps=kw["nsteps"],
                       lanes=w)
        log("timing %s: one block (diagonals %d-%d, tiles of a shard of %d "
            "owned lanes, H %d, plan %s): kernel %.4f ms (%.3f us per "
            "diagonal), plain %.1f "
            "ms, bound %.6f ms (%s: %.0f bytes, %.0f operations), "
            "bit-equal" % (k, d0, rows - 1, w, kw["H"], json.dumps(plan),
                           k_ms, 1e3 * k_ms / kw["nsteps"],
                           sb_t[k]["plain_ms"], sb_t[k]["bound_ms"],
                           sb_t[k]["bound_by"], nbytes, ops))

    # ---- trace: device busy share of the main path and of the
    # --full-probability path ----
    from torch.profiler import profile, ProfilerActivity

    def dev_us(e):
        return getattr(e, "self_device_time_total",
                       getattr(e, "self_cuda_time_total", 0.0))

    for what, inputs, extra, want in (
            ("main path", (fas, nh), [], a),
            ("fullprob path", (fas, nh), ["--full-probability"],
             open(out_fp + ".fas", "rb").read()),
            ("pileup path", (fas40, None),
             ["--homopolymer", "--output-consensus"],
             open(out_pile + ".fas", "rb").read())):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            wall_trace = run_cli("trace", *inputs,
                                 os.path.join(work, "out_trace"), real,
                                 extra)[0]
        if open(os.path.join(work, "out_trace.fas"), "rb").read() != want:
            fail("trace: the traced %s run gave other FASTA" % what)
        # device-side activities only (kernels, copies, sets): the host
        # ops that issued them carry the same time again
        events = [e for e in prof.key_averages()
                  if getattr(e, "device_type", None) ==
                  torch.autograd.DeviceType.CUDA and dev_us(e) > 0
                  and not e.key.startswith("Activity Buffer")]
        busy_ms = sum(dev_us(e) for e in events) / 1e3
        if busy_ms > 0:
            log("trace: %s %.3f s wall, device busy %.1f ms (%.1f%%)"
                % (what, wall_trace, busy_ms,
                   100 * busy_ms / (1e3 * wall_trace)))
            for e in sorted(events, key=dev_us, reverse=True)[:8]:
                log("trace:   %10.3f ms  %6d calls  %s"
                    % (dev_us(e) / 1e3, e.count, e.key[:90]))
            fan = [e for e in events if "viterbi_fanin" in e.key]
            log("trace: %s kernel B %.3f ms of device time over %d "
                "launches (group build %.3f ms)"
                % (what, sum(dev_us(e) for e in fan) / 1e3,
                   sum(e.count for e in fan),
                   sum(dev_us(e) for e in fan if "groups" in e.key) / 1e3))
        else:
            log("trace: the profiler recorded no device time for the %s "
                "(busy share not measured)" % what)

    def cluster_entry(direction, source, replaces):
        """The kernels-line entry of D's or E's linear cluster build:
        held against its plain version and timed with it on
        fullprob_long_path's call (the timing phase); held at both sizes
        the plan picks and timed on the 4,300 x 400 call in
        kernel_fullprob; timed on the 16,569 bp pair."""
        t = cl_path[direction]
        kw = rec_lp["fp_" + direction][0]
        name = "fullprob_" + direction
        return {
            "name": name + "_cluster", "route": "cuda",
            "source": source, "replaces": replaces,
            "launches": path_launches["fullprob_long_full_probability"][
                "fp_%s_cluster" % direction],
            "max_abs_err": cl_err[direction],
            "ms": t[0], "plain_ms": t[1], "bound_ms": t[2],
            "bound_by": t[3], "library_ms": None,
            "timed_on": "fullprob_long_path's --full-probability call, B, "
                        "D, Lp = %d, %d, %d" % tuple(kw["ms2"].shape),
            "plan": plan_text(FF, name, kw),
            "us_per_diagonal": 1e3 * t[0] / kw["ms2"].shape[1],
            "cluster_sizes_held": sorted(cl_sizes[direction]),
            "call_4300x400": cl_t[direction],
            "pair_16569": cl_giant[direction],
            "pair_16569_log_fwd_minus_log_bwd": cl_giant["dlog"],
            "launches_by_path": by_path("fp_%s_cluster" % direction)}

    kernels_line = {"kernels": [
        {"name": "viterbi_linear", "route": "cuda",
         "source": "pagan2_tpu_torch/csrc/viterbi_linear.cu",
         "replaces": "pagan2_tpu/align/viterbi_pallas.py:58",
         "launches": counts["linear"] - counts["linear_tiles"],
         "max_abs_err": lin_err,
         "ms": lin_t[0], "plain_ms": lin_t[1], "bound_ms": lin_t[2],
         "bound_by": lin_t[3], "library_ms": None,
         "plans": [linear_plan_text(VL, kw["ms"].shape[2],
                                    call_pair_end(kw))
                   for kw in recorded["linear"]],
         "us_per_diagonal": [1e3 * ms / kw["ms"].shape[1] for ms, kw in
                             zip(lin_t[7], recorded["linear"])],
         "fullprob_calls_ms": lin_fp_t[7],
         "builds": "the lane builds (1 and 2 rows a thread); the tiled "
                   "build's launches are under viterbi_linear_tiles",
         "launches_by_path": {path: c.get("linear", 0)
                              - c.get("linear_tiles", 0)
                              for path, c in path_launches.items()},
         "placement_path": place_t.get("linear"),
         "pair_end_us_per_diagonal": {
             text: [{"pair_end": a, "ordinary": b} for a, b in v]
             for text, v in pe_us.items()}},
        {"name": "viterbi_linear_tiles", "route": "cuda",
         "source": "pagan2_tpu_torch/csrc/viterbi_linear.cu",
         "replaces": "pagan2_tpu/align/viterbi_pallas.py:58",
         "launches": path_launches["mito_path"]["linear_tiles"],
         "max_abs_err": tiles_err, "ms": tiles_k_ms,
         "plain_ms": tiles_plain_ms, "bound_ms": tiles_bound[0],
         "bound_by": tiles_bound[1], "library_ms": None,
         "timed_on": "mito_path's call, B, D, Lp = %d, %d, %d"
                     % (B_mt, D_mt, Lp_mt),
         "plan": linear_plan_text(VL, Lp_mt),
         "us_per_diagonal": 1e3 * tiles_k_ms / D_mt,
         "bound_whole_codes_ms": tiles_whole_ms,
         "kernel_linear_tiles_ms": tiles_ms,
         "pair_end_gate_ms": gate_a_ms,
         "pair_end_gate_bound_ms": gate_a_bound[0],
         "pair_end_gate_bound_whole_codes_ms": gate_a_bound[1],
         "mito_path_wall_s": wall_mt, "mito_path_phases_s": mito_phases,
         "launches_by_path": by_path("linear_tiles")},
        {"name": "viterbi_fanin", "route": "cuda",
         "source": "pagan2_tpu_torch/csrc/viterbi_fanin.cu",
         "replaces": "pagan2_tpu/align/viterbi_pallas_fanin.py:140",
         "launches": counts["fanin"], "max_abs_err": fan_err,
         "ms": fan_t[0], "plain_ms": fan_t[1], "bound_ms": fan_t[2],
         "bound_by": fan_t[3], "library_ms": None,
         "calls_held": len(fan_t[7]), "ms_every_call": fan_ms,
         "fullprob_calls_ms": fan_fp_ms, "k454_16x2047_ms": fan_454_ms[0],
         "builds": "the templated builds (K up to 4 x 4); the group "
                   "build's launches are under viterbi_fanin_groups",
         "launches_by_path": {path: c.get("fanin", 0)
                              - c.get("fanin_groups", 0)
                              for path, c in path_launches.items()},
         "placement_path": place_t.get("fanin")},
        {"name": "viterbi_fanin_groups", "route": "cuda",
         "source": "pagan2_tpu_torch/csrc/viterbi_fanin.cu",
         "replaces": "pagan2_tpu/align/viterbi_pallas_fanin.py:140",
         "scan_core": "pagan2_tpu/align/viterbi_fanin.py:368",
         "launches": path_launches["pileup_path"]["fanin_groups"],
         "max_abs_err": grp_t[4], "ms": grp_t[0], "plain_ms": grp_t[1],
         "bound_ms": grp_t[2], "bound_by": grp_t[3], "library_ms": None,
         "timed_on": "pileup_path's calls 0 and %d (the first; the "
                     "largest K x G)" % big,
         "plans": [fanin_launch(kw) for kw in (pile[0], pile[big])],
         "us_per_diagonal": [1e3 * ms / kw["ilo"].shape[1] for ms, kw in
                             zip(grp_t[7], (pile[0], pile[big]))],
         "pileup_path_ms_every_call": grp_ms,
         "pileup_path_us_per_diagonal": grp_us,
         "pileup454_path_ms_every_call": g454_ms,
         "pileup454_path_us_per_diagonal": g454_us,
         "launches_by_path": by_path("fanin_groups")},
        {"name": "viterbi_banded", "route": "cuda",
         "source": "pagan2_tpu_torch/csrc/viterbi_banded.cu",
         "replaces": "pagan2_tpu/align/viterbi_pallas_banded.py:79",
         "launches": counts_long["banded"] + counts_mega["banded"],
         "max_abs_err": ban_err, "ms": ban_t[0], "plain_ms": ban_t[1],
         "bound_ms": ban_t[2], "bound_by": ban_t[3], "library_ms": None,
         "timed_on": "megabase call, first %d diagonals" % NPRE,
         "whole_call_ms": mega_ms, "whole_call_bound_ms": mega_bound,
         "plans": [banded_plan_text(VB, kw) for kw in
                   rec_long["banded"] + rec_mega["banded"]],
         "builds_met": ban_builds, "launches_by_path": by_path("banded"),
         "placement_path": place_t.get("banded")},
        kernel_entry("fullprob_fwd",
                     "pagan2_tpu_torch/csrc/fullprob_fwd.cu",
                     "pagan2_tpu/align/fullprob_pallas.py:45", "fwd"),
        kernel_entry("fullprob_bwd",
                     "pagan2_tpu_torch/csrc/fullprob_bwd.cu",
                     "pagan2_tpu/align/fullprob_pallas.py:108", "bwd"),
    ] + [cluster_entry(d, src, rep) for d, src, rep in (
        ("fwd", "pagan2_tpu_torch/csrc/fullprob_fwd.cu",
         "pagan2_tpu/align/fullprob_pallas.py:45"),
        ("bwd", "pagan2_tpu_torch/csrc/fullprob_bwd.cu",
         "pagan2_tpu/align/fullprob_pallas.py:108"))]}
    # kernels G and H: the band-sharded fills, which replace the JAX
    # package's shard_map scans (no Pallas kernel there)
    for name, k, kind, replaces, extra in (
            ("viterbi_shardband_linear", "sb_linear", "linear",
             "pagan2_tpu/align/viterbi_shardband.py:83",
             {"gate_fill_s": gate_g_s, "gate_launches": gate_g_launches,
              "gate_loop_s": gate_stats["loop_s"],
              "gate_gather_s": gate_stats["gather_s"],
              "gate_tiles": gate_stats["tiles"],
              "kernel_a_pair_end_gate_ms": gate_a_ms}),
            ("viterbi_shardband_fanin", "sb_fanin", "fanin",
             "pagan2_tpu/align/viterbi_shardband.py:362", {})):
        t = sb_t[k]
        kernels_line["kernels"].append(dict({
            "name": name, "route": "cuda",
            "source": "pagan2_tpu_torch/csrc/viterbi_shardband.cu",
            "replaces": replaces,
            "launches": path_launches["shardband_" + kind][k],
            "max_abs_err": max(sb_err[kind], t["err"]), "ms": t["ms"],
            "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
            "bound_by": t["bound_by"], "library_ms": None,
            "timed_on": "a re-run fill of %s at shardband_path's "
                        "shapes (this script's model), one launch: "
                        "diagonals %d-%d, tiles %d-%d of a shard of %d "
                        "owned lanes"
                        % ("kernel_shardband's gate prep"
                           if kind == "linear" else "the 454 pair",
                           t["d0"], t["d0"] + t["nsteps"] - 1,
                           t["plan"]["tiles"][0], t["plan"]["tiles"][1],
                           t["lanes"]),
            "plan": t["plan"],
            "path_wall_s": sb_walls["shardband_" + kind][0],
            "path_loop_s": sb_walls["shardband_" + kind][2]["loop_s"],
            "path_gather_s": sb_walls["shardband_" + kind][2]["gather_s"],
            "path_blocks": sb_walls["shardband_" + kind][2]["blocks"],
            "launches_by_path": by_path(k)}, **extra))
    # kernel F: launches in the tools' run, ms and bound of the tools'
    # first case, plain ms on the same inputs in kernel_probe
    for name, tool, res, plain_ms, replaces in (
            ("viterbi_linear_probe", "probe", probe_base, probe_plain_ms,
             "tools/_probe_pallas.py:32"),
            ("viterbi_linear_bisect", "bisect", bisect_full,
             bisect_plain_ms, "tools/_bisect_pallas.py:16")):
        kernels_line["kernels"].append({
            "name": name, "route": "cuda",
            "source": "pagan2_tpu_torch/csrc/viterbi_linear_probe.cu",
            "replaces": replaces,
            "launches": sum(v for k, v in tool_launches.items()
                            if k.startswith(tool + ":")),
            "max_abs_err": probe_err[tool], "ms": res["ms"],
            "plain_ms": plain_ms, "bound_ms": res["bound_ms"],
            "bound_by": res["bound_by"], "library_ms": None,
            "timed_on": "%s tool, %s, B %d, Dpk %d"
            % (tool, res["case"], res["B"], res["Dpk"]),
            "plan": probe_plan_text(VP, res["Lp"])})
    log("total %.1f s" % (time.time() - t_start))
    print(json.dumps(kernels_line))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
