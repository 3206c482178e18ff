"""What the measuring tools share: the JAX tools' pair generator, the
command line, timing and the H100 bound of a case."""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from ..align import AlignSettings
from ..align.viterbi_linear import (_add_scalar_params, batch_rows,
                                    linear_job_arrays)
from ..align.viterbi_sheared import prepare_sheared
from ..device import resolve_device
from ..graph import build_leaf_graph
from ..models import ModelFactory, alphabets as alph

# published H100 SXM peaks (NVIDIA data sheet): device memory rate and
# f32 rate outside the tensor cores
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12
# timed launches per case on a card, after one warm-up
REPS = 10
# f32 compare/add/select operations per cell of the linear step (kernel
# A's count: 10 adds, 6 maxima, 6 code compares, 3 masks)
OPS_PER_CELL = 25


def parser(description: str) -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=description)
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                   help="cuda (default; raises without a card) launches "
                        "the kernels; cpu runs their plain versions")
    p.add_argument("--small", action="store_true",
                   help="a few small cases (for the CPU)")
    return p


def setup(args) -> torch.device:
    """The tool's device, announced on its first line."""
    dev = resolve_device(args.device)
    if dev.type == "cuda":
        print("device: %s, %s" % (dev, torch.cuda.get_device_name(dev)),
              flush=True)
    else:
        print("device: cpu (plain versions; times by the host clock, not "
              "device times)", flush=True)
    return dev


def pair_jobs(B: int, N: int, seed: int = 0):
    """The JAX tools' batch: B pairs of N bp, the second a copy of the
    first with 10% of its sites redrawn, from np.random.default_rng(seed)
    in the tools' order; alignment_model(0.2), f32 prep. Returns the
    prepare_sheared dicts (scalar params added) and the aligned cells
    sum(L * R)."""
    rng = np.random.default_rng(seed)
    model = ModelFactory(alph.DNA).alignment_model(0.2)
    settings = AlignSettings()
    inps = []
    for _ in range(B):
        base = rng.choice(list("ACGT"), size=N)
        mut = base.copy()
        idx = rng.random(N) < 0.1
        mut[idx] = rng.choice(list("ACGT"), size=int(idx.sum()))
        g1 = build_leaf_graph("".join(base), alph.DNA)
        g2 = build_leaf_graph("".join(mut), alph.DNA)
        inps.append(_add_scalar_params(prepare_sheared(
            g1, g2, model, settings, dtype=np.float32)))
    return inps, sum(x["L"] * x["R"] for x in inps)


def job_arrays(inps):
    """linear_job_arrays of a batch, rows padded to the longest left side
    rounded up to a warp (2048 rows at 2047 bp, 4096 at 4095 bp)."""
    Lp = batch_rows(inps)
    return [linear_job_arrays(x, Lp) for x in inps]


def time_ms(fn, dev: torch.device) -> float:
    """Milliseconds per call of fn: CUDA events over REPS calls after
    one warm-up on a card; on the CPU one call by the host clock."""
    if dev.type == "cpu":
        t = time.perf_counter()
        fn()
        return 1e3 * (time.perf_counter() - t)
    fn()
    torch.cuda.synchronize(dev)
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    for _ in range(REPS):
        fn()
    t1.record()
    torch.cuda.synchronize(dev)
    return t0.elapsed_time(t1) / REPS


def step_bound(kw: dict, *, ms_read: bool, codes: bool, corner: bool,
               masks: bool = True, store: bool | None = None):
    """Least H100 time (ms) of one variant on its arguments, and what
    bounds it. Bytes: the match score of every cell the step can accept
    (vlo <= j <= vhi, i > 0, j > 0: elsewhere M is NEG whatever it reads;
    all lanes without masks), 4 B each; the code of every lane of every
    diagonal (an output at each; `store` defaults to `codes`), 1 B; the
    three corner rows; the four row vectors and the two scalar rows
    once. Operations: OPS_PER_CELL
    for every lane of every diagonal, less the 6 code compares without
    codes and the 3 masks without masks."""
    ms = kw["ms"]
    Dpk, B, Lp = ms.shape
    lanes = float(Dpk) * B * Lp
    if ms_read and masks:
        vlo = kw["vlo"].cpu().numpy().astype(np.int64)
        vhi = kw["vhi"].cpu().numpy().astype(np.int64)
        i = np.arange(Lp)[None, :]
        # j = d - i for d in 1..Dpk, i > 0, max(vlo, 1) <= j <= vhi
        lo = np.maximum(np.maximum(vlo, 1), 1 - i)
        hi = np.minimum(vhi, Dpk - i)
        need = np.where(i > 0, np.clip(hi - lo + 1, 0, None), 0)
        ms_cells = float(need.sum())
    else:
        ms_cells = lanes if ms_read else 0.0
    store = codes if store is None else store
    nbytes = (4 * ms_cells + (lanes if store else 0.0)
              + (3 * 4 * B * Lp if corner else 0.0)
              + 4 * 4 * B * Lp + 2 * 8 * 4 * B)
    ops = lanes * (OPS_PER_CELL - (0 if codes else 6) - (0 if masks else 3))
    tb, to = nbytes / HBM_BYTES_PER_S, ops / F32_OPS_PER_S
    return 1e3 * max(tb, to), "bytes" if tb >= to else "operations"


def report(name: str, dev: torch.device, ms: float, diagonals: int,
           cells: float, extra: str = "") -> str:
    """One case line: ms per launch, microseconds per diagonal, GCUPS."""
    clock = "" if dev.type == "cuda" else " (cpu host clock)"
    return ("%-18s %10.3f ms%s  %8.3f us/diag  %8.3f GCUPS%s"
            % (name, ms, clock, 1e3 * ms / diagonals,
               cells / (ms * 1e-3) / 1e9, extra))
