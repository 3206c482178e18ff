"""Bench of kernel A (the linear wavefront) on the JAX tool's batch: B =
8 pairs of 4095 bp (np.random.default_rng(0), 10% substitutions), rows
padded to Lp = 4096 (the top of kernel A's shared-memory path) and the
diagonals to a multiple of TD 16. Prints the host prep time, the first
launch (the kernel's build and load included, when it is not built
yet), then ms per launch (CUDA events) and GCUPS.

    python -m pagan2_tpu_torch.tools.bench_linear [--device cpu --small]
"""
from __future__ import annotations

import time

import torch

from ..align import viterbi_linear as VL
from . import common
from .sweep_linear import padded_args, run_case

TD = 16


def main(argv=None):
    args = common.parser(__doc__.splitlines()[0]).parse_args(argv)
    dev = common.setup(args)
    B, N = (2, 200) if args.small else (8, 4095)
    t = time.perf_counter()
    inps, cells = common.pair_jobs(B, N)
    jobs = common.job_arrays(inps)
    print("prep: %.1f s (host)" % (time.perf_counter() - t), flush=True)
    t = time.perf_counter()
    kw, Dpk = padded_args(jobs, dev, TD)
    _codes, corner = VL.linear_fill(**kw)
    s = float(corner[:, 0].sum())
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    print("first launch: %.1f s (host clock; corner M sum %.1f)"
          % (time.perf_counter() - t, s), flush=True)
    res, line = run_case(kw, Dpk, cells, TD, dev)
    print(line, flush=True)
    return [dict(res, N=N)]


if __name__ == "__main__":
    main()
