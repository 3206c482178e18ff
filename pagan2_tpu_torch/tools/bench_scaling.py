"""Jobs a second unsharded and over a jobs mesh (the port of the JAX
package's tools/bench_scaling.py, same arguments).

Runs the same bucket of N_JOBS independent linear pairs of LEN bp through
the batched executor twice, unsharded and sharded over a mesh, after one
warm-up run of each, and prints

    {"jobs_per_s_1dev": A, "jobs_per_s_mesh": B, "n_shards": N,
     "distinct_devices": K, "efficiency": B / (A * K), "device": ...}

The mesh spans every visible card (make_jobs_mesh); with --shards N it is
N logical shards on the first card instead, and with --coordinator the
global mesh of every process's cards (run one process a rank with the
same arguments). On one card the shards share that card: the number
measures the sharded dispatch's overhead, not scaling, and efficiency is
taken over the distinct devices (1). A CPU run (--device cpu, logical
CPU shards) times the plain versions by the host clock and says nothing
about a device.

    python -m pagan2_tpu_torch.tools.bench_scaling [N_JOBS] [LEN]
    python -m pagan2_tpu_torch.tools.bench_scaling 16 2047 --shards 4
    python -m pagan2_tpu_torch.tools.bench_scaling --device cpu 4 120 \\
        --shards 2
    # one process a rank:
    python -m pagan2_tpu_torch.tools.bench_scaling ... \\
        --coordinator 127.0.0.1:29500 --num-processes 2 --process-id $RANK
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))))


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("n_jobs", nargs="?", type=int, default=16)
    ap.add_argument("length", nargs="?", type=int, default=2047)
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    ap.add_argument("--shards", type=int, default=None,
                    help="logical shards on the first device (default: "
                         "one a visible card)")
    ap.add_argument("--coordinator", default=None)
    ap.add_argument("--num-processes", type=int, default=1)
    ap.add_argument("--process-id", type=int, default=0)
    args = ap.parse_args(argv)

    import torch
    from pagan2_tpu_torch.align import AlignSettings
    from pagan2_tpu_torch.device import resolve_device
    from pagan2_tpu_torch.graph import build_leaf_graph
    from pagan2_tpu_torch.models import ModelFactory, alphabets as alph
    from pagan2_tpu_torch.parallel import executor
    from pagan2_tpu_torch.parallel import multihost

    device = resolve_device(args.device)
    if args.coordinator:
        multihost.init_multihost(args.coordinator, args.num_processes,
                                 args.process_id)
        mesh = multihost.global_jobs_mesh(device)
    elif args.shards:
        mesh = executor.JobsMesh([multihost.local_devices(device)[0]]
                                 * args.shards)
    elif device.type == "cuda":
        mesh = executor.make_jobs_mesh()
    else:
        mesh = executor.JobsMesh([device])
    model = ModelFactory(alph.DNA).alignment_model(0.3)
    rng = np.random.default_rng(0)

    def jobs():
        out = []
        for _t in range(args.n_jobs):
            base = rng.choice(list("ACGT"), size=args.length)
            mut = base.copy()
            idx = rng.random(args.length) < 0.1
            mut[idx] = rng.choice(list("ACGT"), size=int(idx.sum()))
            out.append(executor.PairJob(
                left=build_leaf_graph("".join(base), alph.DNA),
                right=build_leaf_graph("".join(mut), alph.DNA),
                model=model, settings=AlignSettings()))
        return out

    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize()

    def run(m):
        executor.execute_pair_jobs(jobs(), device=device, mesh=m)
        sync()
        t0 = time.perf_counter()
        executor.execute_pair_jobs(jobs(), device=device, mesh=m)
        sync()
        return args.n_jobs / (time.perf_counter() - t0)

    a = run(None)
    b = run(mesh)
    distinct = len({(r, str(d)) for r, d in zip(
        mesh.ranks or [0] * mesh.size, mesh.devices)})
    out = {"jobs_per_s_1dev": a, "jobs_per_s_mesh": b,
           "n_shards": mesh.size, "distinct_devices": distinct,
           "efficiency": b / (a * distinct),
           "device": torch.cuda.get_device_name(0)
           if device.type == "cuda" else "cpu (plain versions)"}
    if args.coordinator:
        multihost.shutdown_multihost()
    print(json.dumps(out))
    return out


if __name__ == "__main__":
    main()
