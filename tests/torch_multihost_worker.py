"""Worker process of test_torch_multihost.py: joins a 2-process gloo
group through the port's parallel/multihost.py, runs one generation of
batched pair jobs over the global jobs mesh (one CPU shard a rank), then
a "giant" linear and fan-in pair band-sharded across the two ranks
(SHARDBAND_MIN_L lowered to their 32 rows: 16 lanes a rank, a halo of
16), and writes the alignment keys for the parent
test to compare. Imports nothing of JAX."""
import json
import os
import sys


def jobs(kind):
    """The parent test's jobs, built with the port's graph builder."""
    import numpy as np
    from pagan2_tpu_torch.align import AlignSettings
    from pagan2_tpu_torch.graph import build_leaf_graph
    from pagan2_tpu_torch.models import ModelFactory, alphabets as alph
    from pagan2_tpu_torch.parallel.executor import PairJob
    rng = np.random.default_rng(42)
    model = ModelFactory(alph.DNA).alignment_model(0.3)
    out = []
    n, size, sites = {"batch": (8, 60, "ACGT"), "linear": (1, 31, "ACGT"),
                      "fanin": (1, 31, "AACCGGTT")}[kind]
    for _t in range(n):
        base = rng.choice(list(sites), size=size)
        mut = base.copy()
        idx = rng.random(size) < 0.15
        mut[idx] = rng.choice(list("ACGT"), size=int(idx.sum()))
        kw = {"mode454": True} if kind == "fanin" else {}
        out.append(PairJob(left=build_leaf_graph("".join(base), alph.DNA,
                                                 **kw),
                           right=build_leaf_graph("".join(mut), alph.DNA,
                                                  **kw),
                           model=model, settings=AlignSettings()))
    return out


def keys(results):
    return [[int(anc.states[i]) for i in range(anc.num_sites())]
            for anc, _e in results]


def main():
    pid, nproc, port, outdir = (int(sys.argv[1]), int(sys.argv[2]),
                                sys.argv[3], sys.argv[4])
    from pagan2_tpu_torch.align import viterbi_shardband as SB
    from pagan2_tpu_torch.parallel import executor
    from pagan2_tpu_torch.parallel.multihost import (
        init_multihost, global_jobs_mesh, shutdown_multihost)
    init_multihost("127.0.0.1:%s" % port, nproc, pid)
    mesh = global_jobs_mesh("cpu")
    out = {"n_shards": mesh.size, "ranks": mesh.ranks}
    executor.reset_stats()
    out["batch"] = keys(executor.execute_pair_jobs(jobs("batch"),
                                                   device="cpu", mesh=mesh))
    out["stats"] = {k: executor.EXEC_STATS[k]
                    for k in ("launches", "batched_jobs", "single_jobs")}
    for kind, gate in (("linear", 32), ("fanin", 32)):
        executor.SHARDBAND_MIN_L = gate
        executor.reset_stats()
        out[kind] = keys(executor.execute_pair_jobs(jobs(kind),
                                                    device="cpu",
                                                    mesh=mesh))
        out[kind + "_shardband_fills"] = executor.EXEC_STATS[
            "shardband_fills"]
    out["plain_blocks"] = dict(SB.PLAIN_CALLS)
    shutdown_multihost()
    with open(os.path.join(outdir, "rank%d.json" % pid), "w") as f:
        json.dump(out, f)
    print("rank %d OK" % pid, flush=True)


if __name__ == "__main__":
    main()
