"""Multi-process runs: N processes as ONE jobs mesh over torch.distributed.

Ported from pagan2_tpu/parallel/multihost.py, where `jax.distributed`
wires the processes into one runtime and the executor's `jobs` mesh axis
spans every device of every process. Here the processes join a gloo
process group (the JAX CLI's flags keep their names):

    python -m pagan2_tpu_torch ... \\
        --jax-coordinator 127.0.0.1:29500 --jax-num-processes 2 \\
        --jax-process-id $RANK

Host-side work (prep, backtrack, ancestral builds) is replicated: every
rank builds the same per-job arrays, launches only the work of the shards
it owns on its own devices, and `gather_to_host` brings every shard's
results to every rank, so each finishes with the whole alignment, as
`process_allgather` does in the reference. The band-sharded fill of one
giant pair (align/viterbi_shardband.py) passes its halo edges rank to
rank with send/recv. gloo moves host tensors: NCCL refuses two ranks on
one card, and the reference gathers to the host anyway.
"""
from __future__ import annotations

import numpy as np
import torch


def init_multihost(coordinator: str, num_processes: int,
                   process_id: int) -> None:
    """Join the gloo process group at `coordinator` (HOST:PORT, rank 0
    listens there) as rank `process_id` of `num_processes`."""
    import torch.distributed as dist
    dist.init_process_group("gloo", init_method="tcp://%s" % coordinator,
                            world_size=num_processes, rank=process_id)


def shutdown_multihost() -> None:
    """Wait for every rank, then leave the process group."""
    import torch.distributed as dist
    if dist.is_initialized():
        dist.barrier()
        dist.destroy_process_group()


def local_devices(device) -> list:
    """This process's devices of `device`'s type: every visible card, or
    the one CPU."""
    dev = torch.device(device)
    if dev.type == "cuda":
        return [torch.device("cuda", k)
                for k in range(torch.cuda.device_count())]
    return [torch.device("cpu")]


def global_jobs_mesh(device="cuda"):
    """A jobs mesh over every rank's local devices, in rank order (the
    reference's Mesh(jax.devices())): each shard's owner is its rank."""
    import torch.distributed as dist
    from .executor import JobsMesh
    mine = [str(d) for d in local_devices(device)]
    every = [None] * dist.get_world_size()
    dist.all_gather_object(every, mine)
    devices = [d for per in every for d in per]
    ranks = [r for r, per in enumerate(every) for _d in per]
    return JobsMesh(devices, ranks=ranks, rank=dist.get_rank(),
                    world_size=dist.get_world_size())


def gather_to_host(mesh, parts: dict) -> dict:
    """{shard: [numpy arrays]} for every shard of `mesh`, from this
    rank's {shard: [numpy arrays]}: each shard's owner broadcasts its
    arrays (host tensors over gloo), so every rank holds them all."""
    if mesh.world_size == 1:
        return parts
    import torch.distributed as dist
    out = {}
    for s in range(mesh.size):
        owner = mesh.ranks[s]
        mine = owner == mesh.rank
        meta = [[(a.shape, a.dtype.str) for a in parts[s]] if mine
                else None]
        dist.broadcast_object_list(meta, src=owner, group=mesh.group)
        arrays = []
        for k, (shape, dt) in enumerate(meta[0]):
            a = np.ascontiguousarray(parts[s][k]) if mine else \
                np.empty(shape, np.dtype(dt))
            t = torch.from_numpy(a)
            dist.broadcast(t, src=owner, group=mesh.group)
            arrays.append(t.numpy())
        out[s] = arrays
    return out


def pass_edges(mesh, edges: dict, halos: dict, pairs=None) -> None:
    """The halo exchange of a band-sharded fill: for every shard s of
    `pairs` (default: every s > 0), the tensor view halos[s] takes the
    values of edges[s - 1] (shard s - 1's edge lanes). Between two
    shards of this process they are copied device to device; across
    ranks they travel as a host tensor (isend/irecv, all posted before
    any wait), so every rank must pass the same `pairs`. `edges` and
    `halos` hold this rank's shards only."""
    reqs, recvs, held = [], [], []
    for s in (range(1, mesh.size) if pairs is None else pairs):
        src, dst = mesh.is_local(s - 1), mesh.is_local(s)
        if src and dst:
            halos[s].copy_(edges[s - 1])
        elif src or dst:
            import torch.distributed as dist
            if src:
                buf = edges[s - 1].cpu().contiguous()
                held.append(buf)
                reqs.append(dist.isend(buf, dst=mesh.ranks[s],
                                       group=mesh.group))
            else:
                buf = torch.empty(tuple(halos[s].shape),
                                  dtype=halos[s].dtype)
                reqs.append(dist.irecv(buf, src=mesh.ranks[s - 1],
                                       group=mesh.group))
                recvs.append((s, buf))
    for r in reqs:
        r.wait()
    for s, buf in recvs:
        halos[s].copy_(buf)
