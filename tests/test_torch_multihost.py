"""Multi-process runs in the port (parallel/multihost.py): two real
processes join one gloo group, as tests/test_multihost.py has two join
jax.distributed. Each runs a generation of batched pair jobs over the
global jobs mesh (one CPU shard a rank: each rank fills its half of the
batch and gathers the other's), then a linear and a fan-in pair
band-sharded across the ranks (SHARDBAND_MIN_L lowered to their 32
rows, so the JAX package's shard_map compile stays small; the halo edges
pass rank to rank by send/recv). Both ranks must finish with the
same alignments, equal to the JAX package's on make_jobs_mesh(2) (f32)
in this process; then two port CLI processes with --jax-coordinator
write the JAX package's 2-device bytes of the amplicon family."""
import json
import os
import socket
import subprocess
import sys

import numpy as np

from pagan2_tpu.align import AlignSettings
from pagan2_tpu.graph import build_leaf_graph
from pagan2_tpu.models import ModelFactory, alphabets as alph
from pagan2_tpu.parallel import executor

from test_torch_fullprob_cli import amplicon_family

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _start(argv, tmp_path):
    # one intra-op thread a rank: the ranks' work is small, and the
    # suite's other workers share the cores
    env = dict(os.environ, PYTHONPATH=ROOT, OMP_NUM_THREADS="1")
    env.pop("XLA_FLAGS", None)
    return subprocess.Popen([sys.executable] + argv, env=env, cwd=ROOT,
                            stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT)


def _wait(procs):
    outs = [p.communicate(timeout=540)[0].decode(errors="replace")
            for p in procs]
    for p, out in zip(procs, outs):
        assert p.returncode == 0, out[-3000:]


def _jax_jobs(kind):
    """torch_multihost_worker.jobs with the JAX package's builder."""
    rng = np.random.default_rng(42)
    model = ModelFactory(alph.DNA).alignment_model(0.3)
    n, size, sites = {"batch": (8, 60, "ACGT"), "linear": (1, 31, "ACGT"),
                      "fanin": (1, 31, "AACCGGTT")}[kind]
    out = []
    for _t in range(n):
        base = rng.choice(list(sites), size=size)
        mut = base.copy()
        idx = rng.random(size) < 0.15
        mut[idx] = rng.choice(list("ACGT"), size=int(idx.sum()))
        kw = {"mode454": True} if kind == "fanin" else {}
        out.append(executor.PairJob(
            left=build_leaf_graph("".join(base), alph.DNA, **kw),
            right=build_leaf_graph("".join(mut), alph.DNA, **kw),
            model=model, settings=AlignSettings()))
    return out


def test_two_ranks_match_each_other_and_jax(tmp_path, monkeypatch):
    worker = os.path.join(ROOT, "tests", "torch_multihost_worker.py")
    port = _free_port()
    _wait([_start([worker, str(r), "2", str(port), str(tmp_path)],
                  tmp_path) for r in range(2)])
    r0 = json.load(open(tmp_path / "rank0.json"))
    r1 = json.load(open(tmp_path / "rank1.json"))
    assert r0["n_shards"] == 2 and r0["ranks"] == [0, 1]
    # each rank launches the blocks its own shard holds cells on (the
    # launch plan), so only those counts may differ between the ranks
    blocks = [r.pop("plain_blocks") for r in (r0, r1)]
    assert r0 == r1
    assert r0["stats"]["batched_jobs"] == 8 and \
        r0["stats"]["single_jobs"] == 0
    assert r0["linear_shardband_fills"] == r0["fanin_shardband_fills"] == 1
    assert all(v > 0 for b in blocks for v in b.values())

    mesh = executor.make_jobs_mesh(2)
    for kind, gate in (("batch", 1 << 16), ("linear", 32), ("fanin", 32)):
        monkeypatch.setattr(executor, "SHARDBAND_MIN_L", gate)
        res = executor.execute_pair_jobs(_jax_jobs(kind), mesh=mesh,
                                         dtype=np.float32)
        want = [[int(anc.states[i]) for i in range(anc.num_sites())]
                for anc, _e in res]
        assert r0[kind] == want, kind


def test_two_cli_ranks_write_the_jax_two_device_bytes(tmp_path):
    """Two port CLI processes (--jax-coordinator, --jax-num-processes 2,
    --jax-process-id 0|1, each its own -o) write the same FASTA, the
    JAX package's align_progressive on make_jobs_mesh(2) (f32; its
    one-device bytes differ, test_torch_mesh.py)."""
    import jax
    from pagan2_tpu.align import viterbi_pallas as vp
    from pagan2_tpu.align import viterbi_pallas_fanin as vpf
    from pagan2_tpu.io.fasta import read_sequences
    from pagan2_tpu.pipeline import align_progressive
    fas, nh = amplicon_family(tmp_path)
    port = _free_port()
    procs = [_start(["-m", "pagan2_tpu_torch", "--device", "cpu", "--silent",
                     "-s", str(fas), "-t", str(nh),
                     "--jax-coordinator", "127.0.0.1:%d" % port,
                     "--jax-num-processes", "2", "--jax-process-id", str(r),
                     "-o", str(tmp_path / ("rank%d" % r))], tmp_path)
             for r in range(2)]
    x64 = jax.config.jax_enable_x64
    jax.config.update("jax_enable_x64", False)
    try:
        vp.INTERPRET = vpf.INTERPRET = True
        want = align_progressive(read_sequences(str(fas)), nh.read_text(),
                                 mesh=executor.make_jobs_mesh(2))
    finally:
        vp.INTERPRET = vpf.INTERPRET = False
        jax.config.update("jax_enable_x64", x64)
    _wait(procs)
    a = (tmp_path / "rank0.fas").read_bytes()
    assert a == (tmp_path / "rank1.fas").read_bytes()
    got = [(e.name, e.sequence)
           for e in read_sequences(str(tmp_path / "rank0.fas"))]
    assert got == [(e.name, e.sequence) for e in want.alignment]
