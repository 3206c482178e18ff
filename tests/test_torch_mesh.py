"""The jobs mesh in the port (ROADMAP Queue 1 item 11) against the JAX
package's, on the CPU: execute_pair_jobs over 2 and 4 CPU shards
(JobsMesh([cpu] * n)) against the JAX package's execute_pair_jobs over
make_jobs_mesh(n) on the conftest's virtual devices (f32), bucket by
bucket: linear pairs of a tie-prone amplicon family, a single-job
bucket, an anchored pair whose band dead-ends, 454 fan-in graphs,
full-probability linear and fan-in pairs and seeded sampling. Ancestral
states, site types and Viterbi end scores must be equal (a sampled
path's end score within 1e-5: it is read from the probability planes).

A mesh changes the output on ties in the JAX package (its mesh path
fills linear batches and single-job buckets on its scan core, whose M
compares after the match score is added): align_progressive of the
amplicon family on 4 shards must give the JAX package's 4-device bytes
and differ from the one-device bytes, so the comparison cannot pass
vacuously. The port's CLI with --device cpu --threads 4 runs unsharded,
as the JAX CLI does on one device."""
import os
import subprocess
import sys
from dataclasses import replace

import numpy as np
import pytest

import pagan2_tpu.align as J_ALIGN
from pagan2_tpu.align import viterbi_pallas as J_VP
from pagan2_tpu.align import viterbi_pallas_fanin as J_VPF
from pagan2_tpu.graph import build_leaf_graph as j_leaf
from pagan2_tpu.models import ModelFactory as JModelFactory
from pagan2_tpu.parallel import executor as J_EX

import pagan2_tpu_torch.align as P_ALIGN
from pagan2_tpu_torch.graph import build_leaf_graph as p_leaf
from pagan2_tpu_torch.models import ModelFactory, alphabets as alph
from pagan2_tpu_torch.parallel import executor as P_EX
from pagan2_tpu_torch.parallel.executor import JobsMesh
from pagan2_tpu_torch.tools.reads import amplicon_reads

from test_torch_fullprob_cli import amplicon_family
from test_torch_progressive import REFERENCE, ROOT


def _jobs(pkg, kind):
    """One generation's jobs of `kind` built with pkg's graph builder and
    settings ("jax" or "port"): each call builds fresh graphs."""
    leaf = j_leaf if pkg == "jax" else p_leaf
    Settings = J_ALIGN.AlignSettings if pkg == "jax" else \
        P_ALIGN.AlignSettings
    PairJob = J_EX.PairJob if pkg == "jax" else P_EX.PairJob
    model = (JModelFactory if pkg == "jax" else ModelFactory)(
        alph.DNA).alignment_model(0.3)
    s = Settings()
    if kind in ("fullprob", "sample"):
        s = replace(s, compute_full_score=True,
                    sample_path=kind == "sample")
    reads = [r[1] for r in amplicon_reads(8, 120, 400, seed=7)]
    rng = np.random.default_rng(4)
    jobs = []
    # tie-prone linear pairs of one bucket
    for a in range(0, 6, 2):
        jobs.append(PairJob(leaf(reads[a], alph.DNA),
                            leaf(reads[a + 1], alph.DNA), model, s))
    # a bucket of its own: a longer linear pair
    base = rng.choice(list("ACGT"), size=300)
    mut = base.copy()
    idx = rng.random(300) < 0.1
    mut[idx] = rng.choice(list("ACGT"), size=int(idx.sum()))
    jobs.append(PairJob(leaf("".join(base), alph.DNA),
                        leaf("".join(mut[:290]), alph.DNA), model, s))
    if kind == "viterbi":
        # a wide band that cannot reach the end corner: the batched fill
        # dead-ends and the pair is filled again over the full matrix
        g1, g2 = leaf(reads[6], alph.DNA), leaf(reads[7], alph.DNA)
        L, R = g1.num_sites() - 1, g2.num_sites() - 1
        upper, lower = np.zeros(L, np.int64), np.full(L, R - 1, np.int64)
        lower[-1] = 0
        jobs.append(PairJob(g1, g2, model, s))
        jobs[-1].band = (upper, lower)
    # 454 fan-in graphs (homopolymer skip edges)
    for t in range(3):
        b = rng.choice(list("AACCGGTT"), size=50)
        b[5:10] = "A"
        b[25:30] = "T"
        m = b.copy()
        idx = rng.random(50) < 0.12
        m[idx] = rng.choice(list("ACGT"), size=int(idx.sum()))
        jobs.append(PairJob(leaf("".join(b), alph.DNA, mode454=True),
                            leaf("".join(m), alph.DNA, mode454=True),
                            model, s))
    return jobs


def _keys(results):
    return [(tuple(int(x) for x in anc.states[:anc.num_sites()]),
             tuple(int(x) for x in anc.site_type[:anc.num_sites()]))
            for anc, end in results]


def _scores(results):
    return np.array([end.score for _anc, end in results], np.float64)


@pytest.fixture
def jax_f32_singles(monkeypatch):
    """The JAX package as its CLI runs it for the parity tests: jobs
    that run one by one take its Pallas kernels in interpret mode. Both
    packages' sampling RNGs are put back after the test."""
    monkeypatch.setattr(J_VP, "INTERPRET", True)
    monkeypatch.setattr(J_VPF, "INTERPRET", True)
    monkeypatch.setattr(J_ALIGN, "_RNG", None)
    monkeypatch.setattr(P_ALIGN, "_RNG", None)


@pytest.mark.parametrize("n,kind", [(2, "viterbi"), (4, "viterbi"),
                                    (2, "fullprob"), (4, "sample")])
def test_execute_pair_jobs_on_a_mesh_matches_jax(jax_f32_singles, n, kind):
    J_ALIGN.set_sampling_seed(11)
    J_EX.reset_stats()
    want = J_EX.execute_pair_jobs(_jobs("jax", kind),
                                  mesh=J_EX.make_jobs_mesh(n),
                                  dtype=np.float32)
    jstats = dict(J_EX.EXEC_STATS)
    P_ALIGN.set_sampling_seed(11)
    P_EX.reset_stats()
    got = P_EX.execute_pair_jobs(_jobs("port", kind), device="cpu",
                                 mesh=JobsMesh(["cpu"] * n))
    pstats = dict(P_EX.EXEC_STATS)
    assert _keys(got) == _keys(want)
    if kind == "sample":
        # a sampled path's end score is read from the probability
        # planes, which kernels D and E hold to the JAX package's within
        # a tolerance (tests/test_torch_fullprob.py)
        np.testing.assert_allclose(_scores(got), _scores(want), rtol=1e-5)
    else:
        assert np.array_equal(_scores(got), _scores(want))
    # every bucket batched, the single-job bucket too; only the
    # dead-ended pair ran one by one
    assert pstats["single_jobs"] == jstats["single_jobs"] == \
        (1 if kind == "viterbi" else 0), (pstats, jstats)
    assert pstats["batched_jobs"] == jstats["batched_jobs"]


def test_mesh_of_one_shard_is_the_unsharded_executor():
    """A mesh of one shard (or none) runs exactly as today: single-job
    buckets one by one on the Pallas rule, the same results."""
    P_EX.reset_stats()
    one = P_EX.execute_pair_jobs(_jobs("port", "viterbi"), device="cpu",
                                 mesh=JobsMesh(["cpu"]))
    stats = dict(P_EX.EXEC_STATS)
    P_EX.reset_stats()
    none = P_EX.execute_pair_jobs(_jobs("port", "viterbi"), device="cpu")
    assert _keys(one) == _keys(none)
    assert np.array_equal(_scores(one), _scores(none))
    del stats["fill_seconds"]
    assert stats == {k: v for k, v in P_EX.EXEC_STATS.items()
                     if k != "fill_seconds"}
    # the 300-bp bucket and the dead-ended pair's retry ran single
    assert stats["single_jobs"] == 2


def test_mesh_refuses_another_device_type():
    with pytest.raises(ValueError, match="mesh shards"):
        P_EX.execute_pair_jobs([], device="cpu",
                               mesh=JobsMesh(["meta", "meta"]))


def test_amplicon_progressive_on_four_shards_matches_jax(tmp_path):
    """align_progressive of the amplicon family on 4 shards gives the JAX
    package's bytes on 4 devices (f32), and those differ from the
    one-device bytes of both packages."""
    import jax
    from pagan2_tpu.io.fasta import read_sequences as j_read
    from pagan2_tpu.pipeline import align_progressive as j_progressive
    from pagan2_tpu_torch.io.fasta import read_sequences
    from pagan2_tpu_torch.pipeline import align_progressive
    fas, nh = amplicon_family(tmp_path)
    tree = nh.read_text()
    x64 = jax.config.jax_enable_x64
    jax.config.update("jax_enable_x64", False)
    try:
        J_VP.INTERPRET = J_VPF.INTERPRET = True
        want4 = j_progressive(j_read(str(fas)), tree,
                              mesh=J_EX.make_jobs_mesh(4))
        want1 = j_progressive(j_read(str(fas)), tree)
    finally:
        J_VP.INTERPRET = J_VPF.INTERPRET = False
        jax.config.update("jax_enable_x64", x64)
    got4 = align_progressive(read_sequences(str(fas)), tree, device="cpu",
                             mesh=JobsMesh(["cpu"] * 4))
    got1 = align_progressive(read_sequences(str(fas)), tree, device="cpu")

    def rows(res):
        return [(e.name, e.sequence) for e in res.alignment]
    assert rows(got4) == rows(want4)
    assert rows(got1) == rows(want1)
    assert rows(want4) != rows(want1)


def test_cli_threads_on_one_device_matches_jax_cli(tmp_path):
    """The port's CLI with --device cpu --threads 4 makes no mesh, as the
    JAX CLI makes none on its one device: both write the one-device
    bytes of the amplicon family."""
    fas, nh = amplicon_family(tmp_path)
    common = ["-s", str(fas), "-t", str(nh), "--threads", "4"]
    env = dict(os.environ, PYTHONPATH=ROOT, JAX_PLATFORMS="cpu",
               JAX_ENABLE_X64="0", PAGAN2_STRICT="1",
               XLA_FLAGS="--xla_force_host_platform_device_count=1",
               PAGAN2_JAX_CACHE=str(tmp_path / "jax_cache"))
    ref = subprocess.Popen(
        [sys.executable, "-c", REFERENCE, "-o", str(tmp_path / "ref")]
        + common, env=env, cwd=ROOT, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True)
    from pagan2_tpu_torch import cli
    assert cli.main(["--device", "cpu", "--silent",
                     "-o", str(tmp_path / "port")] + common) == 0
    assert cli.main(["--device", "cpu", "--silent", "-s", str(fas), "-t",
                     str(nh), "-o", str(tmp_path / "one")]) == 0
    _out, err = ref.communicate(timeout=600)
    assert ref.returncode == 0, err[-3000:]
    port = (tmp_path / "port.fas").read_bytes()
    assert port == (tmp_path / "ref.fas").read_bytes()
    assert port == (tmp_path / "one.fas").read_bytes()


def test_bench_scaling_runs_on_cpu_shards():
    """tools/bench_scaling.py on 2 logical CPU shards: both rates, and
    efficiency taken over the one distinct device."""
    from pagan2_tpu_torch.tools import bench_scaling
    out = bench_scaling.main(["--device", "cpu", "4", "60", "--shards",
                              "2"])
    assert out["n_shards"] == 2 and out["distinct_devices"] == 1
    assert out["jobs_per_s_1dev"] > 0 and out["jobs_per_s_mesh"] > 0
    assert out["efficiency"] == pytest.approx(
        out["jobs_per_s_mesh"] / out["jobs_per_s_1dev"])
