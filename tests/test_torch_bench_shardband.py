"""The kernel G/H bench (pagan2_tpu_torch/tools/bench_shardband.py) on
the CPU at its small size: each fill at two halos names its launches and
host walls, the launches are the launch plan's, and a second run is held
bit for bit against the digests the first one saved."""
import pytest
import torch

from pagan2_tpu_torch.align import viterbi_shardband as SB
from pagan2_tpu_torch.tools import bench_shardband


@pytest.fixture
def one_thread():
    """One intra-op thread: the small fills gain nothing from more, and
    parallel test workers would contend for the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_bench_shardband_runs_and_checks_on_cpu(tmp_path, one_thread):
    first = bench_shardband.main(["--device", "cpu", "--small", "--halo",
                                  "32,256", "--save", str(tmp_path)])
    assert [(r["kind"], r["halo"]) for r in first] == [
        ("linear", 32), ("linear", 256), ("fanin", 32), ("fanin", 256)]
    for r in first:
        assert r["fill_s"] >= r["less_gather_s"] >= r["loop_s"] > 0
        assert r["gather_s"] >= 0
        assert r["kernel_ms"] is None and r["same"] is None
    lin32, lin256 = first[0], first[1]
    assert (lin32["L"], lin32["R"]) == (601, 61)
    w = SB._lane_split(lin32["L"], bench_shardband.SHARDS)
    assert lin256["H"] == min(256, w)
    for r in first[:2]:
        assert r["launches"] == SB.plan_launches(SB.linear_launch_plan(
            r["L"], r["R"], bench_shardband.SHARDS, w, r["H"]))
    # fewer blocks between exchanges: fewer launches
    assert lin256["launches"] < lin32["launches"]
    assert first[3]["launches"] < first[2]["launches"]
    again = bench_shardband.main(["--device", "cpu", "--small", "--halo",
                                  "32,256", "--check", str(tmp_path)])
    assert [r["launches"] for r in again] == [r["launches"] for r in first]
    assert all(r["same"] for r in again)


def test_gate_pairs_are_chip_smokes_draws():
    """The gate pairs: a 65,535 bp base, the linear read of 1,023 bp, the
    454 pair of the base's first 8,191 bp and its own 1,023 bp read."""
    (s1, r1), (s2, r2) = bench_shardband.gate_pairs()
    assert (len(s1), len(r1), len(s2), len(r2)) == (65535, 1023, 8191,
                                                    1023)
    assert s2 == s1[:8191]
    # a read is its stretch of the base with about 10% redrawn
    same = sum(a == b for a, b in zip(r1, s1[20000:21023]))
    assert 0.85 * 1023 < same < 1023
