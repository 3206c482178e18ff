"""The kernel-D/E bench (pagan2_tpu_torch/tools/bench_fullprob.py) on
the CPU at its small size: its --full-probability runs and its 454
batch give a call of each entry point, kernels D's and E's calls name
their launch plans, and a second run is held bit for bit against the outputs
the first one saved."""
import pytest
import torch

from pagan2_tpu_torch.align import fullprob_fill as ff
from pagan2_tpu_torch.tools import bench_fullprob


@pytest.fixture(scope="module")
def saved(tmp_path_factory):
    out = tmp_path_factory.mktemp("bench_fullprob")
    return out, bench_fullprob.main(["--device", "cpu", "--small",
                                     "--save", str(out)])


def test_bench_fullprob_runs_and_checks_on_cpu(saved):
    out, first = saved
    assert [r["entry"] for r in first if r["source"] == "4x120"] \
        == list(bench_fullprob.ENTRIES)
    assert all(r["ms"] > 0 and r["same"] is None for r in first)
    plans = {r["entry"]: r["plan"] for r in first}
    assert "threads x 1 rows" in plans["fullprob_bwd"]
    assert "templated" in plans["fullprob_bwd_fanin"]
    assert "threads x 1 rows, buffers shared" in plans["fullprob_fwd"]
    assert "K 3/3 (templated)" in plans["fullprob_fwd_fanin"]
    again = bench_fullprob.main(["--device", "cpu", "--small",
                                 "--check", str(out)])
    key = ("source", "entry", "B", "D", "Lp", "K", "G")
    assert [tuple(r[k] for k in key) for r in again] \
        == [tuple(r[k] for k in key) for r in first]
    assert all(r["same"] for r in again)


def test_bench_fullprob_times_the_wide_and_454_fanin_shapes(saved):
    """Past the main family: the 6-leaf family's fan-in calls (both
    entry points, wider than the 4-leaf family's) and the 454 batch's
    pairs (backward edges K 3/3, forward K 2/2), each with kernel D's
    or E's plan."""
    _out, first = saved
    by = {}
    for r in first:
        by.setdefault(r["source"], []).append(r)
    wide = by["6x150"]
    assert {r["entry"] for r in wide} == {"fullprob_fwd_fanin",
                                          "fullprob_bwd_fanin"}
    assert min(r["Lp"] for r in wide) > max(r["Lp"] for r in by["4x120"])
    b454 = by["454"]
    assert [(r["entry"], r["B"], r["K"]) for r in b454] == [
        ("fullprob_fwd_fanin", 2, "3/3"), ("fullprob_bwd_fanin", 2, "2/2")]
    assert all(r["plan"].startswith("K ") for r in wide + b454)


def _call(Lp, K=None):
    """Tensors shaped as one of kernel D's calls (K "E": kernel E's
    linear call; values unused)."""
    if K is None or K == "E":
        return ("fullprob_fwd" if K is None else "fullprob_bwd",
                dict(ms2=torch.zeros(1, 8, Lp)))
    return "fullprob_fwd_fanin", dict(
        loff=torch.zeros(1, Lp, K, dtype=torch.int32),
        roff=torch.zeros(1, 200, K, dtype=torch.int32), G=26)


@pytest.mark.parametrize("Lp,K,builds", [
    (512, None, 6), (544, None, 6), (1024, None, 6), (1536, None, 5),
    (2016, None, 5), (2112, None, 4), (4112, None, 4), (8112, None, 4),
    (2112, "E", 4), (5008, "E", 4),
    (1536, 2, 4), (2016, 2, 2), (2016, 1, 2), (2112, 2, 1), (2048, 3, 1),
    (768, 3, 3)])
def test_lane_plans_list_every_build_once_the_plans_first(Lp, K, builds):
    """--lanes: kernel D's (and E's linear) builds that can take a call,
    the plan's own first, each once, each with enough lanes and a block
    its build takes (linear: 1 and 2 lanes a thread on one block of up
    to 1,024 threads, and the cluster build at each size the plan picks
    (8 and 16) with 2 and 4 lanes a thread; fan-in two lanes up to 768, 384
    past a templated K 2 x 2, four up to 512 and only up to K 2 x 2, any
    count runtime K only)."""
    name, kw = _call(Lp, K)
    got = bench_fullprob.lane_plans(ff, name, kw)
    plans = [p for _t, p in got]
    own = ff.fwd_linear_plan(Lp) if K is None else \
        ff.bwd_linear_plan(Lp) if K == "E" else \
        ff.fwd_fanin_plan(Lp, 26, K, K, 200)
    assert plans[0] == own and len(plans) == builds
    assert len({t for t, _p in got}) == builds
    for p in plans:
        rows = p["rows"] or -(-Lp // p["threads"])
        assert rows * p["threads"] * max(1, p.get("cluster", 1)) >= Lp
        assert p["threads"] % 32 == 0 and p["threads"] <= 1024
        if K is None or K == "E":
            cell = 32 if K is None else 16
            if p["cluster"]:
                assert p["cluster"] in ff.CLUSTER_SIZES
                assert p["rows"] in (2, 4)
                assert p["smem"] == cell * (p["rows"] * p["threads"] + 1)
            else:
                assert p["rows"] in (1, 2)
                assert p["smem"] == cell * (Lp + 1)
            continue
        assert (p["KL"], p["KR"]) in ((0, 0), (K, K))
        assert p["placement"] == own["placement"]
        if p["rows"] == 4:
            assert p["KL"] and K <= 2 and p["threads"] <= 512
        elif p["rows"] == 2:
            assert p["threads"] <= (768 if K <= 2 or not p["KL"] else 384)
        else:
            assert p["KL"] == 0


def test_bench_fullprob_giant_on_cpu(tmp_path):
    """--giant --small: both linear entry points on giant_calls' three
    batches at CPU sizes (the 5,000 bp pair cut to 200, the ragged batch
    of three pairs), then held bit for bit against the saved digests;
    --clusters is refused off a card and without --giant."""
    first = bench_fullprob.main(["--device", "cpu", "--small", "--giant",
                                 "--save", str(tmp_path)])
    assert [(r["source"], r["entry"], r["B"]) for r in first] == [
        ("pair 300", "fullprob_fwd", 1), ("pair 300", "fullprob_bwd", 1),
        ("pair 200", "fullprob_fwd", 1), ("pair 200", "fullprob_bwd", 1),
        ("ragged batch", "fullprob_fwd", 3),
        ("ragged batch", "fullprob_bwd", 3)]
    assert all(r["plan"] and r["ms"] > 0 for r in first)
    again = bench_fullprob.main(["--device", "cpu", "--small", "--giant",
                                 "--check", str(tmp_path)])
    assert all(r["same"] for r in again)
    for argv in (["--device", "cpu", "--giant", "--clusters", "2x2"],
                 ["--clusters", "2x2"]):
        with pytest.raises(SystemExit):
            bench_fullprob.main(argv)
    assert bench_fullprob.cluster_sweep("2x2,16x4") == [(2, 2), (16, 4)]


def test_redrawn_pair_is_seeded():
    a, b = bench_fullprob.redrawn_pair(5000)
    assert len(a) == len(b) == 5000 and (a, b) == \
        bench_fullprob.redrawn_pair(5000)
    assert 0.05 < sum(x != y for x, y in zip(a, b)) / 5000 < 0.1
