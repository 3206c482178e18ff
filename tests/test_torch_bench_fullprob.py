"""The kernel-D/E bench (pagan2_tpu_torch/tools/bench_fullprob.py) on
the CPU at its small size: its --full-probability runs and its 454
batch give a call of each entry point, kernel E's calls name their
launch plan, and a second run is held bit for bit against the outputs
the first one saved."""
import pytest

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
    assert plans["fullprob_fwd"] == plans["fullprob_fwd_fanin"] == ""
    again = bench_fullprob.main(["--device", "cpu", "--small",
                                 "--check", str(out)])
    key = ("source", "entry", "B", "D", "Lp", "K", "G")
    assert [tuple(r[k] for k in key) for r in again] \
        == [tuple(r[k] for k in key) for r in first]
    assert all(r["same"] for r in again)


def test_bench_fullprob_times_the_wide_and_454_fanin_shapes(saved):
    """Past the main family: the 6-leaf family's fan-in calls (both
    entry points, wider than the 4-leaf family's) and the 454 batch's
    pairs (backward edges K 3/3, forward K 2/2), each with kernel E's
    plan."""
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
    assert all(r["plan"].startswith("K ") for r in wide + b454
               if r["entry"] == "fullprob_bwd_fanin")
