"""The kernel-B bench (pagan2_tpu_torch/tools/bench_fanin.py) on the CPU
at its small size: its three runs give fan-in calls, and a second run
is held bit for bit against the outputs the first one saved."""
from pagan2_tpu_torch.tools import bench_fanin


def test_bench_fanin_runs_and_checks_on_cpu(tmp_path):
    first = bench_fanin.main(["--device", "cpu", "--small",
                              "--save", str(tmp_path)])
    assert [r["run"] for r in first] == ["main", "fullprob", "454"]
    assert all(r["ms"] > 0 and r["same"] is None for r in first)
    again = bench_fanin.main(["--device", "cpu", "--small",
                              "--check", str(tmp_path)])
    assert [(r["run"], r["B"], r["D"], r["W"], r["G"], r["K"])
            for r in again] == [(r["run"], r["B"], r["D"], r["W"], r["G"],
                                 r["K"]) for r in first]
    assert all(r["same"] for r in again)
