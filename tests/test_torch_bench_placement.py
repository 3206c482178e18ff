"""tools/bench_placement.py on the CPU at its small size: the main run
and the four placement runs through the port's CLI on the plain
versions, each reporting its wall, launches, routes and output digests,
run (a) its host phases."""
from pagan2_tpu_torch.tools import bench_placement


def test_bench_placement_small(tmp_path):
    res = {r["run"]: r for r in bench_placement.main(
        ["--device", "cpu", "--small", "--work", str(tmp_path)])}
    assert list(res) == ["main", "a", "b", "c", "d"]
    for r in res.values():
        assert r["wall_s"] > 0 and r["plain_calls"] > 0
        assert not any(r["launches"].values())
        assert len(r["sha256"][".fas"]) == 64
    # the random query is discarded, with its file, in (a) and (b)
    for run in "ab":
        assert res[run]["discarded"] == ["x0"]
        assert res[run]["placed"] >= 3
        assert ".discarded" in res[run]["sha256"]
    assert set(res["a"]["host_s"]) == {
        label for _m, _n, label in bench_placement.HOST_PHASES}
    assert res["a"]["routes"]["batched_jobs"] >= 8
