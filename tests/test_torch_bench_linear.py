"""The kernel-A bench (pagan2_tpu_torch/tools/bench_linear_calls.py) on
the CPU at its small size: its CLI runs, the JAX tool's batch and
chip_smoke.py's kernel_linear batches each give a call with kernel A's
launch plan, the probe's all-off floor is measured, and a second run is
held bit for bit against the outputs the first one saved; and the build
lists of its --lanes mode."""
import numpy as np
import pytest

from pagan2_tpu_torch.align import AlignSettings
from pagan2_tpu_torch.align import viterbi_linear as tl
from pagan2_tpu_torch.models import ModelFactory, alphabets as alph
from pagan2_tpu_torch.tools import bench_linear_calls as blc


@pytest.fixture(scope="module")
def saved(tmp_path_factory):
    out = tmp_path_factory.mktemp("bench_linear_calls")
    return out, blc.main(["--device", "cpu", "--small", "--save", str(out)])


def test_bench_linear_calls_runs_and_checks_on_cpu(saved):
    out, first = saved
    assert [r["source"] for r in first] == [
        "main", "fullprob", "2x200", "4x100", "ragged banded", "300 rows"]
    assert all(r["ms"] > 0 and r["same"] is None for r in first)
    assert all(r["plan"] == blc.plan_text(tl, r["Lp"]) for r in first)
    assert all(r["floor_us_per_diagonal"] > 0 for r in first)
    again = blc.main(["--device", "cpu", "--small", "--check", str(out)])
    key = ("source", "B", "D", "Lp", "plan")
    assert [tuple(r[k] for k in key) for r in again] \
        == [tuple(r[k] for k in key) for r in first]
    assert all(r["same"] for r in again)


def test_bench_linear_calls_pads_the_jax_tools_batch(saved):
    """The JAX tool's batch keeps its diagonals padded to TD 16, as
    tools/bench_linear.py launches it; the recorded CLI calls are the
    family's one batch of leaf pairs each."""
    _out, first = saved
    by = {r["source"]: r for r in first}
    assert (by["2x200"]["D"] - 1) % 16 == 0
    assert by["main"]["B"] == by["fullprob"]["B"] == 2


def test_linear_batches_draw_chip_smokes_kinds():
    """kernel_linear's batches: a square batch, a ragged banded one (a
    band per job, right sides cut) and one past the others' rows; the
    same generator state gives the same batches."""
    model = ModelFactory(alph.DNA).alignment_model(0.2)
    got = [blc.linear_batches(np.random.default_rng(11), model,
                              AlignSettings(), small=True)
           for _ in range(2)]
    assert [n for n, _i, _b in got[0]] == ["4x100", "ragged banded",
                                           "300 rows"]
    for (_n, a, ba), (_m, b, bb) in zip(*got):
        assert [(x["L"], x["R"]) for x in a] == [(x["L"], x["R"])
                                                 for x in b]
        assert all(np.array_equal(x["ms"], y["ms"]) for x, y in zip(a, b))
    _n, ragged, bands = got[0][1]
    assert all(b is not None for b in bands)
    assert all(x["R"] < x["L"] for x in ragged)
    assert min(x["L"] for x in got[0][2][1]) > max(
        x["L"] for x in got[0][0][1])


@pytest.mark.parametrize("Lp,builds", [
    (32, 4), (128, 4), (512, 4), (1024, 4), (1536, 3), (2048, 3),
    (3072, 2), (4096, 2), (4128, 2), (100, 2)])
def test_lane_plans_list_every_build_once_the_plans_first(Lp, builds):
    """--lanes: kernel A's builds that can take Lp rows, the plan's own
    first, each once, each with enough rows in a block of at most 1024
    threads of whole warps, or the tiled build at its ordinary and its
    pair-end build's tiles; in the pair-end build the plan's own comes
    first."""
    got = blc.lane_plans(tl, Lp)
    plans = [p for _t, p in got]
    assert plans[0] == tl.linear_plan(Lp) and len(plans) == builds
    assert len({t for t, _p in got}) == builds
    assert plans.count(tl.linear_plan(Lp)) == 1
    for p in plans:
        assert p["threads"] % 32 == 0 and p["threads"] <= 1024
        assert tl.has_build(p, Lp)
        if p["diagonals"] == "registers":
            assert p["rows"] * p["threads"] >= Lp and Lp % 32 == 0
        else:
            assert p in (tl.tiled_plan(tl.TILE_THREADS),
                         tl.tiled_plan(tl.PAIR_END_TILE_THREADS))
    got = [p for _t, p in blc.lane_plans(tl, Lp, pair_end=True)]
    assert got[0] == tl.linear_plan(Lp, pair_end=True)
    assert sorted(map(str, got)) == sorted(map(str, plans))


def test_lane_plans_add_the_tile_sweep():
    """--tiles T,...: each tiled build of the sweep once after the
    plan's builds, the builds' own tiles not repeated."""
    sweep = blc.tile_sweep("128,256,512")
    assert sweep == [128, 256, 512]
    plans = [p for _t, p in blc.lane_plans(tl, 4128, sweep)]
    assert plans == [tl.tiled_plan(256), tl.tiled_plan(128),
                     tl.tiled_plan(512)]
    plans = [p for _t, p in blc.lane_plans(tl, 4128, sweep, True)]
    assert plans == [tl.tiled_plan(128), tl.tiled_plan(256),
                     tl.tiled_plan(512)]
    plans = [p for _t, p in blc.lane_plans(tl, 2048, sweep)]
    assert len(plans) == 1 + 3 and plans[0] == tl.linear_plan(2048)


def test_bench_linear_calls_giant_runs_and_checks_on_cpu(tmp_path):
    """--giant at its small size: the gate pair, the mitochondrial-length
    pair and the global batch, each in its ordinary and its pair-end
    build, then held bit for bit against the outputs the first run
    saved; --tiles wants a card."""
    first = blc.main(["--device", "cpu", "--small", "--giant", "--save",
                      str(tmp_path)])
    names = ["gate 600x100", "pair 300", "300 rows"]
    assert [r["source"] for r in first] == [
        n + s for n in names for s in ("", " pair-end")]
    assert all(r["ms"] > 0 and r["same"] is None for r in first)
    again = blc.main(["--device", "cpu", "--small", "--giant", "--check",
                      str(tmp_path)])
    assert all(r["same"] for r in again)
    with pytest.raises(SystemExit, match="card only"):
        blc.main(["--device", "cpu", "--giant", "--tiles", "256"])


def test_giant_pairs_keep_chip_smokes_gate_pair():
    """The gate pair is chip_smoke.py's (default_rng(65536), its 1,023
    bp read at 20,000 with 10% of its sites redrawn); the second pair
    is 16,569 bp."""
    (gname, gate, read), (pname, left, right) = blc.giant_pairs()
    assert (len(gate), len(read)) == (65535, 1023)
    rng = np.random.default_rng(65536)
    base = rng.choice(list("ACGT"), size=65535)
    assert gate == "".join(base)
    same = np.array(list(read)) == base[20000:21023]
    assert 0.85 < same.mean() < 0.95
    assert len(left) == len(right) == 16569 and left != right


def test_bench_linear_calls_lanes_needs_a_card():
    with pytest.raises(SystemExit, match="card only"):
        blc.main(["--device", "cpu", "--lanes"])
