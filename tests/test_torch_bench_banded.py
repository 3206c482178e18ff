"""The kernel-C bench (pagan2_tpu_torch/tools/bench_banded.py) on the
CPU at its small size: its megabase-generator pair through the CLI,
chip_smoke.py's band shapes and the wide shapes give one call each,
every call names its launch plan, and a second run is held bit for bit
against the digests the first one saved."""
import pytest

from pagan2_tpu_torch.align import viterbi_banded as VB
from pagan2_tpu_torch.tools import bench_banded


@pytest.fixture(scope="module")
def saved(tmp_path_factory):
    out = tmp_path_factory.mktemp("bench_banded")
    return out, bench_banded.main(["--device", "cpu", "--small", "--save",
                                   str(out)])


def test_bench_banded_runs_and_checks_on_cpu(saved):
    out, first = saved
    assert [r["source"] for r in first] == ["megabase"] + [
        s["name"] for s in bench_banded.band_shapes(small=True)
        + bench_banded.wide_shapes(small=True)]
    assert all(r["ms"] > 0 and r["same"] is None for r in first)
    again = bench_banded.main(["--device", "cpu", "--small", "--check",
                               str(out)])
    key = ("source", "Wk", "wmax", "Dn", "plan")
    assert [tuple(r[k] for k in key) for r in again] \
        == [tuple(r[k] for k in key) for r in first]
    assert all(r["same"] for r in again)


def test_bench_banded_calls_name_their_plans(saved):
    """Each call names kernel C's launch plan for its stripe width; the
    megabase generator's pair is anchored onto one banded fill of all
    its diagonals, whose window is far narrower than the stripe."""
    _out, first = saved
    for r in first:
        plan = VB.banded_plan(r["Wk"])
        assert r["plan"].startswith("%s, %d threads x %d rows, "
                                    % (plan["build"], plan["threads"],
                                       plan["rows_a_thread"]))
        assert r["wmax"] <= r["Wk"]
    mega = first[0]
    seqs, tree = bench_banded.megabase(3500)
    assert tree == "(a:0.1,b:0.1);"
    assert [len(s) for _n, s in seqs] == [3500, 3500]
    # L + R - 2 diagonals past the first, L = R = 3,501 sites
    assert mega["Dn"] == 2 * 3500 and mega["wmax"] < 128 == mega["Wk"]


def test_bench_banded_wide_shapes_fill_their_stripe_widths(saved):
    """Each wide shape is a whole band whose widest window rounds up to
    its named stripe width (WIDE_WK on the card; 256 and 384 here)."""
    _out, first = saved
    wide = [r for r in first if r["source"].startswith("Wk ")]
    assert [r["Wk"] for r in wide] == [256, 384]
    for r in wide:
        assert r["source"] == "Wk %d whole band" % r["Wk"]
        assert r["Wk"] - 128 < r["wmax"] <= r["Wk"]
    assert all(Wk % 128 == 0 and Wk > 512 for Wk in bench_banded.WIDE_WK)
