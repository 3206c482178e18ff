"""What kernel F's lane builds (csrc/viterbi_linear_probe.cu, kernel A's
Hopper layout) rest on, pinned on the CPU on the plain versions
probe_fill_plain and bisect_fill_plain:

- the warp skip (point 6 of the source): a warp of 32, 64 or 128 rows
  outside the diagonals [min(Ao, As + 1), max(Bo + 1, Bs + 2)] (its own
  rows' valid diagonals in [Ao, Bo], its source rows' in [As, Bs]) has
  code 0 and M, X, Y NEG on every cell, for every masked flag set of
  both tools, and the rule fails when its bounds are moved in by one;
- the circular roll: row 0's x and m code bits are the ones formed at
  row Lp - 1, so warp 0 must compute while that row is live;
- under NOMASK the rule does not hold, so those flag sets take no skip;
- F's launch plan is kernel A's, and a plan with no build is refused
  before anything is launched.

M, X, Y of every diagonal are read from one plain fill of each batch,
through the plain versions' per-diagonal capture (where the flag set
keeps the corner rows, the values the kernel can be held to)."""
import functools

import numpy as np
import pytest
import torch

from pagan2_tpu_torch.align import AlignSettings
from pagan2_tpu_torch.align import viterbi_linear as tl
from pagan2_tpu_torch.align import viterbi_linear_probe as VP
from pagan2_tpu_torch.align.viterbi_sheared import prepare_sheared
from pagan2_tpu_torch.graph import build_leaf_graph
from pagan2_tpu_torch.models import ModelFactory, alphabets as alph
from pagan2_tpu_torch.tools import bench_probe
from pagan2_tpu_torch.tools.bisect_linear import bisect_inputs

# rows a warp of the lane builds: 32 threads x 1, 2 or 4 rows
WARP_ROWS = (32, 64, 128)
# the flag sets with the masks on (the skip's), and those without
MASKED = [("probe", v) for v in VP.PROBE_VARIANTS if "nomask" not in v] + \
    [("bisect", v) for v in VP.BISECT_VARIANTS if "nomask" not in v]
UNMASKED = [("probe", "nomask"), ("bisect", "nomask"),
            ("bisect", "nobp,noroll,nomask")]


def _probe_batch():
    """probe_args of three ragged pairs (160, 121 and 62 rows against 31,
    61 and 46 columns): Lp 160, a bucket of whole warps; one job fills
    it (row Lp - 1 valid), the others end mid-warp."""
    rng = np.random.default_rng(21)
    model = ModelFactory(alph.DNA).alignment_model(0.2)
    inps = []
    for n1, n2 in ((159, 30), (120, 60), (61, 45)):
        base = rng.choice(list("ACGT"), size=n1)
        mut = base.copy()
        idx = rng.random(n1) < 0.1
        mut[idx] = rng.choice(list("ACGT"), size=int(idx.sum()))
        inps.append(tl._add_scalar_params(prepare_sheared(
            build_leaf_graph("".join(base), alph.DNA),
            build_leaf_graph("".join(mut[:n2]), alph.DNA), model,
            AlignSettings(), np.float32)))
    Lp = tl.batch_rows(inps)
    return VP.probe_args([tl.linear_job_arrays(x, Lp) for x in inps], "cpu")


def _batch(tool):
    """The tool's batch: the probe's above, or the bisect tool's random
    inputs at 2 x 96 rows x 256 diagonals (rows valid up to j = Lp, so
    row Lp - 1 is live from diagonal 95 on)."""
    return _probe_batch() if tool == "probe" else bisect_inputs(2, 96, 256,
                                                                "cpu")


def _fill(tool, variant, kw, capture):
    if tool == "probe":
        opts = () if variant == "base" else tuple(variant.split("+"))
        return VP.probe_fill_plain(**kw, opts=opts, capture=capture)
    return VP.bisect_fill_plain(**kw, variant=variant, capture=capture)


@functools.lru_cache(maxsize=None)
def _run(tool, variant):
    """(kw, codes (Dpk, B, Lp) or None where undefined, M, X, Y (B, Dpk,
    Lp) of every diagonal or None where not captured, NEG) of one flag
    set on the tool's batch."""
    kw = _batch(tool)
    cap = []
    bp, _fM, _fX, _fY = _fill(tool, variant, kw, cap)
    codes = None if tool == "probe" and "nobp" in variant else bp.numpy()
    vals = None
    if tool == "bisect" or "nocorner" not in variant:
        vals = [torch.stack([c[k] for c in cap], 1).numpy()
                for k in range(3)]
    neg = VP.PROBE_NEG if tool == "probe" else VP.BISECT_NEG
    return kw, codes, vals, np.float32(neg)


def _spans(vlo, vhi, Dpk, rows, roll, wrap=True):
    """The diagonals [first, last] on which each warp of `rows` rows
    computes, (B, warps) each, as the kernel finds them (point 6): row r
    valid on [r + vlo, r + vhi] (row 0 also on diagonal 0), clamped to
    [-4, Dpk + 4]; a warp's own rows and its source rows (its rows moved
    down one; with the roll row 0's is row Lp - 1, dropped if not
    `wrap`)."""
    B, Lp = vlo.shape
    r = np.arange(Lp)
    a = r + vlo.astype(np.int64)
    z = r + vhi.astype(np.int64)
    lo, hi = np.clip(a, -4, Dpk + 4), np.clip(z, -4, Dpk + 4)
    lo[a > z], hi[a > z] = Dpk + 8, -8
    lo[:, 0], hi[:, 0] = np.minimum(lo[:, 0], 0), np.maximum(hi[:, 0], 0)
    W = -(-Lp // rows)
    first = np.empty((B, W), np.int64)
    last = np.empty((B, W), np.int64)
    for w in range(W):
        own = np.arange(w * rows, min((w + 1) * rows, Lp))
        src = own - 1 if roll else own
        if roll and w == 0:
            src = src[1:] if not wrap else np.where(src < 0, Lp - 1, src)
        first[:, w] = np.minimum(lo[:, own].min(1), lo[:, src].min(1) + 1)
        last[:, w] = np.maximum(hi[:, own].max(1) + 1, hi[:, src].max(1) + 2)
    return first, last


def _skipped(kw, rows, roll, move=(0, 0), wrap=True):
    """(Dpk, B, Lp) mask of the cells the rule skips; `move` moves the
    bounds in by (first, last)."""
    Dpk, B, Lp = kw["ms"].shape
    first, last = _spans(kw["vlo"].numpy(), kw["vhi"].numpy(), Dpk, rows,
                         roll, wrap)
    w = np.arange(Lp) // rows
    d = np.arange(1, Dpk + 1)[:, None, None]
    return (d < first[None, :, w] + move[0]) | \
        (d > last[None, :, w] - move[1])


def _violations(tool, variant, rows, move=(0, 0)):
    """Cells the rule skips whose code is not 0 or whose M, X or Y is
    not NEG."""
    kw, codes, vals, neg = _run(tool, variant)
    skip = _skipped(kw, rows, "noroll" not in variant, move)
    n = 0
    if codes is not None:
        n += int((codes[skip] != 0).sum())
    if vals is not None:
        for v in vals:
            n += int((v.transpose(1, 0, 2)[skip] != neg).sum())
    return n


@pytest.mark.parametrize("tool,variant", MASKED,
                         ids=["%s-%s" % c for c in MASKED])
def test_skipped_warps_have_code_0_and_neg_values(tool, variant):
    """Every cell the kernel's warp skip leaves out has code 0 (where the
    flag set defines codes) and M, X, Y NEG (where it captures them), for
    warps of 32, 64 and 128 rows; the rule does skip cells."""
    kw, _codes, _vals, _neg = _run(tool, variant)
    for rows in WARP_ROWS:
        assert _skipped(kw, rows, "noroll" not in variant).any()
        assert _violations(tool, variant, rows) == 0


@pytest.mark.parametrize("tool,variant", [("probe", "base"),
                                          ("bisect", "full")])
@pytest.mark.parametrize("move", [(1, 0), (0, 1)],
                         ids=["first+1", "last-1"])
def test_skip_bounds_moved_in_by_one_fail(tool, variant, move):
    """The bounds are tight: moved in by one, the rule skips a cell with
    a code or a value, on some warp size. (Under NOROLL every row but row
    0 reads only itself and stays NEG, so nothing there can show it.)"""
    assert max(_violations(tool, variant, rows, move)
               for rows in WARP_ROWS) > 0


@pytest.mark.parametrize("tool,variant", [("probe", "base"),
                                          ("bisect", "full")])
def test_row_0_takes_its_x_and_m_bits_from_row_lp_minus_1(tool, variant):
    """The roll: row 0's bx and bm on diagonal d are formed at row Lp - 1
    from its M, X, Y on d - 1 and d - 2, its ol and its j-select (js = d
    - Lp); on diagonals past warp 0's own rows and its other source rows
    some are not 0, and only the wrap keeps warp 0 computing there."""
    kw, codes, (vm, vx, vy), neg = _run(tool, variant)
    Dpk, B, Lp = kw["ms"].shape
    f = kw["fscal"].numpy()
    R = kw["iscal"].numpy()[:, 0]
    ol = kw["ol"].numpy()
    first, last = _spans(kw["vlo"].numpy(), kw["vhi"].numpy(), Dpk, 32,
                         True)
    _f, last_own = _spans(kw["vlo"].numpy(), kw["vhi"].numpy(), Dpk, 32,
                          True, wrap=False)
    shown = 0
    for b in range(B):
        gext, gend, lgo, lng = f[b, :4]
        for d in range(1, Dpk + 1):
            def at(v, e):       # row Lp - 1 on diagonal e (NEG below 1)
                return v[b, e - 1, Lp - 1] if e >= 1 else neg
            m1, x1, y1 = at(vm, d - 1), at(vx, d - 1), at(vy, d - 1)
            m2, x2, y2 = at(vm, d - 2), at(vx, d - 2), at(vy, d - 2)
            js = d - Lp
            gj = gend if js == 0 or js == R[b] - 1 else gext
            cx0, cx1 = x1 + gj, y1 + lgo
            cx2 = (m1 + lng) + ol[b, Lp - 1]
            v01 = max(cx0, cx1)
            bx = 2 if cx2 > v01 else (1 if cx1 > cx0 else 0)
            t2 = m2 + lng
            u01 = max(t2, x2)
            bm = 2 if y2 > u01 else (1 if x2 > t2 else 0)
            assert codes[d - 1, b, 0] & 0x0F == bm | (bx << 2), (b, d)
            if bm | bx and d > last_own[b, 0]:
                assert d <= last[b, 0]
                shown += 1
    assert shown > 0


@pytest.mark.parametrize("tool,variant", UNMASKED,
                         ids=["%s-%s" % c for c in UNMASKED])
def test_the_skip_rule_does_not_hold_without_masks(tool, variant):
    """Under NOMASK values run on past every bound: the cells the rule
    would skip hold codes or values, so those flag sets take no skip."""
    assert min(_violations(tool, variant, rows)
               for rows in WARP_ROWS) > 0


@pytest.mark.parametrize("Lp", [32, 96, 128, 160, 2048, 2080, 4096, 4128,
                                4224])
def test_probe_plan_is_kernel_as_plan(Lp):
    """Kernel F takes kernel A's plan where A runs a lane build (up to
    2048 rows); past that, where A runs its tiled build, F keeps its own
    builds: four rows a thread up to 4096 rows, then its global build."""
    a = tl.linear_plan(Lp)
    p = VP.probe_plan(Lp)
    if a["diagonals"] == "registers":
        assert p == a
    elif Lp <= 4096 and Lp % 32 == 0:
        assert p == dict(rows=4, threads=tl._block(Lp, 4),
                         diagonals="registers")
    else:
        assert p == dict(rows=0, threads=min(1024, tl._block(Lp, 1)),
                         diagonals="global")
    assert VP.has_build(p, Lp)


@pytest.mark.parametrize("plan", [
    dict(rows=3, threads=64, diagonals="registers"),
    dict(rows=1, threads=32, diagonals="registers"),
    dict(rows=2, threads=2048, diagonals="registers"),
    dict(rows=4, threads=48, diagonals="registers"),
    dict(rows=0, threads=64, diagonals="registers"),
    dict(rows=2, threads=64, diagonals="global"),
    dict(rows=2, threads=256, diagonals="tiles")],
    ids=["rows3", "too_few_threads", "block_past_1024", "part_warp",
         "global_named_registers", "lanes_named_global", "kernel_as_tiles"])
def test_kernel_f_refuses_a_plan_with_no_build(plan):
    """Kernel F's launcher refuses a plan it has no build for before it
    loads or launches anything (so here, on the CPU, too)."""
    kw = bisect_inputs(2, 96, 64, "cpu")
    n0 = dict(VP.LAUNCHES)
    with pytest.raises(ValueError, match="no build"):
        VP._launch(plan, "viterbi_bisect_launch", "bisect:full", 0,
                   VP.BISECT_NEG, *(kw[k] for k in (
                       "fscal", "iscal", "gexti", "ol", "vlo", "vhi",
                       "ms")))
    assert VP.LAUNCHES == n0


def test_bench_probe_runs_and_checks_on_cpu(tmp_path):
    """tools/bench_probe.py at its small size: every flag set of both
    entry points once, then held against its own saved outputs."""
    first = bench_probe.main(["--device", "cpu", "--small", "--save",
                              str(tmp_path)])
    want = [("probe", v) for v in VP.PROBE_VARIANTS] + \
        [("bisect", v) for v in VP.BISECT_VARIANTS]
    assert [(r["tool"], r["variant"]) for r in first] == want
    assert all(r["ms"] > 0 and r["same"] is None for r in first)
    again = bench_probe.main(["--device", "cpu", "--small", "--check",
                              str(tmp_path)])
    assert all(r["same"] for r in again)
