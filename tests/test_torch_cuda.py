"""The port's CUDA kernels against their plain PyTorch versions on the
card, and the CLI on CUDA against the CLI on the CPU. These tests need
an NVIDIA GPU and skip without one; run them there with

    python -m pytest tests/test_torch_cuda.py -m cuda
"""
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from pagan2_tpu_torch.align import AlignSettings, align_pair
from pagan2_tpu_torch.align import fullprob as fp
from pagan2_tpu_torch.align import fullprob_fill as ff
from pagan2_tpu_torch.align import viterbi_banded as tb
from pagan2_tpu_torch.align import viterbi_fanin as tf
from pagan2_tpu_torch.align import viterbi_linear as tl
from pagan2_tpu_torch.align import viterbi_linear_probe as VP
from pagan2_tpu_torch.align.viterbi_sheared import prepare_sheared
from pagan2_tpu_torch.graph import build_leaf_graph
from pagan2_tpu_torch.models import ModelFactory, alphabets as alph
from pagan2_tpu_torch.tools.bisect_linear import bisect_inputs
from pagan2_tpu_torch.tools.common import job_arrays, pair_jobs

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MODEL = ModelFactory(alph.DNA).alignment_model(0.2)

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (torch.cuda.is_available() is "
                    "False)")
    return torch.device("cuda")


def _related(rng, n, **kw):
    base = rng.choice(list("ACGT"), size=n)
    mut = base.copy()
    idx = rng.random(n) < 0.1
    mut[idx] = rng.choice(list("ACGT"), size=int(idx.sum()))
    return (build_leaf_graph("".join(base), alph.DNA, **kw),
            build_leaf_graph("".join(mut[3:]), alph.DNA, **kw))


def _bits(t):
    return t.contiguous().view(torch.int32)


# kernel A's batches: left sides, whether the right sides are cut short
# (keeps the plain version quick), whether each job has a band, and the
# build its plan must take (rows a thread of a lane build, or "tiles")
LINEAR_CASES = {
    "rows1": ([70], False, False, 1),
    "rows1_batch": ([100, 57, 29], False, False, 1),
    "rows2": ([1100, 700], False, False, 2),
    # 3,008 rows: four rows a thread until the tiled build took them
    "rows4": ([3000], True, False, "tiles"),
    "global": ([4200], True, False, "tiles"),
    "ragged": ([520, 90, 260], False, False, 2),
    "banded": ([600, 450], False, True, 2),
}


def _build(plan):
    return plan["rows"] if plan["diagonals"] == "registers" else "tiles"


def _tiled(rows):
    """The plan of a build by its rows a thread (0: the tiled build at
    its default tile)."""
    return lambda Lp: dict(rows=rows, threads=tl._block(Lp, rows),
                           diagonals="registers") if rows else \
        tl.tiled_plan(tl.TILE_THREADS)


def _linear_case(case, dev):
    sizes, short, banded, _rows = LINEAR_CASES[case]
    rng = np.random.default_rng(len(sizes) + 10 * list(LINEAR_CASES)
                                .index(case))
    pairs = [_related(rng, n) for n in sizes]
    if short:
        # a short partner keeps the plain version quick
        pairs = [(g1, build_leaf_graph("ACGTTGCA" * 8, alph.DNA))
                 for g1, _g2 in pairs]
    inps = [tl._add_scalar_params(prepare_sheared(
        *p, MODEL, AlignSettings(), np.float32)) for p in pairs]
    bands = [None] * len(inps)
    if banded:
        bands = []
        for x in inps:
            c = np.arange(x["L"]) * x["R"] // x["L"]
            bands.append((np.maximum(c - 30, 0),
                          np.minimum(c + 30, x["R"] - 1)))
    Lp = tl.batch_rows(inps)
    return tl.linear_batch_args([tl.linear_job_arrays(x, Lp, band=b)
                                 for x, b in zip(inps, bands)], dev)


@pytest.mark.parametrize("case", list(LINEAR_CASES))
def test_linear_kernel_matches_plain(cuda, case):
    """Kernel A against linear_fill_plain on the whole (B, D, Lp) codes
    array and the corner bits, on a batch that takes each build of its
    plan (one and two rows a thread; the tiled build past 2048 rows), a
    ragged batch (rows past a short job's L: skipped warps)
    and a banded one."""
    args = _linear_case(case, cuda)
    assert _build(tl.linear_plan(args["ms"].shape[2])) \
        == LINEAR_CASES[case][3]
    n0 = tl.LAUNCHES
    codes, corner = tl.linear_fill(**args)
    pc, pk = tl.linear_fill_plain(**args)
    torch.cuda.synchronize()
    assert tl.LAUNCHES == n0 + 1
    assert torch.equal(codes, pc)
    assert torch.equal(_bits(corner), _bits(pk))


@pytest.mark.parametrize("rows", [1, 2, 0])
def test_linear_every_build_matches_plain(cuda, rows):
    """Each build of kernel A (0: the tiled build), launched on one
    ragged banded batch (Lp 544) whatever its plan says, against
    linear_fill_plain."""
    args = _linear_case("ragged", cuda)
    Lp = args["ms"].shape[2]
    codes, corner = tl._launch_linear(_tiled(rows)(Lp), **args)
    pc, pk = tl.linear_fill_plain(**args)
    torch.cuda.synchronize()
    assert torch.equal(codes, pc)
    assert torch.equal(_bits(corner), _bits(pk))


def _raw_launch(args, codes, corner, rows, threads, tiled, edges=None,
                flags=None):
    """viterbi_linear_launch called past the wrapper's check."""
    import ctypes
    from pagan2_tpu_torch import kernels
    B, D, Lp = args["ms"].shape
    fn = kernels.load("viterbi_linear").viterbi_linear_launch
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * 12 + [ctypes.c_int] * 7 + \
        [ctypes.c_void_p]
    ins = [args[k].data_ptr() for k in ("ms", "gexti", "ol", "vlox",
                                         "vloy", "vhi", "fscal", "iscal")]
    return fn(*ins, codes.data_ptr(), corner.data_ptr(),
              0 if edges is None else edges.data_ptr(),
              0 if flags is None else flags.data_ptr(), B, D, Lp, rows,
              threads, tiled, 0, torch.cuda.current_stream().cuda_stream)


@pytest.mark.parametrize("rows,threads,tiled", [
    (3, 192, 0), (2, 128, 0), (1, 2048, 0), (4, 100, 0), (0, 1024, 0),
    (4, 160, 0), (4, 256, 1), (2, 48, 1), (2, 16, 1), (2, 2048, 1)])
def test_linear_kernel_refuses_plans_it_has_no_build_for(cuda, rows,
                                                         threads, tiled):
    """The kernel's own launcher (past the wrapper's check) refuses a
    plan it has no build for: cudaErrorInvalidValue, nothing launched
    (rows 0, the global build, and four rows a thread are gone; the
    tiled build takes two rows a thread in tiles of whole warps up to
    1024 threads)."""
    args = _linear_case("ragged", cuda)       # Lp 544
    B, D, Lp = args["ms"].shape
    codes = torch.zeros((B, D, Lp), dtype=torch.uint8, device=cuda)
    corner = torch.zeros((B, 3), device=cuda)
    edges = torch.zeros((B * 2, D, 4), device=cuda)
    flags = torch.zeros(1 + B * 2, dtype=torch.int32, device=cuda)
    err = _raw_launch(args, codes, corner, rows, threads, tiled, edges,
                      flags)
    torch.cuda.synchronize()
    assert err == 1                  # cudaErrorInvalidValue
    assert not bool(codes.any())


def _pair_end_batches():
    from pagan2_tpu_torch.tools.bench_linear_calls import pair_end_batches
    return pair_end_batches(MODEL)


@pytest.mark.parametrize("which", [0, 1], ids=["reduced", "full"])
@pytest.mark.parametrize("rows", [1, 2, 0])
def test_linear_pair_end_build_matches_plain(cuda, which, rows):
    """Kernel A's pair-end build, each build of its plan forced (0: the
    tiled build) on one ragged batch of pair-end jobs (break columns 0,
    1, mid, R - 2, R - 1 and none; with and without reduced terminal
    penalties), against linear_fill_plain: codes and corner bit-equal."""
    from pagan2_tpu_torch.tools.bench_linear_calls import batch_args
    _what, inps = _pair_end_batches()[which]
    args = batch_args(tl, inps, [None] * len(inps), cuda)
    assert args["pair_end"]
    Lp = args["ms"].shape[2]
    codes, corner = tl._launch_linear(_tiled(rows)(Lp), **args)
    pc, pk = tl.linear_fill_plain(**args)
    torch.cuda.synchronize()
    assert torch.equal(codes, pc)
    assert torch.equal(_bits(corner), _bits(pk))
    assert bool(torch.isfinite(corner).any(dim=1).all())


def test_linear_pair_end_global_plan_matches_plain(cuda):
    """Pair-end jobs past 4096 rows: the plan's tiled build, through
    linear_fill, against linear_fill_plain."""
    from pagan2_tpu_torch.tools.bench_linear_calls import batch_args
    _what, inps = _pair_end_batches()[2]
    args = batch_args(tl, inps, [None] * len(inps), cuda)
    assert tl.linear_plan(args["ms"].shape[2], pair_end=True) == \
        tl.tiled_plan(tl.PAIR_END_TILE_THREADS)
    n0, t0 = tl.LAUNCHES, tl.TILE_LAUNCHES
    codes, corner = tl.linear_fill(**args)
    pc, pk = tl.linear_fill_plain(**args)
    torch.cuda.synchronize()
    assert tl.LAUNCHES == n0 + 1 and tl.TILE_LAUNCHES == t0 + 1
    assert torch.equal(codes, pc)
    assert torch.equal(_bits(corner), _bits(pk))


# kernel A's tiled build: (left, right) sites of each job (right None: a
# copy of the left side cut by 3 with 10% of its sites redrawn), the
# band half-width, Lp (None: batch_rows), pair-end break columns (None:
# the ordinary build)
TILED_CASES = {
    "rows_4200": ([(4200, 1000)], None, None, None),
    "ragged_4100_9000_5000": ([(4100, 300), (9000, 300), (5000, 300)],
                              None, None, None),
    "banded_12000x700": ([(12000, 700)], 40, None, None),
    "square_6000": ([(6000, None)], None, None, None),
    # 4,416 rows: eight tiles of 512 and one of 320
    "partial_last_tile": ([(4400, 300)], None, None, None),
    # 4,501 rows: not a whole number of warps, odd (no vector loads)
    "odd_rows": ([(4500, 200), (3000, 150)], None, 4501, None),
    "pair_end_breaks": ([(4300, 200), (5000, 150), (4200, 120)], None,
                        None, (0, "mid", "R-1")),
}


def _tiled_args(case, dev):
    from dataclasses import replace
    pairs, w, Lp, breaks = TILED_CASES[case]
    rng = np.random.default_rng(100 + list(TILED_CASES).index(case))
    inps, bands = [], []
    for q, (n, m) in enumerate(pairs):
        base = rng.choice(list("ACGT"), size=n)
        mut = base.copy()
        idx = rng.random(n) < 0.1
        mut[idx] = rng.choice(list("ACGT"), size=int(idx.sum()))
        right = "".join(mut[3:]) if m is None else "".join(mut[:m])
        s = AlignSettings()
        if breaks is not None:
            R = len(right) + 1
            y = {"mid": R // 2, "R-1": R - 1}.get(breaks[q], breaks[q])
            s = replace(s, pair_end_reads=True, y_read1_length=y)
        inp = tl._add_scalar_params(prepare_sheared(
            build_leaf_graph("".join(base), alph.DNA),
            build_leaf_graph(right, alph.DNA), MODEL, s, np.float32))
        inps.append(inp)
        band = None
        if w is not None:
            c = np.arange(inp["L"]) * inp["R"] // inp["L"]
            band = (np.maximum(c - w, 0), np.minimum(c + w, inp["R"] - 1))
        bands.append(band)
    Lp = Lp or tl.batch_rows(inps)
    return tl.linear_batch_args([tl.linear_job_arrays(x, Lp, band=b)
                                 for x, b in zip(inps, bands)], dev)


@pytest.mark.parametrize("case", list(TILED_CASES))
def test_linear_tiled_build_matches_plain(cuda, case):
    """Kernel A's tiled build through linear_fill (its plan's build past
    2048 rows) against linear_fill_plain: codes torch.equal, corners
    bit-equal."""
    args = _tiled_args(case, cuda)
    assert tl.linear_plan(args["ms"].shape[2],
                          args["pair_end"])["diagonals"] == "tiles"
    assert args["pair_end"] == (TILED_CASES[case][3] is not None)
    n0 = tl.TILE_LAUNCHES
    codes, corner = tl.linear_fill(**args)
    pc, pk = tl.linear_fill_plain(**args)
    torch.cuda.synchronize()
    assert tl.TILE_LAUNCHES == n0 + 1
    assert torch.equal(codes, pc)
    assert torch.equal(_bits(corner), _bits(pk))
    assert bool(torch.isfinite(corner).any(dim=1).all())


@pytest.mark.parametrize("threads", [32, 64, 96, 128, 160, 256, 512,
                                     1024])
def test_linear_every_tile_matches_plain(cuda, threads):
    """The tiled build at every tile the bench's sweep takes
    (tools/bench_linear_calls.py --tiles: whole warps up to 1024
    threads), forced on one ragged batch of pair-end jobs, against
    linear_fill_plain."""
    args = _tiled_args("pair_end_breaks", cuda)
    codes, corner = tl._launch_linear(tl.tiled_plan(threads), **args)
    pc, pk = tl.linear_fill_plain(**args)
    torch.cuda.synchronize()
    assert torch.equal(codes, pc)
    assert torch.equal(_bits(corner), _bits(pk))


def test_linear_tiled_build_repeats_itself(cuda):
    """The guard against a race in the hand-off: an 8,000 x 8,000 pair
    (16 tiles of 512 rows, 32 of 256 or 63 of 128, most of them in
    flight together) launched twice at each of three tiles gives the
    same codes and corner every time."""
    rng = np.random.default_rng(8000)
    base = rng.choice(list("ACGT"), size=8000)
    mut = base.copy()
    idx = rng.random(8000) < 0.1
    mut[idx] = rng.choice(list("ACGT"), size=int(idx.sum()))
    inp = tl._add_scalar_params(prepare_sheared(
        build_leaf_graph("".join(base), alph.DNA),
        build_leaf_graph("".join(mut), alph.DNA), MODEL, AlignSettings(),
        np.float32))
    args = tl.linear_batch_args(
        [tl.linear_job_arrays(inp, tl.batch_rows([inp]))], cuda)
    ref = None
    for plan in (tl.tiled_plan(256), tl.tiled_plan(256), tl.tiled_plan(128),
                 tl.tiled_plan(128), tl.tiled_plan(64), tl.tiled_plan(64)):
        codes, corner = tl._launch_linear(plan, **args)
        torch.cuda.synchronize()
        if ref is None:
            ref = codes, corner
            assert bool(torch.isfinite(corner).any())
        else:
            assert torch.equal(codes, ref[0])
            assert torch.equal(_bits(corner), _bits(ref[1]))


@pytest.mark.parametrize("windowed", [False, True])
def test_fanin_kernel_matches_plain(cuda, windowed):
    rng = np.random.default_rng(5)
    g1, g2 = _related(rng, 150, homopolymer=True)
    inp = tf.prepare_fanin(g1, g2, MODEL, AlignSettings(), np.float32)
    kw = {}
    if windowed:
        L, R = inp["L"], inp["R"]
        D = L + R - 1
        kw = dict(W=32, ilo=np.clip(np.arange(D) // 2 - 16, 0, L - 1))
        c = np.arange(L) * R // L
        inp["band_upper"] = np.maximum(c - 12, 0).astype(np.int32)
        inp["band_lower"] = np.minimum(c + 12, R - 1).astype(np.int32)
    args = tf.fanin_batch_args([inp], cuda, **kw)
    n0 = tf.LAUNCHES
    bp, snap = tf.fanin_fill(**args)
    pb, ps = tf.fanin_fill_plain(**args)
    torch.cuda.synchronize()
    assert tf.LAUNCHES == n0 + 1
    assert torch.equal(bp, pb)
    assert torch.equal(_bits(snap), _bits(ps))


def _runs_graph(rng, n, run):
    """A leaf graph of n sites with no repeated base but one run of
    `run` bases: with --homopolymer its fan-in K and largest skip
    offset are both `run` (a plain linear graph when run is 1)."""
    s = [str(rng.choice(list("ACGT")))]
    while len(s) < n:
        s.append(str(rng.choice([c for c in "ACGT" if c != s[-1]])))
        if len(s) == n // 3:
            s += s[-1] * (run - 1)
    return build_leaf_graph("".join(s[:n]), alph.DNA, homopolymer=run > 1)


def _window(inp, W, step=2, jump=1):
    """A band of +-W/3 columns around the diagonal and window starts
    that advance `jump` rows every `step` diagonals."""
    L, R = inp["L"], inp["R"]
    D = L + R - 1
    c = np.arange(L) * R // L
    inp["band_upper"] = np.maximum(c - W // 3, 0).astype(np.int32)
    inp["band_lower"] = np.minimum(c + W // 3, R - 1).astype(np.int32)
    ilo = np.clip(np.arange(D) // step * jump - W // 2, 0, L - 1)
    return dict(W=W, ilo=ilo.astype(np.int32))


def _largest_shared_g(W, nf):
    G = 1
    while tf.launch_plan(W, G + 1, 1, 1, nf)["placement"] == "shared":
        G += 1
    return G


def _fanin_shape_case(case, rng):
    """(prep dicts, fanin_batch_args keywords, expected launch_plan
    entries) of one shape class of kernel B."""
    S = AlignSettings()

    def prep(n1, r1, n2, r2):
        return tf.prepare_fanin(_runs_graph(rng, n1, r1),
                                _runs_graph(rng, n2, r2), MODEL, S,
                                np.float32)
    if case.startswith("k"):                     # "k<KL>x<KR>"
        kl, kr = (int(v) for v in case[1:].split("x"))
        inp = prep(90, kl, 80, kr)
        assert (inp["KL"], inp["KR"]) == (kl, kr)
        templ = kl <= tf.TEMPLATE_K and kr <= tf.TEMPLATE_K
        return [inp], {}, dict(KL=kl if templ else 0, KR=kr if templ else 0)
    if case == "w32":
        inp = prep(300, 2, 280, 2)
        return [inp], _window(inp, 32), dict(threads=32, rows=1)
    if case == "w50":
        inp = prep(300, 3, 290, 2)
        return [inp], _window(inp, 50), dict(threads=64, rows=1)
    if case == "w1100":                          # more rows than threads
        inp = prep(1100, 3, 60, 3)
        return [inp], {}, dict(rows=3, placement="shared")
    if case in ("ring_shared", "ring_hot"):      # either side of 227 KB
        inp = prep(700, 2, 40, 2)
        G = _largest_shared_g(inp["L"], 15) + (case == "ring_hot")
        return [inp], dict(G=G), dict(
            placement="shared" if case == "ring_shared" else "hot")
    if case == "hot_split":
        inp = prep(1500, 4, 30, 4)
        return [inp], dict(G=40), dict(placement="hot", hot=12)
    if case == "global":
        inp = prep(6600, 2, 8, 1)
        return [inp], {}, dict(placement="global", hot=0)
    if case == "g1":
        inp = prep(120, 2, 110, 2)
        return [inp], dict(G=1), dict(hot=2)
    if case == "offsets_past_g":
        inp = prep(150, 4, 140, 3)
        return [inp], dict(G=3), dict(KL=4, KR=3)
    if case == "ilo_jumps":
        inp = prep(400, 3, 390, 2)
        return [inp], _window(inp, 96, step=6, jump=3), {}
    if case == "ragged_batch":
        return [prep(200, 3, 150, 2), prep(130, 2, 190, 3),
                prep(60, 1, 70, 1)], {}, dict(KL=3, KR=3)
    if case == "corner_beyond_d":
        inp = prep(100, 2, 90, 2)
        return [inp], dict(D=inp["L"] + inp["R"] - 6), {}
    raise ValueError(case)


FANIN_SHAPES = (["w32", "w50", "w1100", "ring_shared", "ring_hot",
                 "hot_split", "global", "g1", "offsets_past_g", "ilo_jumps",
                 "ragged_batch", "corner_beyond_d", "k6x2"]
                + ["k%dx%d" % (kl, kr) for kl in range(1, 5)
                   for kr in range(1, 5)])


@pytest.mark.parametrize("case", FANIN_SHAPES)
def test_fanin_kernel_shape_classes(cuda, case):
    """Kernel B against its plain version on each shape class of its
    launch plan: codes equal, corner snapshots bit-equal."""
    rng = np.random.default_rng(sum(map(ord, case)))
    inps, kw, want = _fanin_shape_case(case, rng)
    args = tf.fanin_batch_args(inps, cuda, **kw)
    plan = tf.launch_plan(args["W"], args["G"], args["loff"].shape[2],
                          args["roff"].shape[2], args["table"].shape[1])
    assert {k: plan[k] for k in want} == want
    n0 = tf.LAUNCHES
    bp, snap = tf.fanin_fill(**args)
    pb, ps = tf.fanin_fill_plain(**args)
    torch.cuda.synchronize()
    assert tf.LAUNCHES == n0 + 1
    assert torch.equal(bp, pb), int((bp != pb).sum())
    assert torch.equal(_bits(snap), _bits(ps))
    assert bool(torch.isfinite(snap).any()) == (case != "corner_beyond_d")


@pytest.mark.parametrize("W, ahead, built", [(50, 1, True), (50, 3, False),
                                             (300, 2, False)])
def test_fanin_kernel_takes_only_plans_it_has_built(cuda, monkeypatch, W,
                                                    ahead, built):
    """The kernel launches the build that launch_plan's `ahead` names
    (one cell ahead in a small block: bit-equal) and refuses a plan
    with no build (three ahead; two ahead past 256 threads): the
    wrapper raises and counts no launch."""
    rng = np.random.default_rng(W + ahead)
    inp = tf.prepare_fanin(_runs_graph(rng, 300, 3), _runs_graph(rng, 290, 2),
                           MODEL, AlignSettings(), np.float32)
    args = tf.fanin_batch_args([inp], cuda, **_window(inp, W))
    plan = tf.launch_plan
    monkeypatch.setattr(tf, "launch_plan",
                        lambda *a: dict(plan(*a), ahead=ahead))
    n0 = tf.LAUNCHES
    if not built:
        with pytest.raises(RuntimeError, match="viterbi_fanin launch"):
            tf.fanin_fill(**args)
        assert tf.LAUNCHES == n0
        return
    bp, snap = tf.fanin_fill(**args)
    pb, ps = tf.fanin_fill_plain(**args)
    torch.cuda.synchronize()
    assert tf.LAUNCHES == n0 + 1
    assert torch.equal(bp, pb)
    assert torch.equal(_bits(snap), _bits(ps))


@pytest.mark.parametrize("half", [20, 300])
def test_banded_kernel_matches_plain(cuda, half):
    """Kernel C on a narrow window (one warp) and a window of more than
    128 rows (several warps, block barriers)."""
    rng = np.random.default_rng(7)
    g1, g2 = _related(rng, 1500)
    L, R = g1.num_sites() - 1, g2.num_sites() - 1
    c = np.arange(L) * R // L
    args, meta = tb.banded_args(g1, g2, MODEL, AlignSettings(),
                                np.maximum(c - half, 0),
                                np.minimum(c + half, R - 1), cuda)
    assert (meta["w"].max() > 128) == (half == 300)
    n0 = tb.LAUNCHES
    codes, corner = tb.banded_fill(**args)
    pc, pk = tb.banded_fill_plain(**args)
    torch.cuda.synchronize()
    assert tb.LAUNCHES == n0 + 1
    assert torch.equal(codes, pc)
    assert torch.equal(_bits(corner), _bits(pk))
    assert bool(torch.isfinite(corner).any())


def _banded_pair(rng, n, half, sub=0.1, Wk=None, **kw):
    """banded_args of an n bp pair (sub substitutions) over a band of
    half-width `half` about the diagonal (None: the whole matrix);
    with Wk, the stripe is widened to Wk columns (zeros past the
    window) and its schedule remade for it."""
    base = rng.choice(list("ACGT"), size=n)
    mut = base.copy()
    idx = rng.random(n) < sub
    mut[idx] = rng.choice(list("ACGT"), size=int(idx.sum()))
    g1 = build_leaf_graph("".join(base), alph.DNA)
    g2 = build_leaf_graph("".join(mut[3:]), alph.DNA)
    L, R = g1.num_sites() - 1, g2.num_sites() - 1
    c = np.arange(L) * R // L
    band = ((np.zeros(L, np.int64), np.full(L, R - 1)) if half is None
            else (np.maximum(c - half, 0), np.minimum(c + half, R - 1)))
    args, meta = tb.banded_args(g1, g2, MODEL, AlignSettings(), *band,
                                "cuda")
    if Wk is not None:
        ms = torch.zeros((args["ms"].shape[0], Wk), dtype=torch.float32,
                         device="cuda")
        ms[:, :args["ms"].shape[1]] = args["ms"]
        args["ms"] = ms
        args["sched"] = torch.from_numpy(
            tb.band_sched(meta["ilo"], meta["w"], Wk)).cuda()
    return args


def _banded_case(case, rng):
    """kernel C's arguments on the card for one class of input."""
    from dataclasses import replace
    from pagan2_tpu_torch.align.oracle import mark_no_gap_penalty_sites
    if case == "offset_jumps":
        # window starts that jump far past +-1 (up and down), widths
        # from 0, and offsets past +-Wk: clipped to +-Wk, or no source
        args = _banded_pair(rng, 150, None)
        Dn, Wk = args["ms"].shape
        ilo = np.concatenate([[0], np.cumsum(rng.integers(-3, 200, Dn))])
        w = rng.integers(0, 100, Dn + 1)
        sched = torch.from_numpy(tb.band_sched(ilo % 140, w, Wk))
        sched[::7, 2] = 100000
        sched[::11, 3] = -100000
        sched[::13, 4] = Wk
        sched[::17, 4] = -Wk
        args["sched"] = sched.cuda()
        return args
    if case == "pair_end":
        r1, r2, mid = ("".join(rng.choice(list("ACGT"), k))
                       for k in (40, 40, 30))
        g1 = build_leaf_graph(r1 + mid + r2, alph.DNA)
        g2 = build_leaf_graph(r1 + "0" + r2, alph.DNA, quality="I" * 81)
        s = replace(AlignSettings(), pair_end_reads=True)
        s = replace(s, x_read1_length=mark_no_gap_penalty_sites(g1),
                    y_read1_length=mark_no_gap_penalty_sites(g2))
        L, R = g1.num_sites() - 1, g2.num_sites() - 1
        args, _m = tb.banded_args(g1, g2, MODEL, s, np.zeros(L, np.int64),
                                  np.full(L, R - 1), "cuda")
        assert int(args["iscal"][2]) >= 0 or int(args["iscal"][3]) >= 0
        return args
    if case == "dead_end":
        base = "".join(rng.choice(list("ACGT"), 300))
        g1 = build_leaf_graph(base, alph.DNA)
        g2 = build_leaf_graph("ACGT" * 5 + base, alph.DNA)
        L = g1.num_sites() - 1
        args, _m = tb.banded_args(g1, g2, MODEL, AlignSettings(),
                                  np.zeros(L, np.int64),
                                  np.full(L, 3, np.int64), "cuda")
        return args
    if case == "corner_last_cell":
        # the call cut to its first 400 diagonals, the corner moved to
        # the last in-window cell of the last one
        args = _banded_pair(rng, 600, 40)
        n = 400
        args = {"fscal": args["fscal"], "sched": args["sched"][:n],
                "ms": args["ms"][:n], "iscal": args["iscal"].clone()}
        args["iscal"][4] = n
        args["iscal"][5] = args["sched"][-1, 1] - 1
        return args
    if case == "narrow_in_wide":
        return _banded_pair(rng, 500, 15, Wk=384)
    raise ValueError(case)


def _global_banded_plan(Wk):
    """The block kernel with its ring in global scratch, on a stripe Wk
    wide (banded_plan takes it only past the shared budget)."""
    return dict(tb.block_plan(Wk), build="global", stage=0, smem=0)


def _forced_banded_plan(build, Wk):
    """A plan of the named build for a stripe Wk wide."""
    return {"window": tb.banded_plan, "block": tb.block_plan,
            "global": _global_banded_plan}[build](Wk)


def _banded_forced(monkeypatch, args, plan):
    """Kernel C launched on `plan` against its plain version: codes
    equal, corner bit-equal, one launch; returns the corner."""
    monkeypatch.setattr(tb, "banded_plan", lambda Wk: plan)
    n0 = tb.LAUNCHES
    codes, corner = tb.banded_fill(**args)
    pc, pk = tb.banded_fill_plain(**args)
    torch.cuda.synchronize()
    assert tb.LAUNCHES == n0 + 1
    assert torch.equal(codes, pc), int((codes != pc).sum())
    assert torch.equal(_bits(corner), _bits(pk))
    return corner


BANDED_BUILDS = ["window", "block", "global"]
BANDED_CASES = ["offset_jumps", "pair_end", "dead_end", "corner_last_cell",
                "narrow_in_wide"]


@pytest.mark.parametrize("build", BANDED_BUILDS)
@pytest.mark.parametrize("case", BANDED_CASES)
def test_banded_kernel_builds_match_plain(cuda, monkeypatch, case, build):
    """Each build of kernel C (the window kernel; the block kernel; its
    global ring) on each class of input: offsets far past +-1 and
    clipped at +-Wk, pair-end breaks, a dead end, the corner at the last
    in-window cell, and a window well below the stripe width (the
    window kernel's blocks of rows past it skipped)."""
    args = _banded_case(case, np.random.default_rng(len(case)))
    Dn, Wk = args["ms"].shape
    plan = _forced_banded_plan(build, Wk)
    assert plan["build"] == build
    if case == "narrow_in_wide":
        assert 4 * int(args["sched"][:, 1].max()) < Wk
    corner = _banded_forced(monkeypatch, args, plan)
    # the synthetic schedule and the dead end reach no corner
    assert bool(torch.isfinite(corner).any()) == (
        case not in ("offset_jumps", "dead_end"))


@pytest.mark.parametrize("threads, rpt", [
    (t, r) for t, rpts in sorted(tb.WINDOW_BUILDS.items()) for r in rpts])
def test_banded_window_kernel_every_template(cuda, threads, rpt):
    """Every window-kernel instantiation (128 threads of 1, 3, 5 or 7
    positions, 256 threads of 1-5), through banded_plan, on a band whose
    widest window reaches the stripe's last block of rows."""
    Wk = threads * rpt
    rng = np.random.default_rng(Wk + rpt)
    args = _banded_pair(rng, Wk + 200, Wk - 65, sub=0.05)
    wmax = int(args["sched"][:, 1].max())
    assert args["ms"].shape[1] == Wk and Wk - threads < wmax <= Wk
    plan = tb.banded_plan(Wk)
    assert (plan["build"], plan["threads"], plan["rows_a_thread"]) == (
        "window", threads, rpt)
    n0 = tb.LAUNCHES
    codes, corner = tb.banded_fill(**args)
    pc, pk = tb.banded_fill_plain(**args)
    torch.cuda.synchronize()
    assert tb.LAUNCHES == n0 + 1
    assert torch.equal(codes, pc), int((codes != pc).sum())
    assert torch.equal(_bits(corner), _bits(pk))
    assert bool(torch.isfinite(corner).any())


# plans kernel C has no build for, on a stripe of 512 columns
BANDED_REFUSED = {
    "window_not_built": lambda: dict(tb.window_plan(512, 128),
                                     rows_a_thread=4),
    "window_short": lambda: dict(tb.window_plan(512, 256),
                                 rows_a_thread=1),
    "window_64_threads": lambda: tb.window_plan(512, 64),
    "smem_mismatch": lambda: dict(tb.window_plan(512, 256), smem=1024),
    "stage_past_32": lambda: dict(tb.window_plan(512, 256), stage=64),
    "block_unstaged": lambda: dict(tb.block_plan(512), stage=0),
    "block_threads": lambda: dict(tb.block_plan(512), threads=256),
    "global_staged": lambda: dict(_global_banded_plan(512), stage=16),
    "unknown_build": lambda: dict(tb.window_plan(512, 256),
                                  build="nonesuch"),
}


@pytest.mark.parametrize("name", list(BANDED_REFUSED))
def test_banded_kernel_takes_only_plans_it_has_built(cuda, monkeypatch,
                                                     name):
    """A plan kernel C has no build for (128 threads of 4 positions; 256
    threads short of the stripe; 64 threads; shared bytes that do not
    match; a chunk past 32 diagonals; a staged block with no chunk, or
    short of min(1024, Wk) threads; a global ring with a chunk; an
    unknown build) is refused: the wrapper raises and counts no launch,
    and the next launch is not disturbed."""
    rng = np.random.default_rng(9)
    args = _banded_pair(rng, 400, 20, Wk=512)
    plan = BANDED_REFUSED[name]()
    with monkeypatch.context() as m:
        m.setattr(tb, "banded_plan", lambda Wk: plan)
        m.setattr(tb, "BUILDS", tb.BUILDS + ("nonesuch",))
        n0 = tb.LAUNCHES
        with pytest.raises(RuntimeError, match="viterbi_banded launch"):
            tb.banded_fill(**args)
        assert tb.LAUNCHES == n0
    codes, corner = tb.banded_fill(**args)
    pc, pk = tb.banded_fill_plain(**args)
    torch.cuda.synchronize()
    assert tb.LAUNCHES == n0 + 1
    assert torch.equal(codes, pc)
    assert torch.equal(_bits(corner), _bits(pk))


def _same_fills(out, ref):
    """Planes bit-equal; cum within D * eps * max(1, |cum|)."""
    (planes, cum), (pp, pc) = out, ref
    assert torch.equal(_bits(planes), _bits(pp))
    D = cum.shape[1]
    tol = D * 1.1920929e-07 * max(1.0, float(pc.abs().max()))
    assert float((cum - pc).abs().max()) <= tol


@pytest.mark.parametrize("sizes", [[70], [300, 257, 129], [4200]])
def test_fullprob_linear_kernels_match_plain(cuda, sizes):
    """Kernels D and E, linear entry points: one pair, a ragged batch,
    and a left side past 4096 lanes (the cluster build)."""
    rng = np.random.default_rng(len(sizes))
    pairs = [_related(rng, n) for n in sizes]
    if sizes == [4200]:
        pairs = [(pairs[0][0], build_leaf_graph("ACGTTGCA" * 8,
                                                alph.DNA))]
    inps = [fp.linear_fullprob_inputs(*p, MODEL) for p in pairs]
    args = ff.linear_batch_args(inps, cuda)
    assert (ff.fwd_linear_plan(args["ms2"].shape[2])["cluster"] > 0) \
        == (sizes == [4200])
    n0 = dict(ff.LAUNCHES)
    fwd = ff.fullprob_fwd(**args)
    bwd = ff.fullprob_bwd(**args)
    torch.cuda.synchronize()
    assert ff.LAUNCHES["fullprob_fwd"] == n0["fullprob_fwd"] + 1
    assert ff.LAUNCHES["fullprob_bwd"] == n0["fullprob_bwd"] + 1
    _same_fills(fwd, ff.fullprob_fwd_plain(**args))
    _same_fills(bwd, ff.fullprob_bwd_plain(**args))
    assert float(fwd[0].max()) == 1.0 and float(bwd[0].max()) == 1.0


def test_fullprob_linear_kernels_past_65535_pairs(cuda):
    """Kernels D and E, linear lane build, on one launch of 65,537
    pairs (the batch lies along grid x; the executor's smallest
    full-probability bucket, 32 x 32, takes up to 65,536 pairs): seven
    pairs of different lengths in turn, planes bit-equal to the plain
    version, so pair 65,536 is its own."""
    rng = np.random.default_rng(65537)
    inps = [fp.linear_fullprob_inputs(*_related(rng, n), MODEL)
            for n in (12, 15, 17, 20, 22, 25, 27)]
    one = ff.linear_batch_args(inps, cuda)
    pick = torch.arange(65537, device=cuda) % len(inps)
    args = {k: v[pick].contiguous() for k, v in one.items()}
    for entry in ("fullprob_fwd", "fullprob_bwd"):
        out = getattr(ff, entry)(**args)
        torch.cuda.synchronize()
        _same_fills(out, getattr(ff, entry + "_plain")(**args))
        assert torch.equal(_bits(out[0][65536]), _bits(out[0][65536 % 7]))


@pytest.mark.parametrize("case", ["homopolymer", "ancestors", "wide"])
def test_fullprob_fanin_kernels_match_plain(cuda, case):
    """Kernels D and E, fan-in entry points: homopolymer graphs (ring in
    shared memory), ancestors with a 12-bp deletion edge (deep ring),
    and 1,600-site graphs whose ring does not fit shared memory (kernel
    D keeps its newest diagonals there, all of them in global
    scratch)."""
    rng = np.random.default_rng(5)
    if case == "ancestors":
        base = rng.choice(list("ACGT"), size=200)
        leaves = []
        for k in range(4):
            mut = base.copy()
            idx = rng.random(200) < 0.1
            mut[idx] = rng.choice(list("ACGT"), size=int(idx.sum()))
            s = "".join(mut)
            if k % 2:
                s = s[:66] + s[78:]
            leaves.append(build_leaf_graph(s, alph.DNA))
        g1 = align_pair(leaves[0], leaves[1], MODEL, AlignSettings(),
                        device=cuda)[0]
        g2 = align_pair(leaves[2], leaves[3], MODEL, AlignSettings(),
                        device=cuda)[0]
    else:
        g1, g2 = _related(rng, 1600 if case == "wide" else 150,
                          homopolymer=True)
    inp = fp.fanin_fullprob_inputs(g1, g2, MODEL)
    fkw, bkw = ff.fanin_batch_args([inp], cuda)
    if case == "ancestors":
        assert fkw["G"] >= 14
    lo, ro = fkw["loff"], fkw["roff"]
    plan = ff.fwd_fanin_plan(lo.shape[1], fkw["G"], lo.shape[2],
                             ro.shape[2], ro.shape[1])
    assert (plan["placement"] != "shared") == (case == "wide")
    n0 = dict(ff.LAUNCHES)
    fwd = ff.fullprob_fwd_fanin(**fkw)
    bwd = ff.fullprob_bwd_fanin(**bkw)
    torch.cuda.synchronize()
    assert ff.LAUNCHES["fullprob_fwd_fanin"] == n0["fullprob_fwd_fanin"] + 1
    assert ff.LAUNCHES["fullprob_bwd_fanin"] == n0["fullprob_bwd_fanin"] + 1
    _same_fills(fwd, ff.fullprob_fwd_fanin_plain(**fkw))
    _same_fills(bwd, ff.fullprob_bwd_fanin_plain(**bkw))
    assert float(fwd[0].max()) == 1.0 and float(bwd[0].max()) == 1.0



def _fwd_graph(rng, n, k=1, seeds=1, skip=0):
    """A leaf graph of n sites whose every 7th site also has forward
    edges to +2 .. +k (forward fan-in k), with seeds - 1 extra edges
    into the stop site (seed depth `seeds`) and, given `skip`, a few
    forward edges `skip` sites long (ring depth past it)."""
    g = build_leaf_graph("".join(rng.choice(list("ACGT"), n)), alph.DNA)
    for i in range(1, n - k, 7):
        for o in range(2, k + 1):
            g.add_edge(i, i + o, 0.05 * o)
    for i in range(n // 3, n - skip, max(1, n // 4)) if skip else ():
        g.add_edge(i, i + skip, 0.1)
    for s in range(2, seeds + 1):
        g.add_edge(n + 1 - s, n + 1, 0.2)
    return g


def _bwd_shape_case(case, rng):
    """(entry point, its keywords, expected plan entries) of one shape
    class of kernel E."""
    if case.startswith("linear"):
        sizes = {"linear_rows1": [100], "linear_rows2": [1100, 700],
                 "linear_rows4": [3000], "linear_global": [4300],
                 "linear_ragged": [520, 90, 260]}[case]
        pairs = [(build_leaf_graph("".join(rng.choice(list("ACGT"), n)),
                                   alph.DNA),
                  build_leaf_graph("".join(rng.choice(list("ACGT"),
                                                      min(n, 400))),
                                   alph.DNA)) for n in sizes]
        kw = ff.linear_batch_args([fp.linear_fullprob_inputs(*p, MODEL)
                                   for p in pairs], "cuda")
        want = {"linear_rows1": dict(rows=1), "linear_rows2": dict(rows=2),
                # past 2,048 lanes: the cluster build
                "linear_rows4": dict(rows=2, cluster=8),
                # past 4,096 lanes: the cluster build
                "linear_global": dict(rows=2, cluster=8),
                "linear_ragged": dict(rows=2, cluster=0)}[case]
        return "linear", kw, want
    G = None
    if case.startswith("k"):                     # "k<KL>x<KR>"
        kl, kr = (int(v) for v in case[1:].split("x"))
        g = [(_fwd_graph(rng, 90, kl), _fwd_graph(rng, 80, kr))]
        templ = max(kl, kr) <= ff.TEMPLATE_K
        want = dict(KL=kl if templ else 0, KR=kr if templ else 0,
                    placement="shared", rtab=True)
    elif case == "ring_hot":                     # H < G + 1
        g = [(_fwd_graph(rng, 1100, 2), _fwd_graph(rng, 60, 2))]
        G, want = 40, dict(placement="hot", rows=2)
    elif case == "ring_global":                  # no diagonal on chip
        g = [(_fwd_graph(rng, 6600, 2), _fwd_graph(rng, 30, 1))]
        want = dict(placement="global", hot=0, rows=0)
    elif case == "rows4":                        # K 2 x 2 past 1536 lanes
        g = [(_fwd_graph(rng, 1800, 2), _fwd_graph(rng, 50, 2))]
        want = dict(rows=4, KL=2, KR=2)
    elif case == "rows0_k3":                     # past 768 lanes at K 3
        g = [(_fwd_graph(rng, 1800, 3), _fwd_graph(rng, 50, 2))]
        want = dict(rows=0, KL=0, KR=0)
    elif case == "rows0_shared":                 # runtime lanes, whole ring
        g = [(_fwd_graph(rng, 2500, 1), _fwd_graph(rng, 40, 1))]
        want = dict(rows=0, placement="shared")
    elif case == "rtab_device":                  # right slots too many
        g = [(_fwd_graph(rng, 40, 2), _fwd_graph(rng, 15000, 2))]
        want = dict(rtab=False, KL=2, KR=2)
    elif case == "ragged_batch":
        g = [(_fwd_graph(rng, 200, 3), _fwd_graph(rng, 150, 2)),
             (_fwd_graph(rng, 130, 1), _fwd_graph(rng, 190, 3, seeds=2)),
             (_fwd_graph(rng, 60, 2), _fwd_graph(rng, 70, 1))]
        want = dict(KL=3, KR=3)
    elif case == "seed_depth":
        g = [(_fwd_graph(rng, 120, 2, seeds=3), _fwd_graph(rng, 100, 2))]
        want = {}
    elif case == "deep_ring":
        g = [(_fwd_graph(rng, 300, 2, skip=44), _fwd_graph(rng, 260, 2))]
        want = {}
    elif case == "offsets_past_g":
        g = [(_fwd_graph(rng, 150, 4), _fwd_graph(rng, 140, 3))]
        G, want = 3, dict(KL=4, KR=3)
    else:
        raise ValueError(case)
    _f, kw = ff.fanin_batch_args([fp.fanin_fullprob_inputs(a, b, MODEL)
                                  for a, b in g], "cuda", G=G)
    if case == "seed_depth":
        assert kw["seed"].shape[1] == 3
    if case == "deep_ring":
        assert kw["G"] >= 42
    return "fanin", kw, want


BWD_SHAPES = (["linear_rows1", "linear_rows2", "linear_rows4",
               "linear_global", "linear_ragged", "ring_hot", "ring_global",
               "rows4", "rows0_k3", "rows0_shared", "rtab_device",
               "ragged_batch", "seed_depth", "deep_ring", "offsets_past_g",
               "k6x2"]
              + ["k%dx%d" % (kl, kr) for kl in range(1, 5)
                 for kr in range(1, 5)])


@pytest.mark.parametrize("case", BWD_SHAPES)
def test_fullprob_bwd_shape_classes(cuda, case):
    """Kernel E against its plain version on each shape class of its
    launch plans: every templated fan-in and the runtime-K build, each
    ring placement (shared, a hot split, global), one and two lanes a
    thread (fan-in two, and four up to K 2 x 2), the linear cluster
    build (two cases) and the fan-in build for any count, the right-slot
    table in shared and in device memory, ragged batches, seed depth 3,
    a deep ring and offsets past G; planes bit-equal, cum within D *
    eps * max(1, |cum|)."""
    rng = np.random.default_rng(sum(map(ord, case)))
    kind, kw, want = _bwd_shape_case(case, rng)
    if kind == "linear":
        plan = ff.bwd_linear_plan(kw["ms2"].shape[2])
        fn, plain, name = ff.fullprob_bwd, ff.fullprob_bwd_plain, \
            "fullprob_bwd"
    else:
        lo, ro = kw["lfoff"], kw["rfoff"]
        plan = ff.bwd_fanin_plan(lo.shape[1], kw["G"], lo.shape[2],
                                 ro.shape[2], ro.shape[1])
        fn, plain, name = ff.fullprob_bwd_fanin, \
            ff.fullprob_bwd_fanin_plain, "fullprob_bwd_fanin"
    assert {k: plan[k] for k in want} == want
    n0 = ff.LAUNCHES[name]
    out = fn(**kw)
    ref = plain(**kw)
    torch.cuda.synchronize()
    assert ff.LAUNCHES[name] == n0 + 1
    _same_fills(out, ref)
    assert float(out[0].max()) == 1.0


@pytest.mark.parametrize("entry, change", [
    ("fanin", dict(rows=3)),
    ("fanin", dict(rows=4, threads=384, KL=0, KR=0)),
    ("fanin", dict(KL=5, KR=5)),
    ("fanin", dict(threads=1024)), ("fanin", dict(rows=0)),
    ("linear", dict(rows=3)), ("linear", dict(cluster=1))])
def test_fullprob_bwd_takes_only_plans_it_has_built(cuda, monkeypatch,
                                                    entry, change):
    """Kernel E refuses a plan it has no build for (three lanes a
    thread; four lanes with runtime K; a fan-in past 4 x 4 as a
    template; 1024 threads of two lanes
    at K 2 x 2; the build for any lane count with a templated fan-in;
    a linear cluster of one CTA): the wrapper raises and counts no
    launch, and the next launch is not disturbed."""
    rng = np.random.default_rng(3)
    if entry == "fanin":
        _f, kw = ff.fanin_batch_args([fp.fanin_fullprob_inputs(
            _fwd_graph(rng, 1500, 2), _fwd_graph(rng, 60, 2), MODEL)],
            "cuda")
        fn, name, planner = ff.fullprob_bwd_fanin, "fullprob_bwd_fanin", \
            "bwd_fanin_plan"
    else:
        kw = ff.linear_batch_args([fp.linear_fullprob_inputs(
            *_related(rng, 1500), MODEL)], "cuda")
        fn, name, planner = ff.fullprob_bwd, "fullprob_bwd", \
            "bwd_linear_plan"
    plan = getattr(ff, planner)
    with monkeypatch.context() as m:
        m.setattr(ff, planner, lambda *a: dict(plan(*a), **change))
        n0 = ff.LAUNCHES[name]
        with pytest.raises(RuntimeError, match="fullprob_bwd.* launch"):
            fn(**kw)
        assert ff.LAUNCHES[name] == n0
    out = fn(**kw)
    torch.cuda.synchronize()
    assert ff.LAUNCHES[name] == n0 + 1
    assert float(out[0].max()) == 1.0

def _bwd_graph(rng, n, k=1):
    """A leaf graph of n sites whose every 7th site from k + 1 on also
    has backward edges from -2 .. -k (backward fan-in k, the slots
    kernel D reads)."""
    g = build_leaf_graph("".join(rng.choice(list("ACGT"), n)), alph.DNA)
    for i in range(k + 1, n + 1, 7):
        for o in range(2, k + 1):
            g.add_edge(i - o, i, 0.05 * o)
    return g


def _fwd_shape_case(case, rng):
    """(entry point, its keywords, expected plan entries) of one shape
    class of kernel D."""
    if case.startswith("linear"):
        sizes = {"linear_rows1": [100], "linear_rows2": [1100, 700],
                 "linear_rows4": [3000], "linear_global": [4300],
                 "linear_ragged": [520, 90, 260]}[case]
        pairs = [(build_leaf_graph("".join(rng.choice(list("ACGT"), n)),
                                   alph.DNA),
                  build_leaf_graph("".join(rng.choice(list("ACGT"),
                                                      min(n, 400))),
                                   alph.DNA)) for n in sizes]
        kw = ff.linear_batch_args([fp.linear_fullprob_inputs(*p, MODEL)
                                   for p in pairs], "cuda")
        want = {"linear_rows1": dict(rows=1), "linear_rows2": dict(rows=2),
                # past 2,048 lanes: the cluster build
                "linear_rows4": dict(rows=2, cluster=8),
                # past 4,096 lanes: the cluster build
                "linear_global": dict(rows=2, cluster=8),
                "linear_ragged": dict(rows=2, cluster=0)}[case]
        return "linear", kw, want
    G = None
    if case.startswith("k"):                     # "k<KL>x<KR>"
        kl, kr = (int(v) for v in case[1:].split("x"))
        g = [(_bwd_graph(rng, 90, kl), _bwd_graph(rng, 80, kr))]
        templ = max(kl, kr) <= ff.TEMPLATE_K
        want = dict(KL=kl if templ else 0, KR=kr if templ else 0,
                    placement="shared", rtab=True)
    elif case == "ring_hot":                     # H < G + 1
        g = [(_bwd_graph(rng, 1100, 2), _bwd_graph(rng, 60, 2))]
        G, want = 40, dict(placement="hot", rows=2)
    elif case == "ring_global":                  # no diagonal on chip
        g = [(_bwd_graph(rng, 6600, 2), _bwd_graph(rng, 30, 1))]
        want = dict(placement="global", hot=0, rows=0)
    elif case == "rows4":                        # K 2 x 2 past 1536 lanes
        g = [(_bwd_graph(rng, 1800, 2), _bwd_graph(rng, 50, 2))]
        want = dict(rows=4, KL=2, KR=2)
    elif case == "rows4_hot":                    # the same, a hot split
        g = [(_bwd_graph(rng, 1800, 2), _bwd_graph(rng, 50, 2))]
        G, want = 30, dict(rows=4, KL=2, KR=2, placement="hot")
    elif case == "rows0_k3":                     # past 768 lanes at K 3
        g = [(_bwd_graph(rng, 1800, 3), _bwd_graph(rng, 50, 2))]
        want = dict(rows=0, KL=0, KR=0)
    elif case == "rows0_hot":                    # the same, a hot split
        g = [(_bwd_graph(rng, 1800, 3), _bwd_graph(rng, 50, 2))]
        G, want = 30, dict(rows=0, placement="hot")
    elif case == "rows0_shared":                 # runtime lanes, whole ring
        g = [(_bwd_graph(rng, 2500, 1), _bwd_graph(rng, 40, 1))]
        want = dict(rows=0, placement="shared")
    elif case == "rtab_device":                  # right slots too many
        g = [(_bwd_graph(rng, 40, 2), _bwd_graph(rng, 15000, 2))]
        want = dict(rtab=False, KL=2, KR=2)
    elif case == "ragged_batch":
        g = [(_bwd_graph(rng, 200, 3), _bwd_graph(rng, 150, 2)),
             (_bwd_graph(rng, 130, 1), _bwd_graph(rng, 190, 3)),
             (_bwd_graph(rng, 60, 2), _bwd_graph(rng, 70, 1))]
        want = dict(KL=3, KR=3)
    elif case == "deep_ring":
        g = [(_fwd_graph(rng, 300, 2, skip=44), _bwd_graph(rng, 260, 2))]
        want = {}
    elif case == "ring_g1":                      # G = 1: one offset
        g = [(_bwd_graph(rng, 120, 1), _bwd_graph(rng, 100, 1))]
        G, want = 1, dict(placement="shared", hot=2)
    elif case == "offsets_past_g":
        g = [(_bwd_graph(rng, 150, 4), _bwd_graph(rng, 140, 3))]
        G, want = 3, dict(KL=4, KR=3)
    else:
        raise ValueError(case)
    kw, _b = ff.fanin_batch_args([fp.fanin_fullprob_inputs(a, b, MODEL)
                                  for a, b in g], "cuda", G=G)
    if case == "deep_ring":
        assert kw["G"] >= 42
    return "fanin", kw, want


FWD_SHAPES = (["linear_rows1", "linear_rows2", "linear_rows4",
               "linear_global", "linear_ragged", "ring_hot", "ring_global",
               "rows4", "rows4_hot", "rows0_k3", "rows0_hot",
               "rows0_shared", "rtab_device", "ragged_batch", "deep_ring",
               "ring_g1", "offsets_past_g", "k6x2"]
              + ["k%dx%d" % (kl, kr) for kl in range(1, 5)
                 for kr in range(1, 5)])


@pytest.mark.parametrize("case", FWD_SHAPES)
def test_fullprob_fwd_shape_classes(cuda, case):
    """Kernel D against its plain version on each shape class of its
    launch plans: every templated backward-edge fan-in and the runtime-K
    build, each ring placement (shared, a hot split, global), one and
    two lanes a thread (fan-in two, and four up to K 2 x 2) and the
    fan-in build for any count, each of them with the ring whole and
    split, the right-slot table in shared and in device memory, the
    linear lane builds and the cluster build (two cases), ragged
    batches, a deep ring, G = 1 and offsets past G; planes bit-equal,
    cum within D * eps * max(1, |cum|)."""
    rng = np.random.default_rng(sum(map(ord, case)))
    kind, kw, want = _fwd_shape_case(case, rng)
    if kind == "linear":
        plan = ff.fwd_linear_plan(kw["ms2"].shape[2])
        fn, plain, name = ff.fullprob_fwd, ff.fullprob_fwd_plain, \
            "fullprob_fwd"
    else:
        lo, ro = kw["loff"], kw["roff"]
        plan = ff.fwd_fanin_plan(lo.shape[1], kw["G"], lo.shape[2],
                                 ro.shape[2], ro.shape[1])
        fn, plain, name = ff.fullprob_fwd_fanin, \
            ff.fullprob_fwd_fanin_plain, "fullprob_fwd_fanin"
    assert {k: plan[k] for k in want} == want
    n0 = ff.LAUNCHES[name]
    out = fn(**kw)
    ref = plain(**kw)
    torch.cuda.synchronize()
    assert ff.LAUNCHES[name] == n0 + 1
    _same_fills(out, ref)
    assert float(out[0].max()) == 1.0


@pytest.mark.parametrize("entry, change", [
    ("fanin", dict(rows=3)),
    ("fanin", dict(rows=4, threads=384, KL=0, KR=0)),
    ("fanin", dict(KL=5, KR=5)),
    ("fanin", dict(threads=1024)), ("fanin", dict(rows=0)),
    ("linear", dict(rows=3)), ("linear", dict(cluster=1))])
def test_fullprob_fwd_takes_only_plans_it_has_built(cuda, monkeypatch,
                                                    entry, change):
    """Kernel D refuses a plan it has no build for (three lanes a
    thread; four lanes with runtime K; a fan-in past 4 x 4 as a
    template; 1024 threads of two lanes at K 2 x 2; the build for any
    lane count with a templated fan-in; a linear cluster of one CTA):
    the wrapper raises and counts no launch, and the next launch is not
    disturbed."""
    rng = np.random.default_rng(3)
    if entry == "fanin":
        kw, _b = ff.fanin_batch_args([fp.fanin_fullprob_inputs(
            _bwd_graph(rng, 1500, 2), _bwd_graph(rng, 60, 2), MODEL)],
            "cuda")
        fn, name, planner = ff.fullprob_fwd_fanin, "fullprob_fwd_fanin", \
            "fwd_fanin_plan"
    else:
        kw = ff.linear_batch_args([fp.linear_fullprob_inputs(
            *_related(rng, 1500), MODEL)], "cuda")
        fn, name, planner = ff.fullprob_fwd, "fullprob_fwd", \
            "fwd_linear_plan"
    plan = getattr(ff, planner)
    with monkeypatch.context() as m:
        m.setattr(ff, planner, lambda *a: dict(plan(*a), **change))
        n0 = ff.LAUNCHES[name]
        with pytest.raises(RuntimeError, match="fullprob_fwd.* launch"):
            fn(**kw)
        assert ff.LAUNCHES[name] == n0
    out = fn(**kw)
    torch.cuda.synchronize()
    assert ff.LAUNCHES[name] == n0 + 1
    assert float(out[0].max()) == 1.0


def _cluster_batch(rng, sizes):
    """Kernels D's and E's linear arguments on the card for pairs of
    (left, right) random sites."""
    pairs = [(build_leaf_graph("".join(rng.choice(list("ACGT"), n)),
                               alph.DNA),
              build_leaf_graph("".join(rng.choice(list("ACGT"), m)),
                               alph.DNA)) for n, m in sizes]
    return ff.linear_batch_args([fp.linear_fullprob_inputs(*p, MODEL)
                                 for p in pairs], "cuda")


# the batches of the cluster build: chip_smoke.py's 4,300 x 400 pair and
# a ragged batch past 4,096 lanes
CLUSTER_BATCHES = {"4300x400": [(4300, 400)],
                   "ragged": [(4500, 300), (4150, 380), (900, 420)]}


@pytest.mark.parametrize("batch", sorted(CLUSTER_BATCHES))
@pytest.mark.parametrize("entry", ["fullprob_fwd", "fullprob_bwd"])
def test_fullprob_linear_cluster_every_size(cuda, entry, batch):
    """Kernel D's or E's cluster build forced at both sizes its plan
    picks (CLUSTER_SIZES) with two and four lanes a thread, on one batch:
    planes bit-equal to the plain version, cum within D * eps * max(1,
    |cum|); the plan's own build launched through the wrapper counts a
    cluster launch."""
    kw = _cluster_batch(np.random.default_rng(len(batch)),
                        CLUSTER_BATCHES[batch])
    Lp = kw["ms2"].shape[2]
    cell = 32 if entry == "fullprob_fwd" else 16
    ref = getattr(ff, entry + "_plain")(**kw)
    n0 = ff.CLUSTER_LAUNCHES[entry]
    _same_fills(getattr(ff, entry)(**kw), ref)
    assert ff.CLUSTER_LAUNCHES[entry] == n0 + 1
    sizes = 0
    for C in ff.CLUSTER_SIZES:
        for rows in (2, 4):
            plan = ff.cluster_build(Lp, C, rows, cell)
            if plan is None:
                continue
            assert ff.linear_clusters(entry, plan) >= 1
            out = ff._launch_linear(entry, plan, **kw)
            torch.cuda.synchronize()
            _same_fills(out, ref)
            sizes += 1
    assert sizes == 2 * len(ff.CLUSTER_SIZES)


@pytest.mark.parametrize("entry", ["fullprob_fwd", "fullprob_bwd"])
def test_fullprob_linear_cluster_repeats(cuda, entry):
    """The race guard: the plan's cluster build (16 CTAs of four lanes
    a thread, and the 5,000 bp plan) launched five times on one batch
    gives the same bits every time."""
    kw = _cluster_batch(np.random.default_rng(17), [(5000, 4600)])
    Lp = kw["ms2"].shape[2]
    cell = 32 if entry == "fullprob_fwd" else 16
    for plan in ((ff.fwd_linear_plan if cell == 32 else
                  ff.bwd_linear_plan)(Lp), ff.cluster_build(Lp, 16, 4,
                                                            cell)):
        first = ff._launch_linear(entry, plan, **kw)
        for _ in range(4):
            again = ff._launch_linear(entry, plan, **kw)
            torch.cuda.synchronize()
            assert torch.equal(_bits(again[0]), _bits(first[0]))
            assert torch.equal(_bits(again[1]), _bits(first[1]))


@pytest.mark.parametrize("entry", ["fullprob_fwd", "fullprob_bwd"])
def test_fullprob_linear_cluster_refused(cuda, monkeypatch, entry):
    """A cluster the card cannot schedule or take is refused, never
    launched: 32 CTAs (past any cluster), a CTA past the shared memory a
    block may take (its rows and its static maxima), and (where the card
    reports it cannot hold one) 16 CTAs of 1,024 threads each with all
    the shared memory a block may take;
    the wrapper raises and counts no launch, and the next launch runs."""
    kw = _cluster_batch(np.random.default_rng(5), [(4300, 200)])
    Lp = kw["ms2"].shape[2]
    plan = (ff.fwd_linear_plan if entry == "fullprob_fwd" else
            ff.bwd_linear_plan)(Lp)
    # the largest CTA: its rows beside its static rows of maxima
    big = dict(rows=4, threads=1024, cluster=16,
               smem=ff.SHARED_BYTES - 1024)
    bad = [dict(plan, cluster=32), dict(plan, smem=ff.SHARED_BYTES)]
    if ff.linear_clusters(entry, big) == 0:
        bad.append(big)
    for refused in bad:
        with monkeypatch.context() as m:
            m.setattr(ff, entry[9:] + "_linear_plan",
                      lambda Lp, p=refused: p)
            n0 = ff.LAUNCHES[entry], ff.CLUSTER_LAUNCHES[entry]
            with pytest.raises(RuntimeError, match=entry + ".* launch"):
                getattr(ff, entry)(**kw)
            assert (ff.LAUNCHES[entry], ff.CLUSTER_LAUNCHES[entry]) == n0
    out = getattr(ff, entry)(**kw)
    torch.cuda.synchronize()
    assert float(out[0].max()) == 1.0


def _same_probe(out, ref, codes=True):
    if codes:
        assert torch.equal(out[0], ref[0])
    for o, r in zip(out[1:], ref[1:]):
        assert torch.equal(_bits(o), _bits(r))


@pytest.mark.parametrize("rows", [511, 4200])
@pytest.mark.parametrize("opts", [(), ("nobp",), ("noms",), ("nomask",),
                                  ("nocorner",), ("nobp", "noms"),
                                  ("nobp", "noms", "nomask", "nocorner")],
                         ids=lambda o: "+".join(o) or "base")
def test_probe_kernel_matches_plain(cuda, opts, rows):
    """Kernel F's probe entry point, every flag set: two 511 bp pairs
    (two rows a thread), and a 4,200-site left side against 64 sites cut
    to its first 512 diagonals (the global build)."""
    if rows == 511:
        inps, _cells = pair_jobs(2, 511)
    else:
        rng = np.random.default_rng(4)
        g1, _g2 = _related(rng, rows)
        inps = [tl._add_scalar_params(prepare_sheared(
            g1, build_leaf_graph("ACGTTGCA" * 8, alph.DNA), MODEL,
            AlignSettings(), np.float32))]
    kw = VP.probe_args(job_arrays(inps), cuda, TD=16)
    if rows > 511:
        kw["ms"] = kw["ms"][:512].contiguous()
    assert (VP.probe_plan(kw["ms"].shape[2])["rows"] == 0) == (rows > 511)
    key = "probe:" + VP.probe_variant(opts)
    n0 = VP.LAUNCHES[key]
    out = VP.probe_fill(**kw, opts=opts)
    ref = VP.probe_fill_plain(**kw, opts=opts)
    torch.cuda.synchronize()
    assert VP.LAUNCHES[key] == n0 + 1
    # under nobp the probe's codes are undefined, as in the JAX kernel
    _same_probe(out, ref, codes="nobp" not in opts)


@pytest.mark.parametrize("shape", [(2, 512, 512), (2, 4096, 512),
                                   (1, 4224, 256)])
@pytest.mark.parametrize("variant", ["", "nobp", "noroll", "nomask",
                                     "nobp,noroll", "nobp,noroll,nomask"],
                         ids=lambda v: v or "full")
def test_bisect_kernel_matches_plain(cuda, variant, shape):
    """Kernel F's bisect entry point, every variant, on the tool's random
    inputs: 512 and 4,096 rows (two and four rows a thread, the latter
    the top of the lane builds) and 4,224 rows (the global build)."""
    kw = bisect_inputs(*shape, cuda)
    key = "bisect:" + VP.bisect_variant(variant)
    n0 = VP.LAUNCHES[key]
    out = VP.bisect_fill(**kw, variant=variant)
    ref = VP.bisect_fill_plain(**kw, variant=variant)
    torch.cuda.synchronize()
    assert VP.LAUNCHES[key] == n0 + 1
    _same_probe(out, ref)


# kernel F's batches for each build of its plan: the probe's pairs (left
# and right sites; one job fills Lp, so row Lp - 1 is live and the roll
# shows, the others leave rows past L) and the bisect's random inputs (B,
# Lp, Dpk; Dpk past Lp, so the last warp and the wrap are live). Lp 128,
# 1024, 2080 (four rows: 544 threads, the last warp partial) and past
# 4096; the bisect's global build on 100 rows, not whole warps.
PROBE_BUILDS = {1: [(127, 40), (90, 70), (60, 20)],
                2: [(1023, 40), (700, 60)],
                4: [(2079, 30), (1500, 60)],
                0: [(4223, 20), (3000, 40)]}
BISECT_BUILDS = {1: (2, 96, 256), 2: (2, 544, 1152), 4: (2, 2080, 2304),
                 0: (2, 100, 256)}


def _probe_build_batch(rows, dev):
    rng = np.random.default_rng(40 + rows)
    inps = []
    for n1, n2 in PROBE_BUILDS[rows]:
        g1, _g2 = _related(rng, n1)
        base = rng.choice(list("ACGT"), size=n2)
        inps.append(tl._add_scalar_params(prepare_sheared(
            g1, build_leaf_graph("".join(base), alph.DNA), MODEL,
            AlignSettings(), np.float32)))
    return VP.probe_args(job_arrays(inps), dev, TD=16)


@pytest.mark.parametrize("rows", [1, 2, 4, 0])
@pytest.mark.parametrize("tool,variant",
                         [("probe", v) for v in VP.PROBE_VARIANTS] +
                         [("bisect", v) for v in VP.BISECT_VARIANTS])
def test_probe_every_build_matches_plain(cuda, tool, variant, rows):
    """Kernel F, every flag set of both entry points, on a batch whose
    plan takes each build (one, two and four rows a thread, the last
    warp partial at Lp 2080, and the global build past 4096 rows or on
    rows that are not whole warps), bit for bit against its plain
    version; then every other build that can take the batch, launched
    whatever the plan says, against the same."""
    if tool == "probe":
        kw = _probe_build_batch(rows, cuda)
        opts = () if variant == "base" else tuple(variant.split("+"))
        ref = VP.probe_fill_plain(**kw, opts=opts)
        entry, neg, codes = "viterbi_probe_launch", VP.PROBE_NEG, \
            "nobp" not in opts
    else:
        kw = bisect_inputs(*BISECT_BUILDS[rows], cuda)
        ref = VP.bisect_fill_plain(**kw, variant=variant)
        entry, neg, codes = "viterbi_bisect_launch", VP.BISECT_NEG, True
    Dpk, B, Lp = kw["ms"].shape
    assert VP.probe_plan(Lp)["rows"] == rows
    key = "%s:%s" % (tool, variant)
    n0 = VP.LAUNCHES[key]
    out = (VP.probe_fill(**kw, opts=opts) if tool == "probe"
           else VP.bisect_fill(**kw, variant=variant))
    torch.cuda.synchronize()
    assert VP.LAUNCHES[key] == n0 + 1
    _same_probe(out, ref, codes=codes)
    others = [dict(rows=r, threads=tl._block(Lp, r), diagonals="registers")
              for r, _top in VP.PROBE_LANES if Lp % 32 == 0 and
              tl._block(Lp, r) <= 1024 and r != rows]
    if rows:
        others.append(dict(rows=0, threads=min(1024, tl._block(Lp, 1)),
                           diagonals="global"))
    for plan in others:
        out = VP._launch(plan, entry, key, VP._flags(variant), neg,
                         *(kw[k] for k in ("fscal", "iscal", "gexti", "ol",
                                           "vlo", "vhi", "ms")))
        torch.cuda.synchronize()
        _same_probe(out, ref, codes=codes)


def test_probe_kernel_refuses_plans_it_has_no_build_for(cuda):
    """The kernel's own launcher (past the wrapper's check) refuses a
    plan it has no build for: cudaErrorInvalidValue, nothing launched;
    and a flag set it has no instantiation for: UNKNOWN_FLAGS (-1)."""
    import ctypes
    from pagan2_tpu_torch import kernels
    kw = bisect_inputs(2, 544, 64, cuda)
    fn = kernels.load("viterbi_linear_probe").viterbi_bisect_launch
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * 12 + [ctypes.c_float] + \
        [ctypes.c_int] * 6 + [ctypes.c_void_p]
    bp = torch.zeros((64, 2, 544), dtype=torch.int8, device=cuda)
    corner = [torch.zeros((2, 544), device=cuda) for _ in range(3)]
    ins = [kw[k].data_ptr() for k in ("fscal", "iscal", "gexti", "ol",
                                      "vlo", "vhi", "ms")]
    for rows, threads, flags, want in ((3, 192, 0, 1), (2, 128, 0, 1),
                                       (1, 2048, 0, 1), (4, 100, 0, 1),
                                       (0, 544, 0, 1), (2, 288, 2, -1)):
        err = fn(*ins, bp.data_ptr(), *(c.data_ptr() for c in corner), 0,
                 VP.BISECT_NEG, 2, 64, 544, rows, threads, flags,
                 torch.cuda.current_stream().cuda_stream)
        torch.cuda.synchronize()
        assert err == want, (rows, threads, flags)
    assert not bool(bp.any())


def test_probe_base_matches_kernel_a(cuda):
    """The probe's base case and kernel A on one batch: codes equal but
    the x/m bits of row 0, corner cell equal to kernel A's corner."""
    inps, _cells = pair_jobs(3, 600)
    jobs = job_arrays(inps)
    bp, fM, fX, fY = VP.probe_fill(**VP.probe_args(jobs, cuda, TD=16))
    codes, corner = tl.linear_fill(**tl.linear_batch_args(jobs, cuda))
    torch.cuda.synchronize()
    D = codes.shape[1]
    a = codes[:, 1:].transpose(0, 1).to(torch.int16)
    p = bp[:D - 1].to(torch.int16)
    a[:, :, 0] &= 0x30
    p[:, :, 0] &= 0x30
    assert torch.equal(a, p)
    L = inps[0]["L"]
    got = torch.stack([fM[:, L - 1], fX[:, L - 1], fY[:, L - 1]], dim=1)
    assert torch.equal(_bits(got), _bits(corner))


def test_cli_cuda_matches_cpu(cuda, tmp_path):
    rng = np.random.default_rng(9)
    base = rng.choice(list("ACGT"), size=400)
    with open(tmp_path / "s.fas", "w") as f:
        for i in range(6):
            mut = base.copy()
            idx = rng.random(400) < 0.1
            mut[idx] = rng.choice(list("ACGT"), size=int(idx.sum()))
            s = "".join(mut)
            if i % 3 == 1:
                s = s[:133] + s[145:]
            f.write(">s%d\n%s\n" % (i, s))
    (tmp_path / "t.nh").write_text(
        "(((s0:0.1,s1:0.1):0.05,s2:0.1):0.05,"
        "((s3:0.1,s4:0.1):0.05,s5:0.1):0.05);\n")
    env = dict(os.environ, PYTHONPATH=ROOT)
    outs = []
    for dev in ("cuda", "cpu"):
        out = str(tmp_path / dev)
        subprocess.run([sys.executable, "-m", "pagan2_tpu_torch",
                        "--device", dev, "-s", str(tmp_path / "s.fas"),
                        "-t", str(tmp_path / "t.nh"), "-o", out],
                       env=env, cwd=ROOT, check=True, timeout=600)
        outs.append(open(out + ".fas", "rb").read())
    assert outs[0] == outs[1]


# ---- kernels G and H: the band-sharded fills (align/viterbi_shardband.py)
def _sb_linear_fill(n, dev, seed=3, n1=700, n2=650, H=32, band=False):
    from pagan2_tpu_torch.align import viterbi_shardband as SB
    from pagan2_tpu_torch.parallel.executor import JobsMesh
    g1, g2 = _related(np.random.default_rng(seed), n1)
    if n2 < n1:
        g2 = build_leaf_graph("".join("ACGT"[s] for s in g2.states[1:n2]),
                              alph.DNA)
    L, R = g1.num_sites() - 1, g2.num_sites() - 1
    bnd = None
    if band:
        c = np.arange(L) * R // L
        bnd = (np.maximum(c - 40, 0), np.minimum(c + 40, R - 1))
    H = min(H, SB._lane_split(L, n))
    shards, meta = SB.shardband_args(g1, g2, MODEL, AlignSettings(), n,
                                     band=bnd, H=H)
    out = SB.shardband_fill(JobsMesh([dev] * n), shards, meta)
    return out, meta, dict(SB.FILL_STATS)


# (shards, halo, banded, kernel G's threads a CUDA block, G_THREADS:
# None the plan's 256 of two lanes, 512 lanes a tile; 1,024 the widest;
# fewer make many tiles, most of them skipped)
SB_LINEAR_CASES = [(1, 32, False, None), (2, 8, False, None),
                   (4, 32, False, None), (4, 32, True, None),
                   (3, 64, False, None), (2, 128, False, None),
                   (2, 256, True, None), (2, 512, False, 1024),
                   (4, 32, False, 32), (3, 16, True, 64),
                   (2, 256, False, 160)]


@pytest.mark.parametrize("n,H,band,threads", SB_LINEAR_CASES)
def test_shardband_linear_kernel_matches_plain(cuda, monkeypatch, n, H, band,
                                               threads):
    """Kernel G over n logical shards on the card against its plain
    version over n CPU shards, on the same launch plan: every code (the
    sheared plane, all lanes) and the corner scores bit-equal, and one
    launch a shard and block of the plan."""
    from pagan2_tpu_torch.align import viterbi_shardband as SB
    if threads is not None:
        monkeypatch.setattr(SB, "G_THREADS", threads)
    before = SB.LAUNCHES["shardband_linear_block"]
    (codes, corner), meta, st = _sb_linear_fill(n, cuda, H=H, band=band)
    assert SB.LAUNCHES["shardband_linear_block"] - before == \
        st["launches"] > 0
    (pc, pcorner), _m, pst = _sb_linear_fill(n, "cpu", H=H, band=band)
    assert (st["launches"], st["tiles"]) == (pst["launches"], pst["tiles"])
    assert np.array_equal(codes, pc)
    assert np.array_equal(corner.view(np.uint32), pcorner.view(np.uint32))
    assert np.isfinite(corner).any()


@pytest.mark.parametrize("kind", ["linear", "fanin"])
def test_shardband_kernels_skip_a_shard(cuda, monkeypatch, kind):
    """141 rows on 4 shards of 64 lanes: shard 3 owns no row, is never
    launched, and its codes stay masked; the fill on the card equals
    the plain version's, with fewer launches than shards x blocks."""
    from pagan2_tpu_torch.align import viterbi_fanin as tf_
    from pagan2_tpu_torch.align import viterbi_shardband as SB
    from pagan2_tpu_torch.parallel.executor import JobsMesh
    monkeypatch.setattr(SB, "G_THREADS", 32)
    monkeypatch.setattr(SB, "H_LANES", 64)
    if kind == "linear":
        (codes, corner), meta, st = _sb_linear_fill(4, cuda, n1=140, n2=90)
        (pc, pcorner), _m, _s = _sb_linear_fill(4, "cpu", n1=140, n2=90)
        masked = 0x3F
    else:
        g1, g2 = _related(np.random.default_rng(9), 140, mode454=True)
        inp = tf_.prepare_fanin(g1, g2, MODEL, AlignSettings(), np.float32)
        OLm = max(inp["OL"], 1)
        G = SB._g_bucket(OLm + max(inp["OR"], 1))
        shards, meta = SB.shardband_fanin_args(inp, 4, H=32)
        codes, corner = SB.shardband_fanin_fill(
            JobsMesh([cuda] * 4), shards, meta, G, 32 // OLm)
        st = dict(SB.FILL_STATS)
        pc, pcorner = SB.shardband_fanin_fill(
            JobsMesh(["cpu"] * 4), shards, meta, G, 32 // OLm)
        masked = 0xFFFFFFFF
    w = meta["w"]
    assert meta["L"] <= 3 * w
    assert st["launches"] < st["blocks"] * 3
    assert np.all(codes[:, 3 * w:] == masked)
    assert np.array_equal(codes, pc)
    assert np.array_equal(corner.view(np.uint32), pcorner.view(np.uint32))


def test_shardband_linear_kernel_equals_kernel_a_pair_end_build(cuda):
    """Kernel G on 4 shards against kernel A's pair-end build with no
    break column (the scan-core rule) on a 5,000-row pair (A's global
    build): every code field G defines is A's, and the corner equal."""
    from pagan2_tpu_torch.align import viterbi_shardband as SB
    from pagan2_tpu_torch.parallel.executor import JobsMesh
    g1, g2 = _related(np.random.default_rng(5), 5000)
    g2 = build_leaf_graph("".join("ACGT"[s] for s in g2.states[1:1201]),
                          alph.DNA)
    shards, meta = SB.shardband_args(g1, g2, MODEL, AlignSettings(), 4)
    codes, corner = SB.shardband_fill(JobsMesh([cuda] * 4), shards, meta)
    inp = prepare_sheared(g1, g2, MODEL, AlignSettings(), np.float32)
    inp["pair_end"], inp["jbrk"] = True, -1
    tl._add_scalar_params(inp)
    Lp = tl.batch_rows([inp])
    a, acorner = tl.linear_fill(**tl.linear_batch_args(
        [tl.linear_job_arrays(inp, Lp)], cuda))
    L, R = meta["L"], meta["R"]
    a = a[0, :, :L].cpu().numpy()
    g = codes[:, :L]
    for sh in (0, 2, 4):
        f = (g >> sh) & 3
        defined = f != 3
        assert np.array_equal(f[defined], ((a >> sh) & 3)[defined]), sh
    assert np.array_equal(corner.view(np.uint32),
                          acorner[0].cpu().numpy().view(np.uint32))


def _sb_fanin_case(case):
    rng = np.random.default_rng(17)
    if case == "454":
        g1, g2 = _related(rng, 400, mode454=True)
        return g1, g2
    base = "".join(rng.choice(list("ACGT"), size=300))
    cut = {"bridge_left": 12, "bridge_right": 12, "deep_ring": 40}[case]
    anc, _e = align_pair(build_leaf_graph(base, alph.DNA),
                         build_leaf_graph(base[:90] + base[90 + cut:],
                                          alph.DNA),
                         MODEL, AlignSettings(), use_anchors=False,
                         device="cpu")
    leaf = build_leaf_graph(base, alph.DNA)
    return (anc, leaf) if case == "bridge_left" else (leaf, anc)


@pytest.mark.parametrize("case", ["454", "bridge_left", "bridge_right",
                                  "deep_ring"])
@pytest.mark.parametrize("n,H,lanes", [(2, 32, None), (4, 32, None),
                                       (2, 256, None), (4, 128, None),
                                       (3, 32, 64), (2, 256, 1024)])
def test_shardband_fanin_kernel_matches_plain(cuda, monkeypatch, case, n, H,
                                              lanes):
    """Kernel H over n logical shards against its plain version, on the
    same launch plan: codes and the corner rings bit-equal (a deep ring:
    a right bridge of 41, ring depth 64); the plan's tile of 256 lanes
    caps the halo at 128; lanes 64 makes many tiles, most skipped, and
    1,024 is the widest tile."""
    from pagan2_tpu_torch.align import viterbi_fanin as tf_
    from pagan2_tpu_torch.align import viterbi_shardband as SB
    from pagan2_tpu_torch.parallel.executor import JobsMesh
    g1, g2 = _sb_fanin_case(case)
    inp = tf_.prepare_fanin(g1, g2, MODEL, AlignSettings(), np.float32)
    OLm, ORm = max(inp["OL"], 1), max(inp["OR"], 1)
    G = SB._g_bucket(OLm + ORm)
    if lanes is not None:
        # at most the lanes whose ring fits in shared memory
        monkeypatch.setattr(SB, "H_LANES", lanes)
    H = SB.fanin_halo(H, G, SB._lane_split(inp["L"], n))
    if case == "deep_ring":
        assert G == 64
    shards, meta = SB.shardband_fanin_args(inp, n, H=H)
    before = SB.LAUNCHES["shardband_fanin_block"]
    out = SB.shardband_fanin_fill(JobsMesh([cuda] * n), shards, meta, G,
                                  max(1, H // OLm))
    assert SB.LAUNCHES["shardband_fanin_block"] - before == \
        SB.FILL_STATS["launches"] > 0
    ref = SB.shardband_fanin_fill(JobsMesh(["cpu"] * n), shards, meta, G,
                                  max(1, H // OLm))
    assert np.array_equal(out[0], ref[0])
    assert np.array_equal(out[1].view(np.uint32), ref[1].view(np.uint32))


def test_shardband_block_wrappers_on_cuda(cuda, monkeypatch):
    """The public wrappers of G and H on CUDA tensors, one block each on
    a tile range of shard 0 from the fill's start, equal their plain
    versions on the same inputs (codes pre-filled with the masked
    code)."""
    from pagan2_tpu_torch.align import viterbi_fanin as tf_
    from pagan2_tpu_torch.align import viterbi_shardband as SB
    monkeypatch.setattr(SB, "G_THREADS", 32)
    monkeypatch.setattr(SB, "H_LANES", 64)
    g1, g2 = _related(np.random.default_rng(4), 600)
    shards, meta = SB.shardband_args(g1, g2, MODEL, AlignSettings(), 2,
                                     H=32)
    w, H = meta["w"], meta["H"]
    rows = meta["L"] + meta["R"] - 1
    outs = []
    for dev in (cuda, "cpu"):
        a = {k: torch.from_numpy(np.ascontiguousarray(v)).to(dev)
             for k, v in shards[0].items()}
        cin = torch.full((6, H + w), -np.inf, device=dev)
        cin[0, H] = 0.0                  # M(0, 0) on diagonal 0
        kw = dict(cin=cin, cout=cin.clone(),
                  codes=torch.full((rows, w), 0x3F, dtype=torch.uint8,
                                   device=dev),
                  corner=torch.full((3,), -np.inf, device=dev),
                  lng=meta["lng"], lgo=meta["lgo"], L=meta["L"],
                  R=meta["R"], base=-H, H=H, d0=1, nsteps=32,
                  tiles=(0, 2), **a)
        SB.shardband_linear_block(**kw)
        outs.append([kw["codes"].cpu(), kw["cout"].cpu()])
    assert torch.equal(outs[0][0], outs[1][0])
    assert torch.equal(outs[0][1].view(torch.int32),
                       outs[1][1].view(torch.int32))
    assert bool((outs[0][0] != 0x3F).any())
    g1, g2 = _related(np.random.default_rng(4), 300, mode454=True)
    inp = tf_.prepare_fanin(g1, g2, MODEL, AlignSettings(), np.float32)
    G = SB._g_bucket(max(inp["OL"], 1) + max(inp["OR"], 1))
    shards, meta = SB.shardband_fanin_args(inp, 2, H=32)
    w, H = meta["w"], meta["H"]
    rows = meta["L"] + meta["R"] - 1
    outs = []
    for dev in (cuda, "cpu"):
        a = {k: torch.from_numpy(np.ascontiguousarray(v)).to(dev)
             for k, v in shards[0].items()}
        cin = torch.full((3, G, H + w), -np.inf, device=dev)
        kw = dict(cin=cin, cout=cin.clone(),
                  codes=torch.full((rows, w), -1, dtype=torch.int32,
                                   device=dev),
                  snap=torch.full((3, G, w), -np.inf, device=dev),
                  lng=meta["lng"], lgo=meta["lgo"], L=meta["L"],
                  R=meta["R"], base=-H, H=H, d0=0, nsteps=10,
                  tiles=(0, 1), **a)
        SB.shardband_fanin_block(**kw)
        outs.append([kw["codes"].cpu(), kw["cout"].cpu()])
    assert torch.equal(outs[0][0], outs[1][0])
    assert torch.equal(outs[0][1].view(torch.int32),
                       outs[1][1].view(torch.int32))
    assert bool((outs[0][0] != -1).any())


@pytest.mark.parametrize("shards", ["logical", "cards"])
def test_executor_mesh_on_cuda_matches_cpu(cuda, monkeypatch, shards):
    """execute_pair_jobs over [cuda:0] * 4 (or one shard a visible card,
    make_jobs_mesh, given more than one) against as many CPU shards:
    batches sharded, then a pair band-sharded (SHARDBAND_MIN_L lowered,
    its halo copied card to card), the same ancestral graphs and
    scores."""
    from pagan2_tpu_torch.parallel import executor as EX
    from pagan2_tpu_torch.parallel.executor import JobsMesh
    if shards == "cards" and torch.cuda.device_count() < 2:
        pytest.skip("needs more than one card")
    mesh = JobsMesh([cuda] * 4) if shards == "logical" else \
        EX.make_jobs_mesh()

    def jobs():
        rng = np.random.default_rng(23)
        out = [EX.PairJob(*_related(rng, n), MODEL, AlignSettings())
               for n in (200, 210, 190, 60)]
        out += [EX.PairJob(*_related(rng, 150, mode454=True), MODEL,
                           AlignSettings()) for _ in range(3)]
        return out

    def keys(res):
        return [([int(x) for x in a.states[:a.num_sites()]], e.score)
                for a, e in res]
    for gate in (1 << 16, 128):
        monkeypatch.setattr(EX, "SHARDBAND_MIN_L", gate)
        got = EX.execute_pair_jobs(jobs()[-1 if gate == 128 else 0:],
                                   device=cuda, mesh=mesh)
        want = EX.execute_pair_jobs(jobs()[-1 if gate == 128 else 0:],
                                    device="cpu",
                                    mesh=JobsMesh(["cpu"] * mesh.size))
        assert keys(got) == keys(want)
