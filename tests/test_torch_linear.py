"""Kernel A's plain version (pagan2_tpu_torch.align.viterbi_linear)
against the JAX package's linear Pallas kernel run in interpret mode,
on the same f32 inputs: corner scores bit-equal and codes equal on every
in-matrix cell (tolerance 0: the fill only adds and takes maxima).

Two kinds of code bits are skipped because no backtrack reads them: the
x/m bits of row i = 0 (the Pallas kernel rolls them in circularly from
its last lane) and the y bits of column j = 0."""
import numpy as np
import pytest
import torch

from pagan2_tpu.align import AlignSettings
from pagan2_tpu.align import viterbi_pallas as vp
from pagan2_tpu.align.viterbi_sheared import prepare_sheared, _bucket
from pagan2_tpu.graph import build_leaf_graph
from pagan2_tpu.models import ModelFactory, alphabets as alph

from pagan2_tpu_torch.align.parity import inputs_from_reference
from pagan2_tpu_torch.align.viterbi_linear import linear_fill


def _pair(rng, n1, n2):
    s1 = "".join(rng.choice(list("ACGT"), size=n1))
    s2 = list(s1[:n2]) + list(rng.choice(list("ACGT"),
                                         size=max(0, n2 - n1)))
    for k in range(len(s2)):
        if rng.random() < 0.15:
            s2[k] = str(rng.choice(list("ACGT")))
    return (build_leaf_graph(s1, alph.DNA),
            build_leaf_graph("".join(s2), alph.DNA))


def _band(L, R, w):
    c = np.arange(L) * R // L
    return (np.maximum(c - w, 0), np.minimum(c + w, R - 1))


def _reference_fill(inps, bands):
    """pallas_fill in interpret mode on f32 prep; returns unpacked codes
    (row r = diagonal r + 1) and the per-job corner (M, X, Y)."""
    Lpp = vp._lane_bucket(_bucket(max(x["L"] for x in inps)))
    Rp = _bucket(max(x["R"] for x in inps))
    jobs = [vp.pallas_job_arrays(x, Lpp, Rp, band=b)
            for x, b in zip(inps, bands)]
    vp.INTERPRET = True
    try:
        bpp, fM, fX, fY = vp.pallas_fill(*vp.pallas_batch_args(jobs, Lpp,
                                                               Rp))
    finally:
        vp.INTERPRET = False
    codes = vp.unpack_bp(bpp)
    corner = np.stack([[np.asarray(f)[b, x["L"] - 1] for f in (fM, fX, fY)]
                       for b, x in enumerate(inps)])
    return codes, corner, jobs


CASES = [  # (seed, pair sizes, band half-width or None)
    (0, [(5, 7)], None),
    (1, [(40, 33), (29, 41), (17, 17)], None),
    (2, [(120, 131), (96, 90)], 9),
    (3, [(300, 257), (211, 300), (64, 80), (140, 150)], None),
    (4, [(230, 240)], 14),
]


@pytest.mark.parametrize("seed,sizes,w", CASES)
def test_linear_plain_matches_pallas_interpret(seed, sizes, w):
    rng = np.random.default_rng(seed)
    model = ModelFactory(alph.DNA).alignment_model(0.2)
    settings = AlignSettings()
    inps, bands = [], []
    for n1, n2 in sizes:
        g1, g2 = _pair(rng, n1, n2)
        inp = vp._add_scalar_params(
            prepare_sheared(g1, g2, model, settings, np.float32))
        inps.append(inp)
        bands.append(None if w is None else _band(inp["L"], inp["R"], w))
    ref_codes, ref_corner, ref_jobs = _reference_fill(inps, bands)

    args = inputs_from_reference(inps, bands=bands)
    codes, corner = linear_fill(**args)
    codes = codes.numpy()
    assert np.array_equal(corner.numpy().view(np.uint32),
                          ref_corner.astype(np.float32).view(np.uint32))
    for b, x in enumerate(inps):
        L, R = x["L"], x["R"]
        i, j = np.meshgrid(np.arange(L), np.arange(R), indexing="ij")
        i, j = i.ravel(), j.ravel()
        keep = (i + j) >= 1
        i, j = i[keep], j[keep]
        mine = codes[b, i + j, i].astype(np.int64)
        ref = ref_codes[i + j - 1, b, i].astype(np.int64)
        xm = i > 0
        assert np.array_equal(mine[xm] & 15, ref[xm] & 15)
        yb = j > 0
        assert np.array_equal(mine[yb] & 48, ref[yb] & 48)

    # the pallas_job_arrays route of the harness gives the same fill
    args2 = inputs_from_reference(ref_jobs)
    codes2, corner2 = linear_fill(**args2)
    assert torch.equal(corner2, corner)


# ----------------------------------------------------------------------
# What kernel A's Hopper design relies on, pinned on the CPU.
from pagan2_tpu_torch.align import viterbi_linear as tl
from pagan2_tpu_torch.tools.sweep_linear import padded_args


@pytest.mark.parametrize("Lp,rows,threads", [
    (32, 1, 32), (128, 1, 128), (160, 2, 96), (512, 2, 256),
    (544, 2, 288), (1536, 2, 768),
    (2048, 2, 1024), (2080, 2, 256), (4064, 2, 256), (4096, 2, 256),
    (4128, 2, 256), (5024, 2, 256), (100, 2, 256)])
def test_linear_plan_branches(Lp, rows, threads):
    """linear_plan: one or two consecutive rows a thread in a block of
    whole warps up to 1024 threads (the lane builds, up to 2048 rows:
    two rows x 1024 threads), the tiled build (tiles of TILE_THREADS x 2
    rows, PAIR_END_TILE_THREADS x 2 in the pair-end build) past 2048 rows
    and on a row count that is not a whole number of warps; the lane
    builds' plan is the same in both builds."""
    p = tl.linear_plan(Lp)
    pe = tl.linear_plan(Lp, pair_end=True)
    assert (p["rows"], p["threads"]) == (rows, threads)
    lanes = Lp <= tl.LANES[-1][1] and Lp % 32 == 0
    assert p["diagonals"] == ("registers" if lanes else "tiles")
    assert p["threads"] % 32 == 0 and p["threads"] <= 1024
    assert tl.has_build(p, Lp)
    if lanes:
        assert rows * threads >= Lp > rows * (threads - 32)
        assert rows == next(r for r, top in tl.LANES if Lp <= top)
        assert pe == p
    else:
        assert p == tl.tiled_plan(tl.TILE_THREADS)
        assert pe == tl.tiled_plan(tl.PAIR_END_TILE_THREADS)
        assert tl.has_build(pe, Lp)


def _skip_batch(kind):
    """Kernel A arguments of one batch kind, on the CPU."""
    rng = np.random.default_rng(7)
    model = ModelFactory(alph.DNA).alignment_model(0.2)
    sizes, w = {"square": ([(90, 90), (70, 70)], None),
                "ragged": ([(150, 120), (40, 61), (97, 5)], None),
                "banded": ([(130, 140), (120, 100)], 8),
                "padded": ([(110, 96), (60, 75)], None)}[kind]
    inps, bands = [], []
    for n1, n2 in sizes:
        g1, g2 = _pair(rng, n1, n2)
        inp = tl._add_scalar_params(prepare_sheared(
            g1, g2, model, AlignSettings(), np.float32))
        inps.append(inp)
        bands.append(None if w is None else _band(inp["L"], inp["R"], w))
    Lp = tl.batch_rows(inps)
    jobs = [tl.linear_job_arrays(x, Lp, band=b) for x, b in zip(inps, bands)]
    if kind == "padded":
        return padded_args(jobs, "cpu", 64)[0]
    return tl.linear_batch_args(jobs, "cpu")


@pytest.mark.parametrize("kind", ["square", "ragged", "banded", "padded"])
def test_cells_with_no_source_in_the_matrix_have_code_0(kind):
    """The rule kernel A's warp skip rests on, held on linear_fill_plain
    (the bar): a cell whose three sources (i-1, j), (i, j-1), (i-1, j-1)
    all lie outside the matrix, j >= R+1, j <= -1 or i >= L+1, has code
    0 (every candidate -inf), on square, ragged (rows past a short
    job's L), banded and padded-D (sweep_linear.padded_args) batches.
    Row L and column R do not qualify: some of their codes are not 0."""
    kw = _skip_batch(kind)
    codes, _corner = tl.linear_fill_plain(**kw)
    B, D, Lp = codes.shape
    d = torch.arange(D)[:, None]
    i = torch.arange(Lp)[None, :]
    j = d - i
    edge = torch.zeros((), dtype=torch.bool)
    for b in range(B):
        L, R = (int(v) for v in kw["iscal"][b, :2])
        skip = (j >= R + 1) | (j <= -1) | (i >= L + 1)
        skip[0] = False                       # row 0: the 0x3F sentinel
        assert int(skip.sum()) > 0
        assert not bool(codes[b][skip].any())
        border = ((i == L) & (j >= 0) & (j <= R)) | \
            ((j == R) & (i >= 0) & (i <= L))
        edge = edge | codes[b][border & ~skip].bool().any()
    assert bool(edge)


@pytest.mark.parametrize("plan", [
    dict(rows=3, threads=64, diagonals="registers"),
    dict(rows=1, threads=32, diagonals="registers"),
    dict(rows=2, threads=2048, diagonals="registers"),
    dict(rows=4, threads=48, diagonals="registers"),
    dict(rows=0, threads=64, diagonals="registers"),
    dict(rows=2, threads=64, diagonals="global"),
    dict(rows=0, threads=1024, diagonals="global"),
    dict(rows=4, threads=32, diagonals="registers"),
    dict(rows=4, threads=256, diagonals="tiles"),
    dict(rows=2, threads=2048, diagonals="tiles"),
    dict(rows=2, threads=48, diagonals="tiles"),
    dict(rows=2, threads=16, diagonals="tiles"),
    dict(rows=2, threads=256, diagonals="tiles", chunk=32)],
    ids=["rows3", "too_few_threads", "block_past_1024", "part_warp",
         "global_named_registers", "lanes_named_global",
         "global_build_gone", "rows4_gone", "tiles_rows4",
         "tile_past_1024",
         "tile_part_warp", "tile_below_a_warp", "tiles_with_a_chunk"])
def test_linear_wrapper_refuses_a_plan_with_no_build(plan):
    """Kernel A's launcher refuses a plan it has no build for before it
    loads or launches anything (so here, on the CPU, too): the global
    build and the four rows a thread are gone (the tiled build took
    their rows), and the tiled build
    takes two rows a thread and tiles of whole warps up to 1024 threads
    (its hand-off interval is the kernel's constant, so a plan naming
    one is refused)."""
    kw = _skip_batch("square")           # Lp 96
    with pytest.raises(ValueError, match="no build"):
        tl._launch_linear(plan, **kw)
