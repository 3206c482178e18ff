"""Bench of kernel A (the linear-chain wavefront) on the calls real runs
give it: chip_smoke.py's 16 x 1535 family (bench.py's generator, seed 5)
through the CLI with default flags and with --full-probability (one
batch of 8 leaf pairs each), the JAX bench tool's 8 x 4095 batch
(tools/bench_linear.py: rows 4096, diagonals padded to TD 16), and
chip_smoke.py's kernel_linear batches (linear_batches: 8 x 2047, a
ragged banded batch and 2 jobs past 4096 rows). Prints each call's
source, B, D, Lp, kernel A's launch plan, ms (CUDA events over REPS
launches after one warm-up) and us per diagonal, then the probe's
all-off floor (kernel F's probe step with codes, match score, masks and
corner all off, on its 16 x 2047 batch: the barrier and the recurrence
chain alone) in us per diagonal, and last a JSON line with the mean and
the sum of each source's calls.

    python -m pagan2_tpu_torch.tools.bench_linear_calls [--device cpu --small]
    python pagan2_tpu_torch/tools/bench_linear_calls.py --root DIR [--save OUT]
    python pagan2_tpu_torch/tools/bench_linear_calls.py --check OUT
    python pagan2_tpu_torch/tools/bench_linear_calls.py --lanes [--tiles T,...]
    python pagan2_tpu_torch/tools/bench_linear_calls.py --giant [--root DIR]
        [--save OUT | --check OUT] [--tiles T,...]

Run as a file, --root times the pagan2_tpu_torch package of the
checkout DIR instead of this one, so that two versions of the kernel
compare on one card in one call (in turns: parent, change, change,
parent). --save writes a digest of every call's codes and corner under
OUT; --check holds this run's bit for bit against them
(tools/replay.py).

--lanes (a card only) times kernel A's builds instead: on a batch of 8
pairs at each row count of LANE_ROWS (32 to 4,096), every build that
can take it (lane_plans: 1 and 2 rows a thread, and the tiled build)
is launched, held bit for bit against the build its plan names, and
timed; each line marks the plan's own.

--giant replays kernel A's calls past 4,096 rows instead, each in its
ordinary and its pair-end build (giant_batches: chip_smoke.py's gate
pair, 65,535 bp against a 1,023 bp read of it; a 16,569 bp pair, the
length of a human mitochondrion; the global batch of linear_batches),
with --root, --save and --check as above.

--tiles T,... (with --lanes or --giant, this checkout's tiled build)
also launches the tiled build at each tile of T threads x 2 rows on
each batch, held bit for bit against the plan's build and timed.
"""
from __future__ import annotations

import time

if __package__:
    from . import replay
    from .bench_fanin import family
else:           # run as a file: this directory is sys.path[0]
    import replay
    from bench_fanin import family

# --lanes: the row counts Lp whose batches (8 pairs of Lp - 1 bp) are
# timed with every build
LANE_ROWS = (32, 64, 128, 256, 512, 768, 1024, 1536, 2048, 2560, 3072,
             4096)
# --lanes: seconds of untimed launches on the first batch before
# anything is timed
WARM_UP_S = 1.0
# --giant: timed launches a call after the first (a parent's global
# build took ~4.2 s a launch at the gate)
GIANT_REPS = 3


def linear_batches(rng, model, settings, small=False):
    """chip_smoke.py's kernel_linear batches, drawn from `rng` in its
    order: 8 pairs of 2047 bp; a ragged batch of 4 pairs (300-1531 bp,
    the right side cut by 1/17) with bands of +-40 columns; 2 jobs past
    4096 rows (5000 x 1900, 4500 x 2400). Returns [(name, inputs,
    bands)]: prepare_sheared dicts with _add_scalar_params applied.
    small: the same kinds at a few hundred bp (for the CPU)."""
    import numpy as np
    from pagan2_tpu_torch.align.viterbi_linear import _add_scalar_params
    from pagan2_tpu_torch.align.viterbi_sheared import prepare_sheared
    from pagan2_tpu_torch.graph import build_leaf_graph
    from pagan2_tpu_torch.models import alphabets as alph

    def mutate(base):
        mut = base.copy()
        idx = rng.random(len(base)) < 0.1
        mut[idx] = rng.choice(list("ACGT"), size=int(idx.sum()))
        return "".join(mut)

    def prep(s1, s2):
        return _add_scalar_params(prepare_sheared(
            build_leaf_graph(s1, alph.DNA), build_leaf_graph(s2, alph.DNA),
            model, settings, np.float32))

    n8, ragged, big = ((4, 100), (60, 77, 120, 153),
                       ((300, 100), (250, 120))) if small else \
        ((8, 2047), (300, 777, 1200, 1531), ((5000, 1900), (4500, 2400)))
    out = []
    inps = []
    for _ in range(n8[0]):
        base = rng.choice(list("ACGT"), size=n8[1])
        inps.append(prep("".join(base), mutate(base)))
    out.append(("%dx%d" % n8, inps, [None] * n8[0]))
    inps, bands = [], []
    for n in ragged:
        base = rng.choice(list("ACGT"), size=n)
        x = prep("".join(base), mutate(base)[: n - n // 17])
        c = np.arange(x["L"]) * x["R"] // x["L"]
        bands.append((np.maximum(c - 40, 0),
                      np.minimum(c + 40, x["R"] - 1)))
        inps.append(x)
    out.append(("ragged banded", inps, bands))
    inps = []
    for n, m in big:
        base = rng.choice(list("ACGT"), size=n)
        inps.append(prep("".join(base), mutate(base[n // 3: n // 3 + m])))
    out.append(("%d rows" % big[0][0], inps, [None] * len(big)))
    return out


def giant_pairs(small=False):
    """--giant's pairs as (name, left, right) sequences: chip_smoke.py's
    gate pair (default_rng(65536): a 65,535 bp sequence against a
    1,023 bp read of it at 20,000 with 10% of its sites redrawn) and a
    16,569 bp pair, the length of a human mitochondrion
    (default_rng(16569): a sequence and a copy with 10% of its sites
    redrawn). small: 600 x 100 and 300 x 300 (for the CPU)."""
    import numpy as np

    def mutate(rng, base):
        mut = base.copy()
        idx = rng.random(len(base)) < 0.1
        mut[idx] = rng.choice(list("ACGT"), size=int(idx.sum()))
        return "".join(mut)

    (gl, gr, g0), mito = ((600, 100, 200), 300) if small else \
        ((65535, 1023, 20000), 16569)
    rng = np.random.default_rng(65536)
    gate = rng.choice(list("ACGT"), size=gl)
    read = mutate(rng, gate[g0:g0 + gr])
    rng = np.random.default_rng(16569)
    base = rng.choice(list("ACGT"), size=mito)
    return [("gate %dx%d" % (gl, gr), "".join(gate), read),
            ("pair %d" % mito, "".join(base), mutate(rng, base))]


def giant_batches(model, settings, small=False):
    """--giant's batches, each in the ordinary and then the pair-end
    build (every job pair-end with no break column, the reference's
    scan-core rule): the two giant_pairs, one job each, and the global
    batch of linear_batches (default_rng(11)). Yields (name, inputs,
    bands) one at a time, so that a gate batch's inputs (17.4 GB of
    match scores on the card) leave before the next is made."""
    import numpy as np
    from pagan2_tpu_torch.align.viterbi_linear import _add_scalar_params
    from pagan2_tpu_torch.align.viterbi_sheared import prepare_sheared
    from pagan2_tpu_torch.graph import build_leaf_graph
    from pagan2_tpu_torch.models import alphabets as alph

    def prep(s1, s2, pe):
        inp = prepare_sheared(build_leaf_graph(s1, alph.DNA),
                              build_leaf_graph(s2, alph.DNA), model,
                              settings, np.float32)
        if pe:
            inp["pair_end"], inp["jbrk"] = True, -1
        return _add_scalar_params(inp)

    big = linear_batches(np.random.default_rng(11), model, settings,
                         small)[2]
    for name, s1, s2 in giant_pairs(small):
        for pe in (False, True):
            yield (name + (" pair-end" if pe else ""), [prep(s1, s2, pe)],
                   [None])
    for pe in (False, True):
        inps = [dict(x) for x in big[1]]
        if pe:
            for x in inps:
                x["pair_end"], x["jbrk"] = True, -1
                _add_scalar_params(x)
        yield big[0] + (" pair-end" if pe else ""), inps, big[2]


def pair_end_batches(model, small=False):
    """chip_smoke.py's pair-end batches of kernel A, from their own
    generator (default_rng(17)): per terminal-penalty setting (reduced
    and not), a ragged batch of 6 pair-end jobs (90-301 rows) whose
    break columns are 0, 1, mid, R - 2, R - 1 and none (-1), read 1 of
    the left side ending at a third of it on every other job; then 2
    pair-end jobs past 4096 rows (4200 and 4150 rows against 64 and 61
    columns: the global build), breaks mid and none. Returns [(name,
    inputs)]: prepare_sheared dicts with _add_scalar_params applied.
    small: the global batch cut to 400 rows (for the CPU)."""
    import numpy as np
    from dataclasses import replace
    from pagan2_tpu_torch.align import AlignSettings
    from pagan2_tpu_torch.align.viterbi_linear import _add_scalar_params
    from pagan2_tpu_torch.align.viterbi_sheared import prepare_sheared
    from pagan2_tpu_torch.graph import build_leaf_graph
    from pagan2_tpu_torch.models import alphabets as alph
    rng = np.random.default_rng(17)

    def job(n, m, ybrk, xbrk, reduced):
        base = rng.choice(list("ACGT"), size=max(n, m))
        mut = base.copy()
        idx = rng.random(len(base)) < 0.1
        mut[idx] = rng.choice(list("ACGT"), size=int(idx.sum()))
        R = m + 1                 # the columns: the start site and m bases
        y = {"mid": R // 2, "R-2": R - 2, "R-1": R - 1}.get(ybrk, ybrk)
        s = replace(AlignSettings(), pair_end_reads=True,
                    reduced_terminal_gap_penalties=reduced,
                    x_read1_length=n // 3 if xbrk else -1,
                    y_read1_length=y)
        return _add_scalar_params(prepare_sheared(
            build_leaf_graph("".join(base[:n]), alph.DNA),
            build_leaf_graph("".join(mut[len(mut) - m:]), alph.DNA),
            model, s, np.float32))

    out = []
    shapes = ((300, 280), (220, 250), (257, 131), (90, 120), (301, 301),
              (150, 97))
    for reduced in (True, False):
        out.append(("pair-end %s" % ("reduced" if reduced else "full"),
                    [job(n, m, y, k % 2 == 0, reduced)
                     for k, ((n, m), y) in enumerate(
                         zip(shapes, (0, 1, "mid", "R-2", "R-1", -1)))]))
    big = 400 if small else 4200
    out.append(("pair-end %d rows" % big,
                [job(big, 64, "mid", True, True),
                 job(big - 50, 61, -1, False, True)]))
    return out


def batch_args(VL, inps, bands, dev):
    """Kernel A's arguments for a batch of prepare_sheared dicts."""
    Lp = VL.batch_rows(inps)
    return VL.linear_batch_args(
        [VL.linear_job_arrays(x, Lp, band=b) for x, b in zip(inps, bands)],
        dev)


def own_plan(VL, Lp, pair_end=False):
    """Kernel A's launch plan on Lp rows in the ordinary or the pair-end
    build (a package whose plan does not depend on the build: its one
    plan)."""
    if hasattr(VL, "PAIR_END_TILE_THREADS"):
        return VL.linear_plan(Lp, pair_end)
    return VL.linear_plan(Lp)


def plan_text(VL, Lp, pair_end=False):
    """Kernel A's launch plan on Lp rows as text ("" for a package
    without linear_plan: the parent of the lane builds)."""
    if not hasattr(VL, "linear_plan"):
        return ""
    return build_text(own_plan(VL, Lp, pair_end))


def call_pair_end(kw):
    """Whether linear_fill takes its pair-end build on the call kw."""
    pe = kw.get("pair_end")
    return bool((kw["iscal"][:, 3] != 0).any()) if pe is None else bool(pe)


def build_text(p):
    """One of kernel A's builds as text."""
    if p.get("diagonals") == "tiles":
        return "tiles of %d threads x 2 rows (tiled build)" % p["threads"]
    if p["rows"]:
        return "%d threads x %d rows, diagonals in registers" % (
            p["threads"], p["rows"])
    return "%d threads, diagonals in global scratch (global build)" \
        % p["threads"]


def lane_plans(VL, Lp, tiles=(), pair_end=False):
    """Every build of kernel A that can take Lp rows, as [(label, plan)],
    the plan's own (in the ordinary or the pair-end build) first: each
    lane build of LANES where the block holds Lp rows in at most 1024
    threads (Lp a whole number of warps), and the tiled build at the
    ordinary and the pair-end build's tiles and at each tile threads of
    `tiles` (a package without it: the global build)."""
    own = own_plan(VL, Lp, pair_end)
    cands = []
    if Lp % 32 == 0:
        cands = [dict(rows=r, threads=VL._block(Lp, r),
                      diagonals="registers") for r, _top in VL.LANES
                 if VL._block(Lp, r) <= 1024]
    if hasattr(VL, "tiled_plan"):
        cands += [VL.tiled_plan(t) for t in
                  [VL.TILE_THREADS, VL.PAIR_END_TILE_THREADS] + list(tiles)]
    else:
        cands.append(dict(rows=0, threads=min(1024, VL._block(Lp, 1)),
                          diagonals="global"))
    cands = [own] + [c for c in cands if c != own]
    out = []
    for p in cands:
        if p not in [q for _t, q in out]:
            out.append((build_text(p), p))
    return out


def tile_sweep(text):
    """--tiles: "T,T,..." as [threads]."""
    return [int(t) for t in text.split(",")]


def time_builds(torch, VL, kw, source, plans, warm):
    """Each of `plans` ([(label, plan)], the plan's own first) launched
    on kw, held bit for bit against the first and timed (CUDA events,
    REPS launches); `warm`: seconds of untimed launches of the plan's
    own build first. Returns the runs."""
    B, D, Lp = kw["ms"].shape
    t = time.perf_counter()
    while time.perf_counter() - t < warm:
        # the card's clocks up before the first timing
        VL._launch_linear(plans[0][1], **kw)
        torch.cuda.synchronize()
    runs, ref = [], None
    for k, (text, plan) in enumerate(plans):
        out = VL._launch_linear(plan, **kw)
        torch.cuda.synchronize()
        if ref is None:
            ref, same = out, True
        else:
            same = torch.equal(out[0], ref[0]) and torch.equal(
                out[1].view(torch.int32), ref[1].view(torch.int32))
        del out
        ms = replay.time_call(
            torch, lambda p=plan: VL._launch_linear(p, **kw), {},
            replay.REPS)
        runs.append(dict(source=source, B=B, D=D, Lp=Lp, build=text,
                         rows=plan["rows"], plan=k == 0, ms=ms,
                         us_per_diagonal=1e3 * ms / D, same=same))
        print("%-8s B %d, D %d, Lp %d: %-50s %9.4f ms, %.4f us per "
              "diagonal%s%s" % (source, B, D, Lp, text, ms, 1e3 * ms / D,
                                " (plan)" if k == 0 else "",
                                "" if same else
                                ", DIFFERS from the plan's build"),
              flush=True)
    return runs


def time_lanes(args, torch, VL, common):
    """--lanes: each batch of LANE_ROWS with every build of lane_plans,
    held bit for bit against the plan's own build and timed. Returns the
    runs."""
    runs = []
    for Lp in LANE_ROWS:
        inps, _cells = common.pair_jobs(8, Lp - 1)
        kw = batch_args(VL, inps, [None] * len(inps), args.device)
        runs += time_builds(torch, VL, kw, "8x%d" % (Lp - 1),
                            lane_plans(VL, Lp, args.tiles),
                            0.0 if runs else WARM_UP_S)
    return runs


def time_giant(args, torch, dev, root, VL):
    """--giant: giant_batches through linear_fill (replayed: digests
    saved or checked, then timed), and with --tiles every tiled build of
    the sweep on the same inputs."""
    from pagan2_tpu_torch.align import AlignSettings
    from pagan2_tpu_torch.models import ModelFactory, alphabets as alph
    model = ModelFactory(alph.DNA).alignment_model(0.2)
    names, sweeps = [], []

    def calls():
        for name, inps, bands in giant_batches(model, AlignSettings(),
                                               args.small):
            names.append(name)
            yield VL.linear_fill, batch_args(VL, inps, bands, dev), \
                GIANT_REPS
    runs = []
    for k, kw, ms, same in replay.replay(args, torch, dev, "linear_giant",
                                         calls()):
        B, D, Lp = kw["ms"].shape
        pe = call_pair_end(kw)
        rec = dict(source=names[k], B=B, D=D, Lp=Lp,
                   plan=plan_text(VL, Lp, pe), ms=ms,
                   us_per_diagonal=1e3 * ms / D, same=same)
        runs.append(rec)
        print("%-22s B %d, D %d, Lp %d: %9.4f ms, %.4f us per diagonal%s%s"
              % (rec["source"], B, D, Lp, ms, rec["us_per_diagonal"],
                 "; " + rec["plan"] if rec["plan"] else "",
                 replay.same_text(same)), flush=True)
        if args.tiles:
            own = own_plan(VL, Lp, pe)
            plans = [(build_text(own), own)] + [
                (build_text(p), p) for p in
                (VL.tiled_plan(t) for t in args.tiles) if p != own]
            sweeps += time_builds(torch, VL, kw, names[k], plans, 0.0)
        del kw
    if sweeps and not all(r["same"] for r in sweeps):
        raise SystemExit("a tiled build differs from the plan's")
    return runs


def probe_floor(args, torch, dev):
    """The probe's all-off case (kernel F: codes, match score, masks and
    corner off) on its 16 x 2047 batch (2 x 100 with --small), TD 16:
    (ms, us per diagonal); on the CPU its plain version by the host
    clock."""
    from pagan2_tpu_torch.align import viterbi_linear_probe as VP
    from pagan2_tpu_torch.tools import common
    opts = ("nobp", "noms", "nomask", "nocorner")
    inps, _cells = common.pair_jobs(*((2, 100) if args.small
                                      else (16, 2047)))
    kw = VP.probe_args(common.job_arrays(inps), dev, 16)
    ms = common.time_ms(lambda: VP.probe_fill(**kw, TD=16, opts=opts), dev)
    return ms, 1e3 * ms / kw["ms"].shape[0]


def main(argv=None):
    p = replay.parser(
        __doc__.splitlines()[0], "kernel A",
        "a 4 x 200 family, a 2 x 200 batch and kernel_linear's batches at "
        "a few hundred bp (for the CPU)")
    p.add_argument("--lanes", action="store_true",
                   help="time kernel A's builds on LANE_ROWS' batches (a "
                        "card only)")
    p.add_argument("--giant", action="store_true",
                   help="replay kernel A's calls past 4,096 rows "
                        "(giant_batches)")
    p.add_argument("--tiles", type=tile_sweep, default=[],
                   help="with --lanes or --giant: also the tiled build at "
                        "each T (tile threads), a card only")
    args = p.parse_args(argv)
    if (args.lanes or args.tiles) and args.device != "cuda":
        raise SystemExit("--lanes and --tiles launch kernel A's builds: a "
                         "card only")
    if args.tiles and not (args.lanes or args.giant):
        raise SystemExit("--tiles goes with --lanes or --giant")
    torch, dev, root = replay.start(args)
    import numpy as np
    from pagan2_tpu_torch import cli as CLI
    from pagan2_tpu_torch.align import AlignSettings
    from pagan2_tpu_torch.align import viterbi_linear as VL
    from pagan2_tpu_torch.models import ModelFactory, alphabets as alph
    from pagan2_tpu_torch.tools import common
    from pagan2_tpu_torch.tools.sweep_linear import padded_args
    if args.lanes:
        runs = time_lanes(args, torch, VL, common)
        if not all(r["same"] for r in runs):
            raise SystemExit("a build differs from the plan's")
        return replay.finish(args, torch, dev, root, runs,
                             ("source", "build"))
    if args.giant:
        return replay.finish(args, torch, dev, root,
                             time_giant(args, torch, dev, root, VL),
                             ("source",))

    seqs, tree = family(*((4, 200) if args.small else (16, 1535)))
    calls = [(run, kw) for run, flags in (("main", ()), (
        "fullprob", ("--full-probability",))) for _n, kw in replay.record_cli(
            CLI, VL, ("linear_fill",), seqs, tree, "bench_linear_calls",
            args.device, flags)]
    B, N = (2, 200) if args.small else (8, 4095)
    inps, _cells = common.pair_jobs(B, N)
    calls.append(("%dx%d" % (B, N),
                  padded_args(common.job_arrays(inps), dev, 16)[0]))
    for name, inps, bands in linear_batches(
            np.random.default_rng(11), ModelFactory(alph.DNA)
            .alignment_model(0.2), AlignSettings(), args.small):
        calls.append((name, batch_args(VL, inps, bands, dev)))

    runs = []
    for k, kw, ms, same in replay.replay(
            args, torch, dev, "linear",
            [(VL.linear_fill, kw, replay.REPS) for _w, kw in calls]):
        B, D, Lp = kw["ms"].shape
        rec = dict(source=calls[k][0], B=B, D=D, Lp=Lp,
                   plan=plan_text(VL, Lp, call_pair_end(kw)), ms=ms,
                   us_per_diagonal=1e3 * ms / D, same=same)
        runs.append(rec)
        print("%-14s B %d, D %d, Lp %d: %9.4f ms, %.4f us per diagonal%s%s"
              % (rec["source"], B, D, Lp, ms, rec["us_per_diagonal"],
                 "; " + rec["plan"] if rec["plan"] else "",
                 replay.same_text(same)), flush=True)
    floor_ms, floor_us = probe_floor(args, torch, dev)
    print("probe all-off floor (kernel F, %s): %.4f ms, %.4f us per "
          "diagonal" % ("2x100" if args.small else "16x2047", floor_ms,
                        floor_us), flush=True)
    for r in runs:
        r["floor_us_per_diagonal"] = floor_us
    return replay.finish(args, torch, dev, root, runs, ("source",))


if __name__ == "__main__":
    main()
