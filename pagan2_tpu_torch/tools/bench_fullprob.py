"""Bench of kernels D and E (the scaled forward and backward plane
fills) on the calls a real run gives them: chip_smoke.py's 16 x 1535
family (bench.py's generator, seed 5) through the CLI with
--full-probability, one linear batch of leaf pairs and three fan-in
batches of ancestor pairs; then the fan-in calls of a 6 x 2000 family's
run (ancestors past 1536 lanes, backward-edge K 2/2, forward 1/2 and
2/2) and a batch of four 454-style pairs of 2047 bp (K3/3 backward
edges, 2/2 forward), the fan-in shapes past the main path's.
Prints each call's source, entry point, B, D, Lp, K, G, the kernel's
launch plan, ms (CUDA events over REPS launches after one warm-up) and
us per diagonal, and last a JSON line with the mean and the sum of each
source's entry points. Kernel D is the subject; kernel E is the
control: a change to kernel D must leave E's times where they were.

    python -m pagan2_tpu_torch.tools.bench_fullprob [--device cpu --small]
    python pagan2_tpu_torch/tools/bench_fullprob.py --root DIR [--save OUT]
    python pagan2_tpu_torch/tools/bench_fullprob.py --check OUT
    python pagan2_tpu_torch/tools/bench_fullprob.py --lanes
    python pagan2_tpu_torch/tools/bench_fullprob.py --giant [--root DIR]
    python pagan2_tpu_torch/tools/bench_fullprob.py --giant --clusters 2x2,8x4

Run as a file, --root times the pagan2_tpu_torch package of the
checkout DIR instead of this one, so that two versions of the kernels
compare on one card in one call (in turns: parent, change, change,
parent). --save writes a digest of every call's planes and cum under
OUT; --check holds this run's bit for bit against them
(tools/replay.py).

--lanes (a card only) times the linear and lane builds instead: on the
calls of the --full-probability runs of families from 128 to 8,192
lanes (LANE_FAMILIES), every build of kernel D (linear and fan-in) and
of kernel E (linear) that can take a call (lane_plans: the lane builds
and, on the linear calls, the cluster build at each size the plan
picks) is launched, held bit for bit against the build its plan names,
and timed; each line marks the plan's own. It sets the cluster build's
first width (fullprob_fill.CLUSTER_FROM).

--giant replays both linear entry points on the calls past 4,096 lanes
instead (giant_calls: a 16,569 bp pair, the 5,000 bp pair of
redrawn_pair and a ragged batch), with --root, --save and --check as
above, GIANT_REPS timed launches a call; --clusters C x rows,... (this
checkout, a card only) also forces the cluster build at each size on
the same calls, each held bit for bit against the plan's build, timed,
and printed with how many such clusters the card holds at once.
"""
from __future__ import annotations

if __package__:
    from . import replay
    from .bench_fanin import family
else:           # run as a file: this directory is sys.path[0]
    import replay
    from bench_fanin import family

ENTRIES = ("fullprob_fwd", "fullprob_bwd", "fullprob_fwd_fanin",
           "fullprob_bwd_fanin")
# --lanes: (leaves, bp) of the families whose kernel-D calls (and
# kernel E's linear calls) are timed with every lane build: 128, 256,
# 512, 544, 1,024, 1,536, 2,016 and 2,112 lanes; then pairs (two leaves:
# one linear call each way) of 2,500 to 8,100 bp, where the lane builds
# meet the cluster build
LANE_FAMILIES = ((8, 120), (8, 250), (8, 500), (8, 520), (8, 1000),
                 (16, 1535), (6, 2000), (6, 2100), (2, 2500), (2, 3000),
                 (2, 4000), (2, 4200), (2, 6000), (2, 8100))
# --giant: timed launches a call after the first (the parent's one
# block a pair takes about a second a launch at 16,569 bp)
GIANT_REPS = 3


def _lanes(p, Lp):
    """A plan's threads and lanes a thread, as text (a linear plan of
    a checkout before the cluster build may name its build for any
    count, rows 0)."""
    if p.get("cluster"):
        return "cluster of %d CTAs x %d threads x %d rows" % (
            p["cluster"], p["threads"], p["rows"])
    rows = p["rows"] or -(-Lp // p["threads"])
    return "%d threads x %d rows%s" % (p["threads"], rows, "" if p["rows"]
                                       else " (build for any count)")


def fanin_plan_text(FF, kw):
    """Kernel D's or E's fan-in launch plan for one call's arguments (D
    reads the backward-edge slots loff/roff, E the forward-edge ones
    lfoff/rfoff), as text (chip_smoke.py prints it too)."""
    fwd = "loff" in kw
    lo, ro = (kw["loff"], kw["roff"]) if fwd else (kw["lfoff"], kw["rfoff"])
    p = (FF.fwd_fanin_plan if fwd else FF.bwd_fanin_plan)(
        lo.shape[1], kw["G"], lo.shape[2], ro.shape[2], ro.shape[1])
    return ("K %d/%d (%s), ring %s (%d of %d diagonals on chip), right "
            "slots in %s memory, %s"
            % (lo.shape[2], ro.shape[2],
               "templated" if p["KL"] else "runtime K", p["placement"],
               p["hot"], kw["G"] + 1, "shared" if p["rtab"] else "device",
               _lanes(p, lo.shape[1])))


def plan_text(FF, name, kw):
    """Kernel D's or E's launch plan of one call as text ("" for a
    package without that plan: kernel D before its plans)."""
    direction = name.split("_")[1]                  # fwd or bwd
    if name.endswith("_fanin"):
        if not hasattr(FF, direction + "_fanin_plan"):
            return ""
        return fanin_plan_text(FF, kw)
    planner = getattr(FF, direction + "_linear_plan", None)
    if planner is None:
        return ""
    Lp = kw["ms2"].shape[2]
    p = planner(Lp)
    return "%s, buffers %s" % (_lanes(p, Lp), "global" if p.get("shared")
                               is False else "shared")


def cluster_sweep(text):
    """--clusters: "C x rows" sizes, e.g. "2x2,8x4,16x4"."""
    out = []
    for item in text.split(","):
        c, r = (int(v) for v in item.lower().split("x"))
        out.append((c, r))
    return out


def lane_plans(FF, name, kw):
    """Every build of kernel D or E that can take one of its calls, as
    [(label, plan)], the plan's own first. Linear (D and E): 1 and 2
    lanes a thread on one block a pair, and the cluster build at each
    size the plan picks (FF.CLUSTER_SIZES: 8 and 16; --giant --clusters
    forces others) with 2 and 4 lanes a thread. Fan-in (D), with the
    plan's ring and table placement: the templated fan-in with 2 lanes
    a thread and, up to K 2 x 2, 4; the runtime-K build with 2 lanes and
    with any count. Only builds whose block the kernel accepts are
    listed."""
    if name in ("fullprob_fwd", "fullprob_bwd"):
        Lp = kw["ms2"].shape[2]
        cell = 32 if name == "fullprob_fwd" else 16
        own = (FF.fwd_linear_plan if cell == 32 else FF.bwd_linear_plan)(Lp)
        cands = [dict(rows=r, threads=FF._block(Lp, r), cluster=0,
                      smem=cell * (Lp + 1)) for r in (1, 2)
                 if FF._block(Lp, r) <= 1024]
        cands += [p for C in FF.CLUSTER_SIZES for r in (2, 4)
                  for p in [FF.cluster_build(Lp, C, r, cell)] if p]
        key = ("rows", "threads", "cluster")
    else:
        lo, ro = kw["loff"], kw["roff"]
        Lp, KL, KR = lo.shape[1], lo.shape[2], ro.shape[2]
        own = FF.fwd_fanin_plan(Lp, kw["G"], KL, KR, ro.shape[1])
        builds = [(0, 0, 2, 768), (0, 0, 0, 1024)]
        if max(KL, KR) <= FF.TEMPLATE_K:
            small = max(KL, KR) <= 2
            builds[:0] = [(KL, KR, 2, 768 if small else 384)] + \
                ([(KL, KR, 4, 512)] if small else [])
        cands = [dict(own, KL=kl, KR=kr, rows=r,
                      threads=min(top, FF._block(Lp, 1)) if r == 0
                      else FF._block(Lp, r))
                 for kl, kr, r, top in builds
                 if r == 0 or FF._block(Lp, r) <= top]
        key = ("KL", "KR", "rows", "threads")
    same = [c for c in cands if all(c[k] == own[k] for k in key)]
    cands = [own] + [c for c in cands if c not in same]

    def label(p):
        if "KL" in p:
            return ("K %d/%d, " % (p["KL"], p["KR"]) if p["KL"] else
                    "runtime K, ") + _lanes(p, Lp)
        return _lanes(p, Lp)
    return [(label(p), p) for p in cands]


def _launch(FF, name, plan, kw):
    """One launch of the build `plan` of the entry point `name`."""
    if name in ("fullprob_fwd", "fullprob_bwd"):
        return FF._launch_linear(name, plan, **kw)
    Lp = kw["msp"].shape[2]
    return FF._launch_fanin("fullprob_fwd", plan, (kw["G"] + 1, Lp, 4),
                            **kw)


def time_builds(torch, FF, name, kw, source, plans, reps):
    """Each of `plans` ([(label, plan)], the plan's own first) launched
    on one call, held bit for bit against the first and timed; prints a
    line each and returns the runs."""
    linear = "ms2" in kw
    B, D, Lp = (kw["ms2"] if linear else kw["msp"]).shape
    K = "" if linear else "%d/%d" % (kw["loff"].shape[2],
                                     kw["roff"].shape[2])
    runs, ref = [], None
    for k, (text, plan) in enumerate(plans):
        out = _launch(FF, name, plan, kw)
        torch.cuda.synchronize()
        if ref is None:
            ref, same = out, True
        else:
            same = all(torch.equal(a, b) for a, b in zip(out, ref))
        del out
        fit = FF.linear_clusters(name, plan) if plan.get("cluster") \
            else None
        ms = replay.time_call(torch, lambda p=plan: _launch(FF, name, p, kw),
                              {}, reps)
        runs.append(dict(source=source, entry=name, B=B, D=D, Lp=Lp, K=K,
                         build=text, plan=k == 0, ms=ms,
                         us_per_diagonal=1e3 * ms / D, same=same,
                         clusters_at_once=fit))
        print("%-12s %-18s B %d, D %d, Lp %d%s: %-44s %9.4f ms, %.4f us "
              "per diagonal%s%s%s"
              % (source, name, B, D, Lp, ", K " + K if K else "", text, ms,
                 1e3 * ms / D, "" if fit is None else
                 " (%d clusters at once)" % fit,
                 " (plan)" if k == 0 else "",
                 "" if same else ", DIFFERS from the plan's build"),
              flush=True)
    return runs


def time_lanes(args, torch, FF, CLI):
    """--lanes: each of LANE_FAMILIES' kernel-D calls and kernel-E
    linear calls with every build of lane_plans, held bit for bit
    against the plan's own and timed. Returns the runs."""
    runs = []
    names = ("fullprob_fwd", "fullprob_bwd", "fullprob_fwd_fanin")
    for n, L in LANE_FAMILIES:
        for name, kw in replay.record_cli(
                CLI, FF, names, *family(n, L), "bench_fullprob",
                args.device, ("--full-probability",)):
            runs += time_builds(torch, FF, name, kw, "%dx%d" % (n, L),
                                lane_plans(FF, name, kw), replay.REPS)
    return runs


def redrawn_pair(n=5000, seed=5000, indels=0.0):
    """A sequence of n sites (default_rng(seed)) and a copy with 10% of
    its sites redrawn: the 5,000 bp pair of --giant. With indels, the
    copy also loses or gains 1 to 3 sites after that share of its sites
    (half deletions, half insertions; drawn after the redrawn sites, so
    these stay the same): the pair of chip_smoke.py's fullprob_long_path
    and of the full-probability parity test
    (tests/test_torch_fullprob_long.py), indels 0.01, whose sampled path
    differs from its Viterbi path."""
    import numpy as np
    rng = np.random.default_rng(seed)
    base = rng.choice(list("ACGT"), size=n)
    mut = base.copy()
    idx = rng.random(n) < 0.1
    mut[idx] = rng.choice(list("ACGT"), size=int(idx.sum()))
    if indels:
        at = np.flatnonzero(rng.random(n) < indels)
        size = rng.integers(1, 4, size=at.size)
        insert = rng.random(at.size) < 0.5
        out, k = [], 0
        for p, s, ins in zip(at, size, insert):
            if p < k:
                continue
            out.append(mut[k:p + 1])
            if ins:
                out.append(rng.choice(list("ACGT"), size=s))
                k = p + 1
            else:
                k = p + 1 + s
        out.append(mut[k:])
        mut = np.concatenate(out)
    return "".join(base), "".join(mut)


def giant_calls(FF, dev, small=False):
    """--giant's linear calls, one batch at a time as (name, kwargs of
    both entry points): a 16,569 bp pair (bench_linear_calls.py's
    giant_pairs, default_rng(16569)), redrawn_pair's 5,000 bp pair, and
    a ragged batch of three pairs of 4,500 to 6,000 x 3,000 to 5,500 bp
    (default_rng(4097)). small: 300 bp, 200 bp and 150 to 250 bp (for
    the CPU)."""
    import numpy as np
    from pagan2_tpu_torch.align import fullprob as FP
    from pagan2_tpu_torch.graph import build_leaf_graph
    from pagan2_tpu_torch.models import ModelFactory, alphabets as alph
    model = ModelFactory(alph.DNA).alignment_model(0.2)

    def batch(pairs):
        return FF.linear_batch_args(
            [FP.linear_fullprob_inputs(build_leaf_graph(a, alph.DNA),
                                       build_leaf_graph(b, alph.DNA), model)
             for a, b in pairs], dev)
    mito = redrawn_pair(300 if small else 16569, 16569)
    yield "pair %d" % len(mito[0]), batch([mito])
    five = redrawn_pair(200 if small else 5000)
    yield "pair %d" % len(five[0]), batch([five])
    rng = np.random.default_rng(4097)
    sizes = ((250, 230), (180, 150), (150, 200)) if small else \
        ((6000, 5500), (4500, 4700), (5200, 3000))
    pairs = []
    for n, m in sizes:
        a, b = redrawn_pair(max(n, m), int(rng.integers(1 << 30)))
        pairs.append((a[:n], b[:m]))
    yield "ragged batch", batch(pairs)


def time_giant(args, torch, dev, FF):
    """--giant: giant_calls through both linear entry points (replayed:
    digests saved or checked, then timed) and, with --clusters, every
    cluster build of the sweep on the same calls."""
    names, runs, sweeps = [], [], []

    def calls():
        for what, kw in giant_calls(FF, dev, args.small):
            for name in ("fullprob_fwd", "fullprob_bwd"):
                names.append((what, name))
                yield getattr(FF, name), kw, GIANT_REPS
    for k, kw, ms, same in replay.replay(args, torch, dev,
                                         "fullprob_giant", calls()):
        what, name = names[k]
        B, D, Lp = kw["ms2"].shape
        rec = dict(source=what, entry=name, B=B, D=D, Lp=Lp,
                   plan=plan_text(FF, name, kw), ms=ms,
                   us_per_diagonal=1e3 * ms / D, same=same)
        runs.append(rec)
        print("%-12s %-12s B %d, D %d, Lp %d: %10.4f ms, %.4f us per "
              "diagonal%s%s"
              % (what, name, B, D, Lp, ms, rec["us_per_diagonal"],
                 "; " + rec["plan"] if rec["plan"] else "",
                 replay.same_text(same)), flush=True)
        if args.clusters:
            cell = 32 if name == "fullprob_fwd" else 16
            own = (FF.fwd_linear_plan if cell == 32 else
                   FF.bwd_linear_plan)(Lp)
            plans = [(_lanes(own, Lp), own)] + [
                (_lanes(p, Lp), p) for C, r in args.clusters
                for p in [FF.cluster_build(Lp, C, r, cell)]
                if p and p != own]
            sweeps += time_builds(torch, FF, name, kw, what, plans,
                                  GIANT_REPS)
        del kw
    if sweeps and not all(r["same"] for r in sweeps):
        raise SystemExit("a cluster build differs from the plan's")
    return runs


def calls_454(args, FF, dev):
    """Both fan-in entry points on four 454-style pairs of 2047 bp
    (two of 100 with --small), shaped as chip_smoke.py's kernel_fullprob
    case "fan-in 454 4x2047"."""
    import numpy as np
    from pagan2_tpu_torch.align import fullprob as FP
    from pagan2_tpu_torch.graph import build_leaf_graph
    from pagan2_tpu_torch.models import ModelFactory, alphabets as alph
    model = ModelFactory(alph.DNA).alignment_model(0.2)
    rng = np.random.default_rng(11)
    B, N = (2, 100) if args.small else (4, 2047)
    inps = []
    for _ in range(B):
        base = rng.choice(list("ACGT"), size=N)
        base[N // 3:N // 3 + 6] = "A"
        base[2 * N // 3:2 * N // 3 + 5] = "T"
        mut = base.copy()
        idx = rng.random(N) < 0.1
        mut[idx] = rng.choice(list("ACGT"), size=int(idx.sum()))
        inps.append(FP.fanin_fullprob_inputs(
            build_leaf_graph("".join(base), alph.DNA, mode454=True),
            build_leaf_graph("".join(mut), alph.DNA, mode454=True), model))
    fwd, bwd = FF.fanin_batch_args(inps, dev)
    return [("fullprob_fwd_fanin", fwd), ("fullprob_bwd_fanin", bwd)]


def main(argv=None):
    p = replay.parser(
        __doc__.splitlines()[0], "kernels D and E",
        "4 x 120 and 6 x 150 families and two 454 pairs of 100 bp (for "
        "the CPU)")
    p.add_argument("--lanes", action="store_true",
                   help="time kernel D's and E's builds on "
                        "LANE_FAMILIES' calls (a card only)")
    p.add_argument("--giant", action="store_true",
                   help="replay the linear entry points on the calls "
                        "past 4,096 lanes (giant_calls)")
    p.add_argument("--clusters", type=cluster_sweep, default=[],
                   help="with --giant: also the cluster build at each "
                        "C x rows, a card only")
    args = p.parse_args(argv)
    if (args.lanes or args.clusters) and args.device != "cuda":
        raise SystemExit("--lanes and --clusters launch kernel D's and "
                         "E's builds: a card only")
    if args.clusters and not args.giant:
        raise SystemExit("--clusters goes with --giant")
    torch, dev, root = replay.start(args)
    from pagan2_tpu_torch import cli as CLI
    from pagan2_tpu_torch.align import fullprob_fill as FF
    if args.lanes:
        runs = time_lanes(args, torch, FF, CLI)
        if not all(r["same"] for r in runs):
            raise SystemExit("a lane build differs from the plan's")
        return replay.finish(args, torch, dev, root, runs,
                             ("source", "entry", "build"))
    if args.giant:
        return replay.finish(args, torch, dev, root,
                             time_giant(args, torch, dev, FF),
                             ("source", "entry"))

    def record(n, L, entries=ENTRIES):
        """The calls of the n x L family's --full-probability CLI run to
        the named wrappers, sorted by entry point."""
        return sorted(replay.record_cli(
            CLI, FF, entries, *family(n, L), "bench_fullprob", args.device,
            ("--full-probability",)), key=lambda c: ENTRIES.index(c[0]))
    main_fam, wide_fam = ((4, 120), (6, 150)) if args.small else \
        ((16, 1535), (6, 2000))
    sources = [("%dx%d" % main_fam, record(*main_fam)),
               ("%dx%d" % wide_fam, record(
                   *wide_fam, entries=("fullprob_fwd_fanin",
                                       "fullprob_bwd_fanin"))),
               ("454", calls_454(args, FF, dev))]
    calls = [(what, name, kw) for what, cs in sources for name, kw in cs]
    runs = []
    for k, kw, ms, same in replay.replay(
            args, torch, dev, "fullprob",
            [(getattr(FF, name), kw, replay.REPS)
             for _w, name, kw in calls]):
        what, name = calls[k][:2]
        B, D, Lp = (kw["ms2"] if "ms2" in kw else kw["msp"]).shape
        slots = [kw[s].shape[2] for s in ("loff", "roff", "lfoff",
                                          "rfoff") if s in kw]
        rec = dict(source=what, entry=name, B=B, D=D, Lp=Lp,
                   K="%d/%d" % tuple(slots) if slots else "",
                   G=kw.get("G"), plan=plan_text(FF, name, kw), ms=ms,
                   us_per_diagonal=1e3 * ms / D, same=same)
        runs.append(rec)
        print("%-8s %-18s B %d, D %d, Lp %d%s: %9.4f ms, %.4f us per "
              "diagonal%s%s"
              % (what, name, B, D, Lp, ", K %s, G %d" % (rec["K"], rec["G"])
                 if slots else "", ms, rec["us_per_diagonal"],
                 "; " + rec["plan"] if rec["plan"] else "",
                 replay.same_text(same)), flush=True)
    return replay.finish(args, torch, dev, root, runs, ("source", "entry"))


if __name__ == "__main__":
    main()
