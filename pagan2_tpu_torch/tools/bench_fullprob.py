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

Run as a file, --root times the pagan2_tpu_torch package of the
checkout DIR instead of this one, so that two versions of the kernels
compare on one card in one call (in turns: parent, change, change,
parent). --save writes a digest of every call's planes and cum under
OUT; --check holds this run's bit for bit against them
(tools/replay.py).

--lanes (a card only) times kernel D's lane builds instead: on the
linear and fan-in calls of the --full-probability runs of families
from 128 to 2,112 lanes (LANE_FAMILIES), every build that can take a
call (lane_plans) is launched, held bit for bit against the build its
plan names, and timed; each line marks the plan's own.
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
# --lanes: (leaves, bp) of the families whose kernel-D calls are timed
# with every lane build: 128, 256, 512, 544, 1,024, 1,536, 2,016 and
# 2,112 lanes
LANE_FAMILIES = ((8, 120), (8, 250), (8, 500), (8, 520), (8, 1000),
                 (16, 1535), (6, 2000), (6, 2100))


def _lanes(p, Lp):
    """A plan's threads and lanes a thread, as text."""
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
    return "%s, buffers %s" % (_lanes(p, Lp), "shared" if p["shared"]
                               else "global")


def lane_plans(FF, name, kw):
    """Every build of kernel D that can take one of its calls, as
    [(label, plan)], the plan's own first. Linear: 1, 2 and 4 lanes a
    thread with the row buffers in shared memory, and the build for any
    count with them in device memory. Fan-in, with the plan's ring and
    table placement: the templated fan-in with 2 lanes a thread and,
    up to K 2 x 2, 4; the runtime-K build with 2 lanes and with any
    count. Only builds whose block the kernel accepts are listed."""
    if name == "fullprob_fwd":
        Lp = kw["ms2"].shape[2]
        own = FF.fwd_linear_plan(Lp)
        cands = [dict(rows=r, threads=FF._block(Lp, r), shared=True,
                      smem=32 * (Lp + 1)) for r in (1, 2, 4)
                 if FF._block(Lp, r) <= 1024]
        cands.append(dict(rows=0, threads=min(1024, FF._block(Lp, 1)),
                          shared=False, smem=0))
        key = ("rows", "threads", "shared")
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
        what = ("K %d/%d, " % (p["KL"], p["KR"]) if p["KL"] else
                "runtime K, ") if "KL" in p else \
            ("buffers shared, " if p["shared"] else "buffers global, ")
        return what + _lanes(p, Lp)
    return [(label(p), p) for p in cands]


def time_lanes(args, torch, FF, CLI):
    """--lanes: each of LANE_FAMILIES' kernel-D calls with every build
    of lane_plans, held bit for bit against the plan's own and timed.
    Returns the runs."""
    runs = []
    for n, L in LANE_FAMILIES:
        for name, kw in replay.record_cli(
                CLI, FF, ("fullprob_fwd", "fullprob_fwd_fanin"),
                *family(n, L), "bench_fullprob", args.device,
                ("--full-probability",)):
            linear = name == "fullprob_fwd"
            B, D, Lp = (kw["ms2"] if linear else kw["msp"]).shape

            def launch(plan, kw=kw, linear=linear, Lp=Lp):
                if linear:
                    return FF._launch_linear("fullprob_fwd", plan,
                                             (3, Lp + 1, 4), **kw)
                return FF._launch_fanin("fullprob_fwd", plan,
                                        (kw["G"] + 1, Lp, 4), **kw)
            ref = None
            for k, (text, plan) in enumerate(lane_plans(FF, name, kw)):
                out = launch(plan)
                torch.cuda.synchronize()
                if ref is None:
                    ref, same = out, True
                else:
                    same = all(torch.equal(a, b) for a, b in zip(out, ref))
                ms = replay.time_call(torch, lambda p=plan: launch(p), {},
                                      replay.REPS)
                K = "" if linear else "%d/%d" % (kw["loff"].shape[2],
                                                 kw["roff"].shape[2])
                runs.append(dict(source="%dx%d" % (n, L), entry=name, B=B,
                                 D=D, Lp=Lp, K=K, build=text, plan=k == 0,
                                 ms=ms, us_per_diagonal=1e3 * ms / D,
                                 same=same))
                print("%-8s %-18s B %d, D %d, Lp %d%s: %-56s %9.4f ms, "
                      "%.4f us per diagonal%s%s"
                      % (runs[-1]["source"], name, B, D, Lp,
                         ", K " + K if K else "", text, ms,
                         1e3 * ms / D, " (plan)" if k == 0 else "",
                         "" if same else ", DIFFERS from the plan's build"),
                      flush=True)
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
                   help="time kernel D's lane builds on LANE_FAMILIES' "
                        "calls (a card only)")
    args = p.parse_args(argv)
    if args.lanes and args.device != "cuda":
        raise SystemExit("--lanes launches kernel D's builds: a card only")
    torch, dev, root = replay.start(args)
    from pagan2_tpu_torch import cli as CLI
    from pagan2_tpu_torch.align import fullprob_fill as FF
    if args.lanes:
        runs = time_lanes(args, torch, FF, CLI)
        if not all(r["same"] for r in runs):
            raise SystemExit("a lane build differs from the plan's")
        return replay.finish(args, torch, dev, root, runs,
                             ("source", "entry", "build"))

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
