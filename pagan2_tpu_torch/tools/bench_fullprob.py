"""Bench of kernels D and E (the scaled forward and backward plane
fills) on the calls a real run gives them: chip_smoke.py's 16 x 1535
family (bench.py's generator, seed 5) through the CLI with
--full-probability, one linear batch of leaf pairs and three fan-in
batches of ancestor pairs; then the fan-in calls of a 6 x 2000 family's
run (ancestors past 1536 lanes, forward-edge K 1/2 and 2/2) and a
batch of four 454-style pairs of 2047 bp (K3/3 backward edges, 2/2
forward), the fan-in shapes past the main path's.
Prints each call's source, entry point, B, D, Lp, K, G, kernel E's
launch plan, ms (CUDA events over REPS launches after one warm-up) and
us per diagonal, and last a JSON line with the mean and the sum of each
source's entry points. Kernel D is the control: a change to kernel E
must leave its times where they were.

    python -m pagan2_tpu_torch.tools.bench_fullprob [--device cpu --small]
    python pagan2_tpu_torch/tools/bench_fullprob.py --root DIR [--save OUT]
    python pagan2_tpu_torch/tools/bench_fullprob.py --check OUT

Run as a file, --root times the pagan2_tpu_torch package of the
checkout DIR instead of this one, so that two versions of the kernels
compare on one card in one call (in turns: parent, change, change,
parent). --save writes a digest of every call's planes and cum under
OUT; --check holds this run's bit for bit against them
(tools/replay.py).
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


def _lanes(p, Lp):
    """A plan's threads and lanes a thread, as text."""
    rows = p["rows"] or -(-Lp // p["threads"])
    return "%d threads x %d rows%s" % (p["threads"], rows, "" if p["rows"]
                                       else " (build for any count)")


def fanin_plan_text(FF, kw):
    """Kernel E's fan-in launch plan for one call's arguments, as text
    (chip_smoke.py prints it too)."""
    lo, ro = kw["lfoff"], kw["rfoff"]
    p = FF.bwd_fanin_plan(lo.shape[1], kw["G"], lo.shape[2], ro.shape[2],
                          ro.shape[1])
    return ("K %d/%d (%s), ring %s (%d of %d diagonals on chip), right "
            "slots in %s memory, %s"
            % (lo.shape[2], ro.shape[2],
               "templated" if p["KL"] else "runtime K", p["placement"],
               p["hot"], kw["G"] + 1, "shared" if p["rtab"] else "device",
               _lanes(p, lo.shape[1])))


def plan_text(FF, name, kw):
    """Kernel E's launch plan of one call as text ("" for kernel D, or
    for a package without plans)."""
    if name == "fullprob_bwd" and hasattr(FF, "bwd_linear_plan"):
        Lp = kw["ms2"].shape[2]
        p = FF.bwd_linear_plan(Lp)
        return "%s, buffers %s" % (_lanes(p, Lp), "shared" if p["shared"]
                                   else "global")
    if name == "fullprob_bwd_fanin" and hasattr(FF, "bwd_fanin_plan"):
        return fanin_plan_text(FF, kw)
    return ""


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
    args = replay.parser(
        __doc__.splitlines()[0], "kernels D and E",
        "4 x 120 and 6 x 150 families and two 454 pairs of 100 bp (for "
        "the CPU)").parse_args(argv)
    torch, dev, root = replay.start(args)
    from pagan2_tpu_torch import cli as CLI
    from pagan2_tpu_torch.align import fullprob_fill as FF

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
