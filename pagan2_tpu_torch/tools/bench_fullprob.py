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
parent). --save writes every call's planes and cum under OUT; --check
holds this run's bit for bit against them.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time

HERE = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
REPS = 5
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


def record(args, CLI, FF, family, n, L, entries=ENTRIES):
    """The calls of the n x L family's --full-probability CLI run to the
    named wrappers, recorded in their places and sorted by entry point."""
    calls = []
    real = {e: getattr(FF, e) for e in ENTRIES}

    def recorder(name):
        def fill(**kw):
            if name in entries:
                calls.append((name, kw))
            return real[name](**kw)
        return fill
    work = os.path.join(HERE, "build", "bench_fullprob")
    os.makedirs(work, exist_ok=True)
    seqs, tree = family(n, L)
    fas, nh = os.path.join(work, "family.fas"), os.path.join(work, "tree.nh")
    with open(fas, "w") as f:
        f.writelines(">%s\n%s\n" % s for s in seqs)
    with open(nh, "w") as f:
        f.write(tree + "\n")
    for name in ENTRIES:
        setattr(FF, name, recorder(name))
    try:
        rc = CLI.main(["-s", fas, "-t", nh, "-o", os.path.join(work, "out"),
                       "--silent", "--device", args.device,
                       "--full-probability"])
        if rc:
            raise SystemExit("the CLI returned %d" % rc)
    finally:
        for name in ENTRIES:
            setattr(FF, name, real[name])
    return sorted(calls, key=lambda c: ENTRIES.index(c[0]))


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


def time_call(torch, fn, kw, dev):
    """ms per call: CUDA events over REPS calls after the caller's
    warm-up call on a card, one call by the host clock on the CPU."""
    if dev.type == "cpu":
        t = time.perf_counter()
        fn(**kw)
        return 1e3 * (time.perf_counter() - t)
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    for _ in range(REPS):
        fn(**kw)
    t1.record()
    torch.cuda.synchronize()
    return t0.elapsed_time(t1) / REPS


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                   help="cuda (default; raises without a card) launches "
                        "kernels D and E; cpu runs their plain versions")
    p.add_argument("--small", action="store_true",
                   help="4 x 120 and 6 x 150 families and two 454 pairs "
                        "of 100 bp (for the CPU)")
    p.add_argument("--root", default=HERE,
                   help="checkout whose pagan2_tpu_torch is timed")
    p.add_argument("--save", help="directory to write outputs to")
    p.add_argument("--check", help="directory of saved outputs to match")
    args = p.parse_args(argv)
    root = os.path.abspath(args.root)
    sys.path.insert(0, root)
    import torch
    import pagan2_tpu_torch as PT
    if os.path.dirname(os.path.dirname(os.path.abspath(PT.__file__))) \
            != root:
        raise SystemExit("pagan2_tpu_torch was imported from %s, not from "
                         "--root %s: run this tool as a file"
                         % (PT.__file__, root))
    from pagan2_tpu_torch import cli as CLI
    from pagan2_tpu_torch.align import fullprob_fill as FF
    from pagan2_tpu_torch.tools.bench_fanin import family

    dev = torch.device(args.device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise SystemExit("--device cuda: torch.cuda.is_available() is "
                             "False")
        print("device: %s; package %s" % (torch.cuda.get_device_name(0),
                                          root), flush=True)
    else:
        print("device: cpu (plain versions; times by the host clock, not "
              "device times); package %s" % root, flush=True)
    main_fam, wide_fam = ((4, 120), (6, 150)) if args.small else \
        ((16, 1535), (6, 2000))
    sources = [("%dx%d" % main_fam, record(args, CLI, FF, family,
                                           *main_fam)),
               ("%dx%d" % wide_fam, record(
                   args, CLI, FF, family, *wide_fam,
                   entries=("fullprob_fwd_fanin", "fullprob_bwd_fanin"))),
               ("454", calls_454(args, FF, dev))]
    calls = [(what, name, kw) for what, cs in sources for name, kw in cs]
    runs = {}
    for k, (what, name, kw) in enumerate(calls):
        fn = getattr(FF, name)
        planes, cum = fn(**kw)
        if dev.type == "cuda":
            torch.cuda.synchronize()
        same = None
        path = os.path.join(args.save or args.check or "", "call%d.pt" % k)
        if args.save:
            os.makedirs(args.save, exist_ok=True)
            torch.save((name, planes.cpu(), cum.cpu()), path)
        if args.check:
            rn, rp, rc = torch.load(path)
            same = rn == name and all(
                torch.equal(a.cpu().view(torch.int32), b.view(torch.int32))
                for a, b in ((planes, rp), (cum, rc)))
        del planes, cum
        ms = time_call(torch, fn, kw, dev)
        B, D, Lp = (kw["ms2"] if "ms2" in kw else kw["msp"]).shape
        slots = [kw[s].shape[2] for s in ("loff", "roff", "lfoff",
                                          "rfoff") if s in kw]
        rec = dict(source=what, entry=name, B=B, D=D, Lp=Lp,
                   K="%d/%d" % tuple(slots) if slots else "",
                   G=kw.get("G"), plan=plan_text(FF, name, kw), ms=ms,
                   us_per_diagonal=1e3 * ms / D, same=same)
        runs.setdefault((what, name), []).append(rec)
        print("%-8s %-18s B %d, D %d, Lp %d%s: %9.4f ms, %.4f us per "
              "diagonal%s%s"
              % (what, name, B, D, Lp, ", K %s, G %d" % (rec["K"], rec["G"])
                 if slots else "", ms, rec["us_per_diagonal"],
                 "; " + rec["plan"] if rec["plan"] else "",
                 "" if same is None else
                 ", equal to the saved outputs" if same
                 else ", DIFFERS from the saved outputs"), flush=True)
    summary = {}
    for (what, name), r in runs.items():
        summary.setdefault(what, {})[name] = dict(
            calls=len(r), mean_ms=sum(x["ms"] for x in r) / len(r),
            sum_ms=sum(x["ms"] for x in r))
    print(json.dumps(dict(package=root, device=(
        torch.cuda.get_device_name(0) if dev.type == "cuda" else "cpu"),
        runs=summary)))
    if args.check and not all(x["same"] for r in runs.values() for x in r):
        raise SystemExit("outputs differ from those under %s" % args.check)
    return [x for r in runs.values() for x in r]


if __name__ == "__main__":
    main()
