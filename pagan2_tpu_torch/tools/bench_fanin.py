"""Bench of kernel B (the fan-in wavefront) on the calls real runs give
it: chip_smoke.py's 16 x 1535 family (bench.py's generator, seed 5)
through the CLI with default flags (7 calls, windowed and full width)
and with --full-probability (3 full-width batches), then a batch of 16
454-style K3/3 pairs of 2047 bp. Prints each call's B, D, W, G, K, ms
(CUDA events over REPS launches after one warm-up) and us per diagonal,
and last a JSON line with the mean and the sum of each run's calls.

    python -m pagan2_tpu_torch.tools.bench_fanin [--device cpu --small]
    python pagan2_tpu_torch/tools/bench_fanin.py --root DIR [--save OUT]
    python pagan2_tpu_torch/tools/bench_fanin.py --check OUT

Run as a file, --root times the pagan2_tpu_torch package of the
checkout DIR instead of this one, so that two versions of the kernel
compare on one card in one call (in turns: parent, change, change,
parent). --save writes every call's codes and snapshots under OUT;
--check holds this run's bit for bit against them.
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


def family(n, L, seed=5):
    """bench.py's progressive-family generator (bench_family_e2e): a
    random base, 10% substitutions per sequence, and a 12-bp deletion
    in every third sequence; a balanced guide tree. chip_smoke.py makes
    its families with it too."""
    import numpy as np
    rng = np.random.default_rng(seed)
    base = rng.choice(list("ACGT"), size=L)
    seqs = []
    for i in range(n):
        mut = base.copy()
        idx = rng.random(L) < 0.1
        mut[idx] = rng.choice(list("ACGT"), size=int(idx.sum()))
        s = "".join(mut)
        if i % 3 == 1:
            s = s[:L // 3] + s[L // 3 + 12:]
        seqs.append(("s%d" % i, s))

    def build(lo, hi):
        if hi - lo == 1:
            return "s%d:0.1" % lo
        mid = (lo + hi) // 2
        return "(%s,%s):0.05" % (build(lo, mid), build(mid, hi))
    return seqs, build(0, n) + ";"


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                   help="cuda (default; raises without a card) launches "
                        "kernel B; cpu runs its plain version")
    p.add_argument("--small", action="store_true",
                   help="a 4 x 200 family and 2 454 pairs (for the CPU)")
    p.add_argument("--root", default=HERE,
                   help="checkout whose pagan2_tpu_torch is timed")
    p.add_argument("--save", help="directory to write outputs to")
    p.add_argument("--check", help="directory of saved outputs to match")
    args = p.parse_args(argv)
    root = os.path.abspath(args.root)
    sys.path.insert(0, root)
    import numpy as np
    import torch
    import pagan2_tpu_torch as PT
    if os.path.dirname(os.path.dirname(os.path.abspath(PT.__file__))) \
            != root:
        raise SystemExit("pagan2_tpu_torch was imported from %s, not from "
                         "--root %s: run this tool as a file"
                         % (PT.__file__, root))
    from pagan2_tpu_torch import cli as CLI
    from pagan2_tpu_torch.align import AlignSettings
    from pagan2_tpu_torch.align import viterbi_fanin as VF
    from pagan2_tpu_torch.graph import build_leaf_graph
    from pagan2_tpu_torch.models import ModelFactory, alphabets as alph

    dev = torch.device(args.device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise SystemExit("--device cuda: torch.cuda.is_available() is "
                             "False")
        print("device: %s; package %s" % (torch.cuda.get_device_name(0),
                                          root), flush=True)
    else:
        print("device: cpu (plain version; times by the host clock, not "
              "device times); package %s" % root, flush=True)

    # the calls of the two CLI runs, recorded in the wrapper's place
    calls = []
    real = VF.fanin_fill

    def record(**kw):
        calls.append((tag[0], kw))
        return real(**kw)
    n, L = (4, 200) if args.small else (16, 1535)
    work = os.path.join(HERE, "build", "bench_fanin")
    os.makedirs(work, exist_ok=True)
    seqs, tree = family(n, L)
    fas, nh = os.path.join(work, "family.fas"), os.path.join(work, "tree.nh")
    with open(fas, "w") as f:
        f.writelines(">%s\n%s\n" % s for s in seqs)
    with open(nh, "w") as f:
        f.write(tree + "\n")
    tag = [None]
    VF.fanin_fill = record
    try:
        for tag[0], extra in (("main", []),
                              ("fullprob", ["--full-probability"])):
            rc = CLI.main(["-s", fas, "-t", nh, "-o",
                           os.path.join(work, "out"), "--silent",
                           "--device", args.device] + extra)
            if rc:
                raise SystemExit("the CLI returned %d" % rc)
    finally:
        VF.fanin_fill = real
    model = ModelFactory(alph.DNA).alignment_model(0.2)
    rng = np.random.default_rng(11)
    B, N = (2, 100) if args.small else (16, 2047)
    inps = []
    for _ in range(B):
        base = rng.choice(list("ACGT"), size=N)
        base[N // 3:N // 3 + 6] = "A"
        base[2 * N // 3:2 * N // 3 + 5] = "T"
        mut = base.copy()
        idx = rng.random(N) < 0.1
        mut[idx] = rng.choice(list("ACGT"), size=int(idx.sum()))
        inps.append(VF.prepare_fanin(
            build_leaf_graph("".join(base), alph.DNA, mode454=True),
            build_leaf_graph("".join(mut), alph.DNA, mode454=True),
            model, AlignSettings(), np.float32))
    calls.append(("454", VF.fanin_batch_args(inps, dev)))

    runs = {}
    for k, (what, kw) in enumerate(calls):
        bp, snap = VF.fanin_fill(**kw)
        if dev.type == "cuda":
            torch.cuda.synchronize()
        same = None
        path = "call%d.pt" % k
        if args.save:
            os.makedirs(args.save, exist_ok=True)
            torch.save((bp.cpu(), snap.cpu()),
                       os.path.join(args.save, path))
        if args.check:
            rb, rs = torch.load(os.path.join(args.check, path))
            same = bool(torch.equal(bp.cpu(), rb)) and bool(torch.equal(
                snap.cpu().view(torch.int32), rs.view(torch.int32)))
        if dev.type == "cpu":
            t = time.perf_counter()
            VF.fanin_fill(**kw)
            ms = 1e3 * (time.perf_counter() - t)
        else:
            t0 = torch.cuda.Event(enable_timing=True)
            t1 = torch.cuda.Event(enable_timing=True)
            t0.record()
            for _ in range(REPS):
                VF.fanin_fill(**kw)
            t1.record()
            torch.cuda.synchronize()
            ms = t0.elapsed_time(t1) / REPS
        nb, D = kw["ilo"].shape
        rec = dict(run=what, B=nb, D=D, W=kw["W"], G=kw["G"],
                   K="%d/%d" % (kw["loff"].shape[2], kw["roff"].shape[2]),
                   ms=ms, us_per_diagonal=1e3 * ms / D, same=same)
        runs.setdefault(what, []).append(rec)
        print("%-8s B %2d, D %d, W %4d, G %2d, K %s: %9.4f ms, %.4f us per "
              "diagonal%s" % (what, nb, D, kw["W"], kw["G"], rec["K"], ms,
                              rec["us_per_diagonal"],
                              "" if same is None else
                              ", equal to the saved outputs" if same
                              else ", DIFFERS from the saved outputs"),
              flush=True)
    summary = {what: dict(calls=len(r), mean_ms=sum(x["ms"] for x in r)
                          / len(r), sum_ms=sum(x["ms"] for x in r))
               for what, r in runs.items()}
    print(json.dumps(dict(package=root, device=(
        torch.cuda.get_device_name(0) if dev.type == "cuda" else "cpu"),
        runs=summary)))
    if args.check and not all(x["same"] for r in runs.values() for x in r):
        raise SystemExit("outputs differ from those under %s" % args.check)
    return [x for r in runs.values() for x in r]


if __name__ == "__main__":
    main()
