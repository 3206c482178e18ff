"""Bench of kernel B (the fan-in wavefront) on the calls real runs give
it: chip_smoke.py's 16 x 1535 family (bench.py's generator, seed 5)
through the CLI with default flags (7 calls, windowed and full width)
and with --full-probability (3 full-width batches), then a batch of 16
454-style K3/3 pairs of 2047 bp, then the pileup's calls: pileup_path's
40 x 384 amplicon reads (tools/reads.py's amplicon_reads, default_rng(3))
through the CLI with --pileup --homopolymer --output-consensus (39
calls, all past the 4 x 4 templates: the group build) and with --pileup
--454 (39 calls, most of them past the templates). Prints each call's
B, D, W, G, K, launch plan, ms (CUDA events over REPS launches after one
warm-up) and us per diagonal, and last a JSON line with the mean and
the sum of each run's calls.

    python -m pagan2_tpu_torch.tools.bench_fanin [--device cpu --small]
    python pagan2_tpu_torch/tools/bench_fanin.py --root DIR [--save OUT]
    python pagan2_tpu_torch/tools/bench_fanin.py --check OUT
    python -m pagan2_tpu_torch.tools.bench_fanin --groups 1,2,4,8,16,32

Run as a file, --root times the pagan2_tpu_torch package of the
checkout DIR instead of this one, so that two versions of the kernel
compare on one card in one call (in turns: parent, change, change,
parent; a package without launch plans prints none). --save writes a
digest of every call's codes and snapshots under OUT; --check holds
this run's bit for bit against them (tools/replay.py).

--groups S,... (a card, this checkout) then launches the group build at
each group size S (lanes a window position) on every call whose plan is
the group build, holds each bit for bit against the plan's own build
and times it; a JSON line gives each run's sum and us per diagonal by
group size.
"""
from __future__ import annotations

import json

if __package__:
    from . import replay
else:           # run as a file: this directory is sys.path[0]
    import replay


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


# the pileup runs: (run, the CLI flags besides --pileup)
PILEUP_RUNS = (("pileup", ("--homopolymer", "--output-consensus")),
               ("pileup454", ("--454",)))


def plan_text(VF, kw):
    """A call's launch plan as text ("" for a package without
    call_plan)."""
    if not hasattr(VF, "call_plan"):
        return ""
    p = VF.call_plan(kw)
    if p["build"] == "templated":
        return "templated %dx%d, ring %s, %d threads x %d rows" % (
            p["KL"], p["KR"], p["placement"], p["threads"], p["rows"])
    return ("group build, %d lanes a group, ring %s, tables %s, %d "
            "threads x %d rows" % (p["group"], p["placement"], p["tables"],
                                   p["threads"], p["rows"]))


def group_sizes(text):
    """--groups: "S,S,..." as [lanes]."""
    return [int(v) for v in text.split(",") if v]


def sweep_groups(args, torch, VF, calls):
    """--groups: each call of the group build with each group size of
    args.groups, held bit for bit against the plan's build and timed.
    Returns the records; exits non-zero if one differs."""
    recs = []
    for k, (run, kw) in enumerate(calls):
        if VF.call_plan(kw)["build"] != "groups":
            continue
        ref = replay.digest(VF.fanin_fill(**kw))
        D = kw["ilo"].shape[1]
        for S in args.groups:
            plan = VF.call_plan(kw, group=S)

            def forced(**a):
                return VF.launch_fanin(plan, **a)
            same = replay.digest(forced(**kw)) == ref
            ms = replay.time_call(torch, forced, kw, replay.REPS)
            recs.append(dict(run=run, call=k, group=S, D=D, ms=ms,
                             same=same))
            print("groups   %-9s call %2d, S %2d (%d threads x %d rows): "
                  "%9.4f ms, %.4f us per diagonal%s"
                  % (run, k, S, plan["threads"], plan["rows"], ms,
                     1e3 * ms / D, "" if same else ", DIFFERS from the "
                     "plan's build"), flush=True)
    summary = {}
    for r in recs:
        node = summary.setdefault(r["run"], {}).setdefault(
            str(r["group"]), dict(calls=0, sum_ms=0.0, diagonals=0))
        node["calls"] += 1
        node["sum_ms"] += r["ms"]
        node["diagonals"] += r["D"]
    for by_group in summary.values():
        for node in by_group.values():
            node["us_per_diagonal"] = 1e3 * node["sum_ms"] / node["diagonals"]
    print(json.dumps(dict(groups=summary)))
    if not all(r["same"] for r in recs):
        raise SystemExit("a forced group size differs from the plan's build")
    return recs


def main(argv=None):
    p = replay.parser(
        __doc__.splitlines()[0], "kernel B",
        "a 4 x 200 family, 2 454 pairs and 6 x 96 reads (for the CPU)")
    p.add_argument("--groups", type=group_sizes, default=[],
                   help="also force the group build at each of these "
                        "lanes a group (a card only)")
    args = p.parse_args(argv)
    if args.groups and args.device != "cuda":
        raise SystemExit("--groups launches kernel B's group build: a card "
                         "only")
    torch, dev, root = replay.start(args)
    import numpy as np
    from pagan2_tpu_torch import cli as CLI
    from pagan2_tpu_torch.align import AlignSettings
    from pagan2_tpu_torch.align import viterbi_fanin as VF
    from pagan2_tpu_torch.graph import build_leaf_graph
    from pagan2_tpu_torch.models import ModelFactory, alphabets as alph
    from pagan2_tpu_torch.tools.reads import amplicon_reads

    seqs, tree = family(*((4, 200) if args.small else (16, 1535)))
    calls = [(run, kw) for run, flags in (("main", ()), (
        "fullprob", ("--full-probability",))) for _n, kw in replay.record_cli(
            CLI, VF, ("fanin_fill",), seqs, tree, "bench_fanin", args.device,
            flags)]
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
    reads = amplicon_reads(*((6, 96, 110) if args.small else (40, 384, 420)))
    for run, flags in PILEUP_RUNS:
        calls += [(run, kw) for _n, kw in replay.record_cli(
            CLI, VF, ("fanin_fill",), reads, None, "bench_fanin",
            args.device, ("--pileup",) + flags)]

    runs = []
    for k, kw, ms, same in replay.replay(
            args, torch, dev, "fanin",
            [(VF.fanin_fill, kw, replay.REPS) for _w, kw in calls]):
        nb, D = kw["ilo"].shape
        rec = dict(run=calls[k][0], B=nb, D=D, W=kw["W"], G=kw["G"],
                   K="%d/%d" % (kw["loff"].shape[2], kw["roff"].shape[2]),
                   plan=plan_text(VF, kw), ms=ms,
                   us_per_diagonal=1e3 * ms / D, same=same)
        runs.append(rec)
        print("%-9s B %2d, D %d, W %4d, G %2d, K %s: %9.4f ms, %.4f us per "
              "diagonal%s%s" % (rec["run"], nb, D, kw["W"], kw["G"],
                                rec["K"], ms, rec["us_per_diagonal"],
                                "; " + rec["plan"] if rec["plan"] else "",
                                replay.same_text(same)), flush=True)
    if args.groups:
        sweep_groups(args, torch, VF, calls)
    return replay.finish(args, torch, dev, root, runs, ("run",))


if __name__ == "__main__":
    main()
