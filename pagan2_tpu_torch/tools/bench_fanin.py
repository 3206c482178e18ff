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
parent). --save writes a digest of every call's codes and snapshots
under OUT; --check holds this run's bit for bit against them
(tools/replay.py).
"""
from __future__ import annotations

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


def main(argv=None):
    args = replay.parser(
        __doc__.splitlines()[0], "kernel B",
        "a 4 x 200 family and 2 454 pairs (for the CPU)").parse_args(argv)
    torch, dev, root = replay.start(args)
    import numpy as np
    from pagan2_tpu_torch import cli as CLI
    from pagan2_tpu_torch.align import AlignSettings
    from pagan2_tpu_torch.align import viterbi_fanin as VF
    from pagan2_tpu_torch.graph import build_leaf_graph
    from pagan2_tpu_torch.models import ModelFactory, alphabets as alph

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

    runs = []
    for k, kw, ms, same in replay.replay(
            args, torch, dev, "fanin",
            [(VF.fanin_fill, kw, replay.REPS) for _w, kw in calls]):
        nb, D = kw["ilo"].shape
        rec = dict(run=calls[k][0], B=nb, D=D, W=kw["W"], G=kw["G"],
                   K="%d/%d" % (kw["loff"].shape[2], kw["roff"].shape[2]),
                   ms=ms, us_per_diagonal=1e3 * ms / D, same=same)
        runs.append(rec)
        print("%-8s B %2d, D %d, W %4d, G %2d, K %s: %9.4f ms, %.4f us per "
              "diagonal%s" % (rec["run"], nb, D, kw["W"], kw["G"], rec["K"],
                              ms, rec["us_per_diagonal"],
                              replay.same_text(same)), flush=True)
    return replay.finish(args, torch, dev, root, runs, ("run",))


if __name__ == "__main__":
    main()
