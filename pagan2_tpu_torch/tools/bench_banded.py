"""Bench of kernel C (the windowed banded Viterbi wavefront) on the calls
real runs give it: bench.py's megabase pair (1,048,575 bp, 1%
substitutions, np.random.default_rng(0), tree (a:0.1,b:0.1);) and the
4 x 4,000 long family (bench.py's family generator, seed 5) through the
CLI with default flags, then the band shapes of chip_smoke.py's
kernel_banded phase and a whole band on each stripe width of WIDE_WK.
Prints each call's source, Wk, w.max(), D - 1 (the diagonals filled),
kernel C's launch plan, ms (CUDA events over REPS launches after one
warm-up; MEGABASE_REPS for the megabase call) and us per diagonal, and
last a JSON line with the mean and the sum of each source's calls.

    python -m pagan2_tpu_torch.tools.bench_banded [--device cpu --small]
    python pagan2_tpu_torch/tools/bench_banded.py --root DIR [--save OUT]
    python pagan2_tpu_torch/tools/bench_banded.py --check OUT

Run as a file, --root times the pagan2_tpu_torch package of the
checkout DIR instead of this one, so that two versions of the kernel
compare on one card in one call (in turns: parent, change, change,
parent). --save writes a digest of every call's codes and corner under
OUT; --check holds this run's bit for bit against them
(tools/replay.py). --small (for the CPU) takes a 3,500 bp pair of the
megabase generator and the band shapes at a few hundred bp, and no long
family.
"""
from __future__ import annotations

import time

if __package__:
    from . import replay
    from .bench_fanin import family
else:           # run as a file: this directory is sys.path[0]
    import replay
    from bench_fanin import family

MEGABASE_REPS = 2
MEGABASE_BP = 1048575
# the stripe widths of the wide shapes: the window kernel's builds past
# the recorded calls' 128-512 columns
WIDE_WK = (640, 768, 896, 1024, 1280)


def megabase(n=MEGABASE_BP, seed=0):
    """bench.py's megabase pair (bench_megabase, bench.py:289-341): a
    random base of n bp and a copy with 1% substitutions, drawn from
    np.random.default_rng(seed) alone; the two-leaf tree. chip_smoke.py
    makes its megabase pair with it too."""
    import numpy as np
    rng = np.random.default_rng(seed)
    base = rng.choice(list("ACGT"), size=n)
    mut = base.copy()
    idx = rng.random(n) < 0.01
    mut[idx] = rng.choice(list("ACGT"), size=int(idx.sum()))
    return [("a", "".join(base)), ("b", "".join(mut))], "(a:0.1,b:0.1);"


def band_shapes(small=False, rng=None):
    """The band shapes of chip_smoke.py's kernel_banded phase, each a
    dict: name, the two sequences, the right one's quality string,
    pair_end (the pair-end settings), band (None: planned from anchors;
    else a function of (L, R) giving the tunnel's upper and lower
    bounds) and dead_end (no finite corner score expected). With
    `small`, the same shapes at a few hundred bp. The random sequences
    come from `rng` (default: np.random.default_rng(11)), drawn in the
    order chip_smoke.py has drawn them since its first five shapes, the
    wide window from np.random.default_rng(12)."""
    import numpy as np
    if rng is None:
        rng = np.random.default_rng(11)

    def rand(n, g=rng):
        return "".join(g.choice(list("ACGT"), n))

    def mutate(s, p=0.1, g=rng):
        mut = np.array(list(s))
        idx = g.random(len(s)) < p
        mut[idx] = g.choice(list("ACGT"), size=int(idx.sum()))
        return "".join(mut)

    def whole(L, R):
        return np.zeros(L, np.int64), np.full(L, R - 1)

    def shape(name, s1, s2, band=None, qual="", pair_end=False,
              dead_end=False):
        return dict(name=name, s1=s1, s2=s2, band=band, qual=qual,
                    pair_end=pair_end, dead_end=dead_end)
    # an anchored pair: 5% substitutions and a 12-bp deletion
    n = 520 if small else 3500
    rng1 = np.random.default_rng(1)
    base = rng1.choice(list("ACGT"), size=n)
    mut = base.copy()
    idx = rng1.random(n) < 0.05
    mut[idx] = rng1.choice(list("ACGT"), size=int(idx.sum()))
    a, b = "".join(base), "".join(mut)
    seqs4, _tree = family(4, 400 if small else 4000)
    r1, r2, mid = (rand(k) for k in ((25, 25, 40) if small
                                     else (200, 200, 300)))
    dead = rand(80 if small else 800)
    glob = rand(150 if small else 5400)
    glob2 = mutate(glob)
    rng_w = np.random.default_rng(12)
    wide = rand(300 if small else 1100, rng_w)
    return [
        shape("%d bp anchored" % n, a, b[:n // 2] + b[n // 2 + 12:]),
        shape("10% subs", seqs4[0][1], seqs4[1][1]),
        shape("pair-end breaks", r1 + mid + r2, r1 + "0" + r2, whole,
              qual="I" * (len(r1) + len(r2) + 1), pair_end=True),
        shape("dead end", dead, "ACGT" * 5 + dead,
              lambda L, R: (np.zeros(L, np.int64), np.full(L, 3, np.int64)),
              dead_end=True),
        shape("wide window", wide, mutate(wide, g=rng_w), whole),
        shape("global ring", glob, glob2, whole),
    ]


def wide_shapes(small=False):
    """A shape of a whole band on each stripe width of WIDE_WK (256 and
    384 with `small`): a pair of Wk - 64 bp, the second with 10% of its
    sites redrawn, from np.random.default_rng(13)."""
    import numpy as np
    rng = np.random.default_rng(13)
    shapes = []
    for Wk in (256, 384) if small else WIDE_WK:
        base = rng.choice(list("ACGT"), size=Wk - 64)
        mut = base.copy()
        idx = rng.random(len(base)) < 0.1
        mut[idx] = rng.choice(list("ACGT"), size=int(idx.sum()))
        shapes.append(dict(
            name="Wk %d whole band" % Wk, s1="".join(base), s2="".join(mut),
            band=lambda L, R: (np.zeros(L, np.int64), np.full(L, R - 1)),
            qual="", pair_end=False, dead_end=False))
    return shapes


def shape_args(shape, model, dev):
    """banded_args of one band shape on `dev`: (kwargs, meta)."""
    from dataclasses import replace
    from pagan2_tpu_torch.align import AlignSettings, plan_band
    from pagan2_tpu_torch.align import viterbi_banded as VB
    from pagan2_tpu_torch.align.oracle import mark_no_gap_penalty_sites
    from pagan2_tpu_torch.graph import build_leaf_graph
    from pagan2_tpu_torch.models import alphabets as alph
    g1 = build_leaf_graph(shape["s1"], alph.DNA)
    g2 = build_leaf_graph(shape["s2"], alph.DNA, quality=shape["qual"])
    s = AlignSettings()
    if shape["pair_end"]:
        s = replace(s, pair_end_reads=True,
                    x_read1_length=mark_no_gap_penalty_sites(g1),
                    y_read1_length=mark_no_gap_penalty_sites(g2))
    L, R = g1.num_sites() - 1, g2.num_sites() - 1
    band = (plan_band(g1, g2, s)[0] if shape["band"] is None
            else shape["band"](L, R))
    return VB.banded_args(g1, g2, model, s, band[0], band[1], dev)


def plan_text(VB, kw):
    """Kernel C's launch plan of one call as text ("" for a package
    without plans); chip_smoke.py prints it too."""
    if not hasattr(VB, "banded_plan"):
        return ""
    p = VB.banded_plan(kw["ms"].shape[1])
    return "%s, %d threads x %d rows, %d diagonals staged" % (
        p["build"], p["threads"], p["rows_a_thread"], p["stage"])


def main(argv=None):
    args = replay.parser(
        __doc__.splitlines()[0], "kernel C",
        "a 3,500 bp pair and small band shapes (for the CPU)").parse_args(
            argv)
    torch, dev, root = replay.start(args)
    from pagan2_tpu_torch import cli as CLI
    from pagan2_tpu_torch.align import viterbi_banded as VB
    from pagan2_tpu_torch.models import ModelFactory, alphabets as alph

    def record(what, seqs, tree):
        return [(what, kw) for _n, kw in replay.record_cli(
            CLI, VB, ("banded_fill",), seqs, tree, "bench_banded",
            args.device)]
    model = ModelFactory(alph.DNA).alignment_model(0.2)
    t = time.time()
    calls = record("megabase", *megabase(3500 if args.small
                                         else MEGABASE_BP))
    if not args.small:
        calls += record("long_family", *family(4, 4000))
    calls += [(s["name"], shape_args(s, model, dev)[0])
              for s in band_shapes(args.small) + wide_shapes(args.small)]
    print("recorded %d calls in %.1f s" % (len(calls), time.time() - t),
          flush=True)

    runs = []
    for k, kw, ms, same in replay.replay(
            args, torch, dev, "banded",
            [(VB.banded_fill, kw, MEGABASE_REPS if what == "megabase"
              else replay.REPS) for what, kw in calls]):
        Dn, Wk = kw["ms"].shape
        rec = dict(source=calls[k][0], Wk=Wk,
                   wmax=int(kw["sched"][:, 1].max()), Dn=Dn,
                   plan=plan_text(VB, kw), ms=ms,
                   us_per_diagonal=1e3 * ms / Dn, same=same)
        runs.append(rec)
        print("%-18s Wk %4d, w.max() %4d, D-1 %7d: %10.4f ms, %.4f us per "
              "diagonal%s%s"
              % (rec["source"], Wk, rec["wmax"], Dn, ms,
                 rec["us_per_diagonal"],
                 "; " + rec["plan"] if rec["plan"] else "",
                 replay.same_text(same)), flush=True)
    return replay.finish(args, torch, dev, root, runs, ("source",))


if __name__ == "__main__":
    main()
