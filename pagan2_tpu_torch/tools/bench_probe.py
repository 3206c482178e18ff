"""Bench of kernel F (the probe's and the bisect's ablations of the
linear step) at the measuring tools' sizes: every flag set of the probe
entry point on its 16 x 2047 batch (tools/probe_linear.py, TD 16), and
every flag set of the bisect entry point on its random inputs
(tools/bisect_linear.py) at 8 x 1024 x 2048, 32 x 256 x 2048 and
8 x 4096 x 8192 (B x Lp x Dpk). Prints each call's tool, flag set, B,
Dpk, Lp, kernel F's launch plan, ms (CUDA events over REPS launches
after one launch) and us per diagonal, and last a JSON line with each
case's ms.

    python -m pagan2_tpu_torch.tools.bench_probe [--device cpu --small]
    python pagan2_tpu_torch/tools/bench_probe.py --root DIR [--save OUT]
    python pagan2_tpu_torch/tools/bench_probe.py --check OUT

Run as a file, --root times the pagan2_tpu_torch package of the
checkout DIR instead of this one, so that two versions of the kernel
compare on one card in one call (in turns: parent, change, change,
parent). --save writes a digest of every call's outputs under OUT;
--check holds this run's bit for bit against them (tools/replay.py).
The probe's codes under nobp are undefined (nothing is stored), so
there only the corner rows are held.
"""
from __future__ import annotations

if __package__:
    from . import replay
else:           # run as a file: this directory is sys.path[0]
    import replay


def cases(small: bool):
    """(tool, shape) of the bench: the probe's (B, N) pairs and the
    bisect's (B, Lp, Dpk) inputs; --small cuts them to a probe 2 x 100
    and a bisect 2 x 128 x 256."""
    if small:
        return [("probe", (2, 100)), ("bisect", (2, 128, 256))]
    return [("probe", (16, 2047)), ("bisect", (8, 1024, 2048)),
            ("bisect", (32, 256, 2048)), ("bisect", (8, 4096, 8192))]


def plan_text(VP, Lp):
    """Kernel F's launch plan on Lp rows as text ("" for a package
    without probe_plan: the parent of the lane builds)."""
    if not hasattr(VP, "probe_plan"):
        return ""
    p = VP.probe_plan(Lp)
    if p["rows"]:
        return "%d threads x %d rows, diagonals in registers" % (
            p["threads"], p["rows"])
    return "%d threads, diagonals in global scratch (global build)" \
        % p["threads"]


def main(argv=None):
    p = replay.parser(__doc__.splitlines()[0], "kernel F",
                      "a probe 2 x 100 and a bisect 2 x 128 x 256 (for "
                      "the CPU)")
    args = p.parse_args(argv)
    torch, dev, root = replay.start(args)
    from pagan2_tpu_torch.align import viterbi_linear_probe as VP
    from pagan2_tpu_torch.tools import common
    from pagan2_tpu_torch.tools.bisect_linear import bisect_inputs

    calls = []
    for tool, shape in cases(args.small):
        if tool == "probe":
            inps, _cells = common.pair_jobs(*shape)
            kw = VP.probe_args(common.job_arrays(inps), dev, 16)
            for v in VP.PROBE_VARIANTS:
                opts = () if v == "base" else tuple(v.split("+"))

                def fill(opts=opts, **kw):
                    out = VP.probe_fill(**kw, opts=opts)
                    # under nobp the codes are undefined
                    return out[1:] if "nobp" in opts else out
                calls.append((tool, "%dx%d" % shape, v, fill, kw))
        else:
            kw = bisect_inputs(*shape, dev)
            for v in VP.BISECT_VARIANTS:
                def fill(v=v, **kw):
                    return VP.bisect_fill(**kw, variant=v)
                calls.append((tool, "x".join(map(str, shape)), v, fill, kw))

    runs = []
    for k, kw, ms, same in replay.replay(
            args, torch, dev, "probe",
            [(fill, kw, replay.REPS) for _t, _s, _v, fill, kw in calls]):
        tool, shape, variant = calls[k][:3]
        Dpk, B, Lp = kw["ms"].shape
        rec = dict(tool=tool, shape=shape, variant=variant,
                   case="%s %s %s" % (tool, shape, variant), B=B, Dpk=Dpk,
                   Lp=Lp, plan=plan_text(VP, Lp), ms=ms,
                   us_per_diagonal=1e3 * ms / Dpk, same=same)
        runs.append(rec)
        print("%-6s %-12s %-26s Dpk %d, Lp %d: %9.4f ms, %.4f us per "
              "diagonal%s%s" % (tool, shape, variant, Dpk, Lp, ms,
                                rec["us_per_diagonal"],
                                "; " + rec["plan"] if rec["plan"] else "",
                                replay.same_text(same)), flush=True)
    return replay.finish(args, torch, dev, root, runs, ("case",))


if __name__ == "__main__":
    main()
