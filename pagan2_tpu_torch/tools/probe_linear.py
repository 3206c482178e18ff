"""Ablation probe of the linear wavefront step (kernel F, probe entry
point): where does a diagonal's time go?

The JAX tool's ten cases on its batch (B = 16 pairs of 2047 bp, 10%
substitutions, np.random.default_rng(0), alignment_model(0.2)):
  base TD=16     every part on; bit-equal to kernel A where both define
                 a code
  TD=32, TD=64, TD=8
                 the same step; TD only pads the diagonals to a multiple
                 of TD (the JAX tool's VMEM limits have no counterpart)
  nobp           no code computed or stored (the code store's cost)
  noms           no match-score read (the 4 B/cell read's cost)
  nomask         no validity masks (the mask arithmetic's cost)
  nocorner       no capture of the corner diagonal
  nobp+noms      neither
  all-off        all four off: the barrier and the recurrence chain

    python -m pagan2_tpu_torch.tools.probe_linear [--device cpu --small]
"""
from __future__ import annotations

from ..align import viterbi_linear_probe as VP
from . import common

CASES = [
    ("base TD=16", 16, ()),
    ("TD=32", 32, ()),
    ("TD=64", 64, ()),
    ("TD=8", 8, ()),
    ("nobp", 16, ("nobp",)),
    ("noms", 16, ("noms",)),
    ("nomask", 16, ("nomask",)),
    ("nocorner", 16, ("nocorner",)),
    ("nobp+noms", 16, ("nobp", "noms")),
    ("all-off", 16, ("nobp", "noms", "nomask", "nocorner")),
]


def main(argv=None):
    args = common.parser(__doc__.splitlines()[0]).parse_args(argv)
    dev = common.setup(args)
    B, N = (2, 100) if args.small else (16, 2047)
    inps, cells = common.pair_jobs(B, N)
    jobs = common.job_arrays(inps)
    print("probe: B %d pairs of %d bp, Lp %d, %d aligned cells"
          % (B, N, len(jobs[0]["gexti"]), cells), flush=True)
    built = {}
    results = []
    for name, TD, opts in CASES:
        if TD not in built:
            built[TD] = VP.probe_args(jobs, dev, TD)
        kw = built[TD]
        Dpk = kw["ms"].shape[0]
        ms = common.time_ms(lambda: VP.probe_fill(**kw, TD=TD, opts=opts),
                            dev)
        bound, by = common.step_bound(
            kw, ms_read="noms" not in opts, codes="nobp" not in opts,
            corner="nocorner" not in opts, masks="nomask" not in opts)
        print(common.report(name, dev, ms, Dpk, cells,
                            "  Dpk %d  bound %.5f ms (%s)"
                            % (Dpk, bound, by)), flush=True)
        results.append(dict(case=name, variant=VP.probe_variant(opts),
                            TD=TD, B=B, N=N, Lp=kw["ms"].shape[2],
                            Dpk=Dpk, ms=ms,
                            us_per_diag=1e3 * ms / Dpk,
                            gcups=cells / (ms * 1e-3) / 1e9,
                            bound_ms=bound, bound_by=by))
    return results


if __name__ == "__main__":
    main()
