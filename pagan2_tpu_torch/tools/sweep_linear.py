"""Sweep of kernel A (the linear wavefront, viterbi_linear.linear_fill)
over batch, length and TD: the JAX tool's seven (B, N, TD) rows on its
pair generator (np.random.default_rng(0), 10% substitutions). TD has no
counterpart in kernel A; it only pads the diagonals to a multiple of TD,
which kernel A then runs. Prints ms per launch (CUDA events), us per
diagonal, GCUPS of aligned cells and G lane cells per second (Dpk x B x
Lp), as the JAX tool does.

    python -m pagan2_tpu_torch.tools.sweep_linear [--device cpu --small]
"""
from __future__ import annotations

from ..align import viterbi_linear as VL
from . import common

ROWS = [(16, 2047, 16), (16, 2047, 32), (16, 2047, 8), (8, 2047, 16),
        (32, 2047, 16), (16, 4095, 16), (8, 4095, 32)]
# --small: every row at B 2, the 2047 bp rows at 100 bp, the 4095 bp
# rows at 200 bp
SMALL_N = {2047: 100, 4095: 200}


def padded_args(jobs, dev, TD: int):
    """Kernel A's arguments with its diagonals 1 .. D - 1 padded to a
    multiple of TD; returns (kwargs, Dpk)."""
    D = max(int(j["iscal"][0] + j["iscal"][1]) for j in jobs) - 1
    Dpk = -(-(D - 1) // TD) * TD
    return VL.linear_batch_args(jobs, dev, D=Dpk + 1), Dpk


def run_case(kw, Dpk: int, cells, TD: int, dev):
    """Time kernel A on one padded batch (padded_args); returns the case
    dict and its printed line."""
    B, _D, Lp = kw["ms"].shape
    ms = common.time_ms(lambda: VL.linear_fill(**kw), dev)
    lanes = float(Dpk) * B * Lp
    line = common.report(
        "B=%d N=%d TD=%d" % (B, int(kw["iscal"][0, 0]) - 1, TD), dev, ms,
        Dpk, cells, "  %8.3f G lane-cells/s  Dpk %d  Lp %d"
        % (lanes / (ms * 1e-3) / 1e9, Dpk, Lp))
    return dict(B=B, TD=TD, Dpk=Dpk, Lp=Lp, ms=ms,
                us_per_diag=1e3 * ms / Dpk,
                gcups=cells / (ms * 1e-3) / 1e9,
                lane_gcups=lanes / (ms * 1e-3) / 1e9), line


def main(argv=None):
    args = common.parser(__doc__.splitlines()[0]).parse_args(argv)
    dev = common.setup(args)
    rows = [(2, SMALL_N[N], TD) for _B, N, TD in ROWS] if args.small \
        else ROWS
    # each JAX row draws its batch afresh from default_rng(0), so the
    # first B pairs of the largest batch of a length are that row's pairs
    batches = {}
    for N in sorted({N for _B, N, _TD in rows}):
        B = max(b for b, n, _TD in rows if n == N)
        inps, _cells = common.pair_jobs(B, N)
        batches[N] = inps
    results = []
    for B, N, TD in rows:
        inps = batches[N][:B]
        cells = sum(x["L"] * x["R"] for x in inps)
        kw, Dpk = padded_args(common.job_arrays(inps), dev, TD)
        res, line = run_case(kw, Dpk, cells, TD, dev)
        print(line, flush=True)
        results.append(dict(res, N=N))
    return results


if __name__ == "__main__":
    main()
