"""Bisection of the linear wavefront step's cost (kernel F, bisect entry
point) on random inputs: what dominates a step, the neighbour read, the
code store or the masks?

The JAX tool's nine runs (B x Lp x Dpk):
  full, nobp, noroll, nomask, nobp,noroll, nobp,noroll,nomask
                 at 8 x 1024 x 2048
  full           at 8 x 1024 x 2048 with TD 64 (TD only divides Dpk)
  full           at 32 x 256 x 2048 and at 8 x 4096 x 8192 (the top of the
                 shared-memory path)
Switches: nobp stores a 0 byte per cell instead of the code; noroll
takes the X and M candidates from row i, not i - 1; nomask drops the
validity masks and the gj / orp selects. Inputs are standard normal
draws of np.random.default_rng(0) in the JAX tool's order (fscal, ms,
gexti, ol), iscal = Lp - 1, vlo 0, vhi Lp; GCUPS here counts lane cells
Dpk x B x Lp, as the JAX tool does.

    python -m pagan2_tpu_torch.tools.bisect_linear [--device cpu --small]
"""
from __future__ import annotations

import numpy as np
import torch

from ..align import viterbi_linear_probe as VP
from . import common

VARIANTS = ["", "nobp", "noroll", "nomask", "nobp,noroll",
            "nobp,noroll,nomask"]


def runs(small: bool):
    """(variant, B, Lp, Dpk, TD) of the JAX tool's runs; --small cuts
    every shape to B 2, Lp 128, Dpk 256."""
    full = [(v, 8, 1024, 2048, 16) for v in VARIANTS] + [
        ("", 8, 1024, 2048, 64), ("", 32, 256, 2048, 16),
        ("", 8, 4096, 8192, 16)]
    if small:
        return [(v, 2, 128, 256, TD) for v, _B, _L, _D, TD in full]
    return full


def bisect_inputs(B: int, Lp: int, Dpk: int, device, seed: int = 0):
    """The JAX tool's inputs, drawn in its order, as bisect_fill's
    keyword arguments on `device`."""
    rng = np.random.default_rng(seed)
    fscal = rng.standard_normal((B, 8)).astype(np.float32)
    ms = rng.standard_normal((Dpk, B, Lp)).astype(np.float32)
    gexti = rng.standard_normal((B, Lp)).astype(np.float32)
    ol = rng.standard_normal((B, Lp)).astype(np.float32)
    kw = dict(fscal=fscal, iscal=np.full((B, 8), Lp - 1, np.int32),
              gexti=gexti, ol=ol, vlo=np.zeros((B, Lp), np.int32),
              vhi=np.full((B, Lp), Lp, np.int32), ms=ms)
    return {k: torch.from_numpy(v).to(device) for k, v in kw.items()}


def main(argv=None):
    args = common.parser(__doc__.splitlines()[0]).parse_args(argv)
    dev = common.setup(args)
    inputs = {}
    results = []
    for variant, B, Lp, Dpk, TD in runs(args.small):
        if (B, Lp, Dpk) not in inputs:
            inputs = {(B, Lp, Dpk): bisect_inputs(B, Lp, Dpk, dev)}
        kw = inputs[(B, Lp, Dpk)]
        name = VP.bisect_variant(variant)
        ms = common.time_ms(
            lambda: VP.bisect_fill(**kw, variant=variant, TD=TD), dev)
        bound, by = common.step_bound(
            kw, ms_read=True, codes="nobp" not in name, corner=True,
            masks="nomask" not in name, store=True)
        lanes = float(Dpk) * B * Lp
        print(common.report(name, dev, ms, Dpk, lanes,
                            "  B %d Lp %d Dpk %d TD %d  bound %.5f ms (%s)"
                            % (B, Lp, Dpk, TD, bound, by)), flush=True)
        results.append(dict(case=name, variant=name, B=B, Lp=Lp, Dpk=Dpk,
                            TD=TD, ms=ms, us_per_diag=1e3 * ms / Dpk,
                            gcups=lanes / (ms * 1e-3) / 1e9,
                            bound_ms=bound, bound_by=by))
    return results


if __name__ == "__main__":
    main()
