"""Kernel F's bisect entry point (pagan2_tpu_torch.align.viterbi_linear_probe)
against the JAX package's bisect tool (tools/_bisect_pallas.py): for each
of the tool's six variants, the plain version and the JAX kernel run in
interpret mode on the tool's random inputs (np.random.default_rng(0),
drawn in its order) give the same codes and corner rows bit for bit
(tolerance 0: the step only adds and takes maxima)."""
import functools
import importlib.util
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

from pagan2_tpu_torch.align import viterbi_linear_probe as VP
from pagan2_tpu_torch.align.parity import PROBE_ARGS
from pagan2_tpu_torch.tools.bisect_linear import bisect_inputs

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
B, LP, DPK, TD = 2, 128, 256, 16


def _reference(variant, arrays):
    """make_kernel(TD, variant) in the BlockSpecs of the tool's run()
    (tools/_bisect_pallas.py:137-161), in interpret mode."""
    spec = importlib.util.spec_from_file_location(
        "_bisect_pallas", os.path.join(ROOT, "tools", "_bisect_pallas.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    f = jnp.float32
    resident = lambda shape: pl.BlockSpec(  # noqa: E731
        shape, lambda i: (0,) * len(shape), memory_space=pltpu.VMEM)
    fill = pl.pallas_call(
        mod.make_kernel(TD, variant),
        grid=(DPK // TD,),
        in_specs=[
            resident((B, 8)), resident((B, 8)),
            resident((B, LP)), resident((B, LP)),
            resident((B, LP)), resident((B, LP)),
            pl.BlockSpec((TD, B, LP), lambda i: (i, 0, 0),
                         memory_space=pltpu.VMEM),
        ],
        out_specs=[
            pl.BlockSpec((TD, B, LP), lambda i: (i, 0, 0),
                         memory_space=pltpu.VMEM),
            resident((B, LP)), resident((B, LP)), resident((B, LP)),
        ],
        out_shape=[
            jax.ShapeDtypeStruct((DPK, B, LP), jnp.int8),
            jax.ShapeDtypeStruct((B, LP), f),
            jax.ShapeDtypeStruct((B, LP), f),
            jax.ShapeDtypeStruct((B, LP), f),
        ],
        scratch_shapes=[pltpu.VMEM((6, B, LP), f)],
        interpret=True,
    )
    return jax.jit(fill)(*(jnp.asarray(a) for a in arrays))


def test_bisect_inputs_follow_the_tool():
    """The tool draws fscal, then ms, then gexti and ol."""
    fscal, iscal, gexti, ol, vlo, vhi, ms = (
        bisect_inputs(B, LP, DPK, "cpu")[k].numpy() for k in PROBE_ARGS)
    rng = np.random.default_rng(0)
    assert np.array_equal(fscal, rng.standard_normal((B, 8))
                          .astype(np.float32))
    assert np.array_equal(ms, rng.standard_normal((DPK, B, LP))
                          .astype(np.float32))
    assert np.array_equal(gexti, rng.standard_normal((B, LP))
                          .astype(np.float32))
    assert np.array_equal(ol, rng.standard_normal((B, LP))
                          .astype(np.float32))
    assert (iscal == LP - 1).all() and (vlo == 0).all() and \
        (vhi == LP).all()


@pytest.mark.parametrize("variant", ["", "nobp", "noroll", "nomask",
                                     "nobp,noroll", "nobp,noroll,nomask"],
                         ids=lambda v: v or "full")
def test_bisect_plain_matches_pallas_interpret(variant):
    kw = bisect_inputs(B, LP, DPK, "cpu")
    ref = _reference(variant, [kw[k].numpy() for k in PROBE_ARGS])
    key = "bisect:" + VP.bisect_variant(variant)
    n0 = VP.PLAIN_CALLS[key]
    out = VP.bisect_fill(**kw, variant=variant, TD=TD)
    assert VP.PLAIN_CALLS[key] == n0 + 1
    ref_bp = torch.from_numpy(np.array(ref[0]))
    assert torch.equal(out[0], ref_bp)
    assert bool(out[0].any()) == ("nobp" not in variant)
    for o, r in zip(out[1:], ref[1:]):
        assert torch.equal(o.view(torch.int32), torch.from_numpy(
            np.array(r, np.float32)).view(torch.int32))
    # the corner diagonal Lp - 1 is inside the 256 filled
    assert bool(torch.isfinite(out[1]).any())
