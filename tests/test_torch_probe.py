"""Kernel F's probe entry point (pagan2_tpu_torch.align.viterbi_linear_probe)
against the JAX package's probe tool (tools/_probe_pallas.py), and the
port's measuring tools on the CPU.

The probe's plain version is held bit-equal (tolerance 0: the step only
adds and takes maxima) to the JAX kernel run in interpret mode on the
same seven arrays, for each of the tool's seven flag sets: codes at
every lane and row (under nobp the JAX kernel leaves them undefined, so
only the corner rows compare), corner rows fM, fX, fY. Its base case is
held to kernel A's plain version on the same jobs."""
import functools
import importlib.util
import os

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from pagan2_tpu.align import AlignSettings
from pagan2_tpu.align import viterbi_pallas as vp
from pagan2_tpu.align.viterbi_sheared import prepare_sheared, _bucket
from pagan2_tpu.graph import build_leaf_graph
from pagan2_tpu.models import ModelFactory, alphabets as alph

from pagan2_tpu_torch.align import viterbi_linear as tl
from pagan2_tpu_torch.align import viterbi_linear_probe as VP
from pagan2_tpu_torch.align.parity import probe_inputs_from_reference
from pagan2_tpu_torch.tools import (bench_linear, bisect_linear,
                                    probe_linear, sweep_linear)
from pagan2_tpu_torch.tools.common import pair_jobs, job_arrays

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def load_tool(name, monkeypatch):
    """A JAX tool of tools/ (no package) loaded by path, its
    pallas_call put in interpret mode."""
    spec = importlib.util.spec_from_file_location(
        name, os.path.join(ROOT, "tools", name + ".py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    monkeypatch.setattr(mod.pl, "pallas_call",
                        functools.partial(mod.pl.pallas_call,
                                          interpret=True))
    return mod


def _bits(t):
    return torch.from_numpy(np.array(t, np.float32)).view(torch.int32)


def _reference_probe_args(TD=16):
    """Two pairs of 60 and 100 bp (10% substitutions, a 4-site deletion)
    through the JAX prep; the 7 arrays the probe kernel takes."""
    rng = np.random.default_rng(3)
    model = ModelFactory(alph.DNA).alignment_model(0.2)
    inps = []
    for n in (60, 100):
        base = rng.choice(list("ACGT"), size=n)
        mut = base.copy()
        idx = rng.random(n) < 0.1
        mut[idx] = rng.choice(list("ACGT"), size=int(idx.sum()))
        mut = np.concatenate([mut[:n // 2], mut[n // 2 + 4:]])
        inps.append(vp._add_scalar_params(prepare_sheared(
            build_leaf_graph("".join(base), alph.DNA),
            build_leaf_graph("".join(mut), alph.DNA), model,
            AlignSettings(), np.float32)))
    Lp = vp._lane_bucket(max(x["L"] for x in inps))
    Rp = _bucket(max(x["R"] for x in inps))
    jobs = [vp.pallas_job_arrays(x, Lp, Rp) for x in inps]
    fscal, iscal, gexti, ol, vlox, vloy, vhi, ms = vp.pallas_batch_args(
        jobs, Lp, Rp, TD)
    return (fscal, iscal, gexti, ol, jnp.minimum(vlox, vloy), vhi, ms)


@pytest.mark.parametrize("opts", [(), ("nobp",), ("noms",), ("nomask",),
                                  ("nocorner",), ("nobp", "noms"),
                                  ("nobp", "noms", "nomask", "nocorner")],
                         ids=lambda o: "+".join(o) or "base")
def test_probe_plain_matches_pallas_interpret(opts, monkeypatch):
    mod = load_tool("_probe_pallas", monkeypatch)
    arrays = _reference_probe_args()
    assert arrays[-1].shape[1:] == (2, 128)
    ref = mod.probe_fill(*arrays, TD=16, optk=tuple(opts))
    kw = probe_inputs_from_reference(arrays)
    n0 = VP.PLAIN_CALLS["probe:" + VP.probe_variant(opts)]
    out = VP.probe_fill(**kw, TD=16, opts=opts)
    assert VP.PLAIN_CALLS["probe:" + VP.probe_variant(opts)] == n0 + 1
    if "nobp" in opts:
        assert not out[0].any()
    else:
        ref_bp = torch.from_numpy(np.array(ref[0]))
        assert ref_bp.dtype == torch.int8
        assert torch.equal(out[0], ref_bp)
    for o, r in zip(out[1:], ref[1:]):
        assert torch.equal(o.view(torch.int32), _bits(r))
    if "nocorner" not in opts:
        # the corner diagonal was reached: each job's last cell is finite
        L = [int(c) - int(r) + 2 for r, c in np.asarray(arrays[1])[:, :2]]
        assert all(torch.isfinite(out[1][b, L[b] - 1]) for b in range(2))


def test_probe_base_matches_kernel_a_plain():
    """The probe's base case and kernel A's plain version on the same
    jobs: codes equal at every cell of diagonals 1 .. D - 1 but the x/m
    bits of row 0 (the probe rolls them in from row Lp - 1; kernel A
    has none), the corner cell's M, X, Y equal to kernel A's corner."""
    inps, _cells = pair_jobs(3, 90)
    jobs = job_arrays(inps)
    kw = VP.probe_args(jobs, "cpu", TD=16)
    bp, fM, fX, fY = VP.probe_fill(**kw, TD=16)
    codes, corner = tl.linear_fill(**tl.linear_batch_args(jobs, "cpu"))
    D = codes.shape[1]
    a = codes[:, 1:].transpose(0, 1).to(torch.int16)      # row r = d - 1
    p = bp[:D - 1].to(torch.int16)
    assert kw["ms"].shape[0] >= D - 1
    a[:, :, 0] &= 0x30
    p[:, :, 0] &= 0x30
    assert torch.equal(a, p)
    for b, x in enumerate(inps):
        got = torch.stack([fM[b, x["L"] - 1], fX[b, x["L"] - 1],
                           fY[b, x["L"] - 1]])
        assert torch.equal(got.view(torch.int32),
                           corner[b].view(torch.int32))
        assert torch.isfinite(got).all()


def test_probe_args_pad_to_td():
    inps, _cells = pair_jobs(2, 50)
    jobs = job_arrays(inps)
    for TD in (8, 16, 64):
        kw = VP.probe_args(jobs, "cpu", TD)
        Dpk, B, Lp = kw["ms"].shape
        assert (B, Lp) == (2, 64) and Dpk % TD == 0
        assert Dpk - TD < 2 * 51 - 2 <= Dpk
        R = kw["iscal"][:, 0]
        assert torch.equal(kw["iscal"][:, 1], R + 51 - 2)
        assert torch.equal(kw["vlo"], torch.minimum(
            *(torch.from_numpy(np.stack([j[k] for j in jobs]))
              for k in ("vlox", "vloy"))))


def test_probe_and_bisect_reject_what_they_do_not_run():
    inps, _cells = pair_jobs(1, 30)
    kw = VP.probe_args(job_arrays(inps), "cpu", TD=16)
    with pytest.raises(ValueError, match="not a multiple"):
        VP.probe_fill(**kw, TD=48)
    with pytest.raises(ValueError, match="not one of the tool's cases"):
        VP.probe_fill(**kw, opts=("nomask", "nocorner"))
    with pytest.raises(ValueError, match="unknown probe options"):
        VP.probe_fill(**kw, opts=("noroll",))
    with pytest.raises(ValueError, match="not one of the tool's runs"):
        VP.bisect_fill(**kw, variant="noroll,nomask")
    with pytest.raises(TypeError, match="vlo must be"):
        VP.probe_fill(**dict(kw, vlo=kw["vlo"].float()))
    assert VP.bisect_variant("") == "full"
    assert VP.bisect_variant("nomask,nobp,noroll") == "nobp,noroll,nomask"
    assert set(VP.LAUNCHES) == {"probe:" + v for v in VP.PROBE_VARIANTS} | \
        {"bisect:" + v for v in VP.BISECT_VARIANTS}


@pytest.mark.parametrize("tool,count", [(probe_linear, 10),
                                        (bisect_linear, 9),
                                        (sweep_linear, 7),
                                        (bench_linear, 1)],
                         ids=lambda t: getattr(t, "__name__", str(t)))
def test_tool_runs_on_cpu(tool, count, capsys):
    plain0 = sum(VP.PLAIN_CALLS.values())
    a0 = tl.PLAIN_CALLS
    res = tool.main(["--device", "cpu", "--small"])
    out = capsys.readouterr().out
    assert len(res) == count
    assert "device: cpu" in out
    lines = [ln for ln in out.splitlines() if "us/diag" in ln]
    assert len(lines) == count
    for r in res:
        assert r["ms"] > 0 and r["Dpk"] > 0
    if tool in (probe_linear, bisect_linear):
        assert sum(VP.PLAIN_CALLS.values()) > plain0
        for r in res:
            assert r["bound_by"] in ("bytes", "operations")
            assert r["bound_ms"] > 0
    else:
        assert tl.PLAIN_CALLS > a0


def test_tools_default_to_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="torch.cuda.is_available"):
        probe_linear.main(["--small"])
