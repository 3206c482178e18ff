"""Parity harness: the JAX package's host-side prep dicts as the port's
kernel arguments, so both packages can be fed identical inputs.

The JAX package prepares every fill on the host in numpy
(pagan2_tpu.align.viterbi_sheared.prepare_sheared,
viterbi_fanin.prepare_fanin, viterbi_pallas.pallas_job_arrays,
viterbi_pallas_banded.pallas_banded_args,
fullprob.linear_fullprob_inputs, fullprob.fanin_fullprob_inputs), and
its measuring tools take positional arrays (tools/_probe_pallas.py's
probe_fill, tools/_bisect_pallas.py's kernels). Those hold numpy
arrays, Python scalars, or device arrays that numpy reads, so they cross
over as they are; this module never imports the JAX package.
"""
from __future__ import annotations

import numpy as np
import torch

from . import fullprob_fill as ff
from .viterbi_banded import band_sched, stripe_width
from .viterbi_fanin import fanin_batch_args
from .viterbi_linear import (_add_scalar_params, batch_rows,
                             linear_job_arrays, linear_batch_args)


def _kind(d: dict) -> str:
    if "msp_sh" in d and "wr_rext" in d:
        return "linear_fullprob"
    if "msp_sh" in d and "seed_block" in d:
        return "fanin_fullprob"
    if "sched" in d and "ilo" in d and "ms" in d:
        return "pallas_banded"
    if "ms_sh" in d and "vlox" in d:
        return "pallas_job"
    if "open_r_shifted" in d and "gext_j" in d:
        return "sheared"
    if "loff" in d and "roff" in d:
        return "fanin"
    raise ValueError("not a prepare_sheared / prepare_fanin / "
                     "pallas_job_arrays / pallas_banded_args / "
                     "linear_fullprob_inputs / fanin_fullprob_inputs dict "
                     "(keys %s)" % sorted(d))


def inputs_from_reference(d, device="cpu", **kw):
    """Port kernel arguments from one reference prep dict or a list of
    them (a batch, all of one kind):

    - prepare_sheared dicts (f32; _add_scalar_params is applied here)
      -> linear_fill kwargs; kw: Lp (rows, default the longest L),
      bands (one (upper, lower) or None per job); a pair-end dict
      carries "pair_end" and its break column "jbrk", which the
      reference's dict does not;
    - pallas_job_arrays dicts (their ms_sh stream is already folded and
      holds diagonal d at row d - 1) -> linear_fill kwargs;
    - prepare_fanin dicts (f32) -> fanin_fill kwargs; kw as
      viterbi_fanin.fanin_batch_args (W, ilo, G, KL, KR, D);
    - one pallas_banded_args result, its args and meta merged
      (`dict(meta, **args)`: fscal, iscal, ms and the schedule's ilo, w)
      -> banded_fill kwargs: the stripe cut to the port's width Wk, the
      schedule rebuilt for it;
    - linear_fullprob_inputs dicts (f32, all of one Lp and Rp)
      -> fullprob_fwd / fullprob_bwd kwargs: the match stream folded as
      the reference's _fold_ms2 folds it, (msp * wl) * wr, the right
      weights read back out of their reversed extended layout;
    - fanin_fullprob_inputs dicts (f32, all of one Lp and Rp) -> the pair
      (fullprob_fwd_fanin kwargs, fullprob_bwd_fanin kwargs); kw: G (ring
      depth, default the largest OLm + ORm). The right side's slot
      arrays cross over indexed by site, so the reference's fanin_rext
      layout is not needed.
    """
    ds = list(d) if isinstance(d, (list, tuple)) else [d]
    kind = _kind(ds[0])
    if kind == "linear_fullprob":
        return _linear_fullprob_from_reference(ds, device)
    if kind == "fanin_fullprob":
        D, Lp = np.asarray(ds[0]["msp_sh"]).shape
        return ff.fanin_batch_args(ds, device, Lp=Lp, D=D, G=kw.get("G"))
    if kind == "pallas_banded":
        return _banded_from_reference(ds[0], device)
    if kind == "sheared":
        Lp = kw.get("Lp") or batch_rows(ds)
        bands = kw.get("bands") or [None] * len(ds)
        jobs = [linear_job_arrays(_add_scalar_params(dict(x)), Lp, band=b)
                for x, b in zip(ds, bands)]
        return linear_batch_args(jobs, device, D=kw.get("D"))
    if kind == "fanin":
        return fanin_batch_args(ds, device, **kw)
    # pallas_job_arrays: iscal is [R, L + R - 2], fscal as the port's
    dev = torch.device(device)
    ms_rows = [np.asarray(x["ms_sh"], np.float32) for x in ds]
    Dn, Lp = ms_rows[0].shape
    ms = np.zeros((len(ds), Dn + 1, Lp), np.float32)
    for b, rows in enumerate(ms_rows):
        ms[b, 1:] = rows
    iscal = np.zeros((len(ds), 8), np.int32)
    for b, x in enumerate(ds):
        R, cornerd = int(x["iscal"][0]), int(x["iscal"][1])
        iscal[b, :4] = [cornerd - R + 2, R, -1, 0]

    def t(key, dt):
        return torch.from_numpy(np.ascontiguousarray(
            np.stack([np.asarray(x[key], dt) for x in ds]))).to(dev)
    return dict(ms=torch.from_numpy(ms).to(dev),
                gexti=t("gexti", np.float32), ol=t("ol", np.float32),
                vlox=t("vlox", np.int32), vloy=t("vloy", np.int32),
                vhi=t("vhi", np.int32), fscal=t("fscal", np.float32),
                iscal=torch.from_numpy(iscal).to(dev))


def _banded_from_reference(d: dict, device):
    """banded_fill kwargs from the reference's banded prep: its stripe
    is (Dpk, S, Wl) with row d - 1 = diagonal d and zeros past each
    window, so its first D - 1 rows and Wk columns are the port's."""
    dev = torch.device(device)
    ilo, w = np.asarray(d["ilo"]), np.asarray(d["w"])
    Dn = len(ilo) - 1
    Wk = stripe_width(w.max())
    ms = np.asarray(d["ms"], np.float32)
    ms = ms.reshape(ms.shape[0], -1)[:Dn, :Wk]

    def t(a, dt):
        return torch.from_numpy(np.array(a, dt).reshape(-1)).to(dev)
    return dict(fscal=t(d["fscal"], np.float32),
                iscal=t(d["iscal"], np.int32),
                sched=torch.from_numpy(band_sched(ilo, w, Wk)).to(dev),
                ms=torch.from_numpy(np.array(ms)).to(dev))


def _linear_fullprob_from_reference(ds, device):
    dev = torch.device(device)
    ms2 = []
    for x in ds:
        msp = np.asarray(x["msp_sh"], np.float32)
        D, Lp = msp.shape
        rext = np.asarray(x["wr_rext"], np.float32)
        # row d of the reference's slices: wr[d - i] at lane i
        idx = np.clip(Lp + x["Rp"] - 2 - np.arange(D)[:, None]
                      + np.arange(Lp)[None, :], 0, len(rext) - 1)
        ms2.append(msp * np.asarray(x["wl"], np.float32)[None, :]
                   * rext[idx])
    return dict(ms2=torch.from_numpy(np.stack(ms2)).to(dev),
                consts=ff._consts(ds, dev, "seed"), iscal=ff._iscal(ds, dev))


PROBE_ARGS = ("fscal", "iscal", "gexti", "ol", "vlo", "vhi", "ms")


def probe_inputs_from_reference(arrays, device="cpu"):
    """viterbi_linear_probe.probe_fill / bisect_fill kwargs from the
    seven positional arrays of the reference's measuring kernels
    (fscal, iscal, gexti, ol, vlo, vhi, ms): the layouts are the same,
    (B, 8), (B, Lp) and (Dpk, B, Lp), so only the types cross over."""
    if len(arrays) != len(PROBE_ARGS):
        raise ValueError("expected the %d arrays %s, got %d"
                         % (len(PROBE_ARGS), PROBE_ARGS, len(arrays)))
    dev = torch.device(device)
    out = {}
    for name, a in zip(PROBE_ARGS, arrays):
        dt = np.int32 if name in ("iscal", "vlo", "vhi") else np.float32
        out[name] = torch.from_numpy(np.array(a, dt)).to(dev)
    return out
