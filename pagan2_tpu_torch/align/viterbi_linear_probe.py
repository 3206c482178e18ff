"""Kernel F: ablation variants of kernel A's step (csrc/viterbi_linear_probe.cu),
their plain PyTorch versions, and the prep that feeds them.

Replaces the measuring kernels of the JAX package's tools:
tools/_probe_pallas.py (`_kernel` via `probe_fill`) and
tools/_bisect_pallas.py (`make_kernel` via `run`). Each variant is the
linear Viterbi step with parts switched off, so that a step's cost can be
split into them (see the CUDA source for the flags). The public functions
keep the TPU tools' layout, ms and codes (Dpk, B, Lp) with row r =
diagonal r + 1, and their argument order (fscal, iscal, gexti, ol, vlo,
vhi, ms), so the tests compare like with like.

`TD` (the TPU's diagonals per grid step) has no counterpart here: one
launch runs every diagonal. It only sets Dpk, the multiple of TD that the
diagonals are padded to, and the padded diagonals are computed as on the
TPU. The probe's `vmem_mb` is a Mosaic VMEM limit with no CUDA
counterpart and is not taken.

Device rule: a CPU tensor takes the plain version; a CUDA tensor
launches kernel F as probe_plan(Lp) (kernel A's lane plan up to 2048
rows) says, or raises.
"""
from __future__ import annotations

import ctypes

import numpy as np
import torch

from .. import kernels
from .viterbi_linear import _block, has_lane_build, linear_batch_args

# flag bits, as in the CUDA source
NOBP, NOMS, NOMASK, NOCORNER, NOROLL = 1, 2, 4, 8, 16
_BIT = {"nobp": NOBP, "noms": NOMS, "nomask": NOMASK,
        "nocorner": NOCORNER, "noroll": NOROLL}

# the variants each tool runs (its instantiations in the CUDA source)
PROBE_VARIANTS = ("base", "nobp", "noms", "nomask", "nocorner",
                  "nobp+noms", "nobp+noms+nomask+nocorner")
BISECT_VARIANTS = ("full", "nobp", "noroll", "nomask", "nobp,noroll",
                   "nobp,noroll,nomask")
PROBE_NEG = float("-inf")           # the probe's NEG (viterbi_sheared)
# kernel F's lane builds: rows a thread and the most rows each is planned
# for (kernel A's up to 2048 rows); past the last, F's global build
PROBE_LANES = ((1, 128), (2, 2048), (4, 4096))
BISECT_NEG = float(np.float32(-1e30))   # the bisect tool's own NEG

# kernel F launches and plain-version calls, keyed "probe:<variant>" and
# "bisect:<variant>"
LAUNCHES = {"%s:%s" % (t, v): 0 for t, vs in (("probe", PROBE_VARIANTS),
                                              ("bisect", BISECT_VARIANTS))
            for v in vs}
PLAIN_CALLS = dict(LAUNCHES)


def probe_variant(opts=()) -> str:
    """Canonical name of a probe option set: 'base' or the options in
    the tool's order joined by '+'."""
    bad = set(opts) - {"nobp", "noms", "nomask", "nocorner"}
    if bad:
        raise ValueError("unknown probe options %s" % sorted(bad))
    name = "+".join(k for k in ("nobp", "noms", "nomask", "nocorner")
                    if k in opts) or "base"
    if name not in PROBE_VARIANTS:
        raise ValueError("probe option set %s is not one of the tool's "
                         "cases %s" % (name, PROBE_VARIANTS))
    return name


def bisect_variant(variant: str = "") -> str:
    """Canonical name of a bisect variant string ('' or 'full', or the
    tool's comma-joined switches)."""
    parts = [p for p in variant.split(",") if p and p != "full"]
    bad = set(parts) - {"nobp", "noroll", "nomask"}
    if bad:
        raise ValueError("unknown bisect switches %s" % sorted(bad))
    name = ",".join(k for k in ("nobp", "noroll", "nomask")
                    if k in parts) or "full"
    if name not in BISECT_VARIANTS:
        raise ValueError("bisect variant %s is not one of the tool's "
                         "runs %s" % (name, BISECT_VARIANTS))
    return name


def _flags(name: str) -> int:
    if name in ("base", "full"):
        return 0
    return sum(_BIT[k] for k in name.replace(",", "+").split("+"))


# ----------------------------------------------------------------------
def probe_args(jobs: list, device, TD: int = 16):
    """The 7 probe arguments (fscal, iscal, gexti, ol, vlo, vhi, ms) for a
    batch of viterbi_linear.linear_job_arrays dicts (all of one Lp):
    vlo = min(vlox, vloy), iscal = [R, L + R - 2] per job, and ms the
    folded match-score diagonals 1 .. Dpk as (Dpk, B, Lp), Dpk the
    diagonals D - 1 padded up to a multiple of TD (padding reads 0)."""
    D = max(int(j["iscal"][0] + j["iscal"][1]) for j in jobs) - 1
    Dpk = -(-(D - 1) // TD) * TD
    a = linear_batch_args(jobs, device, D=Dpk + 1)
    iscal = torch.zeros_like(a["iscal"])
    iscal[:, 0] = a["iscal"][:, 1]
    iscal[:, 1] = a["iscal"][:, 0] + a["iscal"][:, 1] - 2
    return dict(fscal=a["fscal"], iscal=iscal, gexti=a["gexti"], ol=a["ol"],
                vlo=torch.minimum(a["vlox"], a["vloy"]), vhi=a["vhi"],
                ms=a["ms"][:, 1:].transpose(0, 1).contiguous())


def _check_args(fscal, iscal, gexti, ol, vlo, vhi, ms, TD):
    if ms.dim() != 3:
        raise ValueError("ms must be (Dpk, B, Lp)")
    Dpk, B, Lp = ms.shape
    want = [("fscal", fscal, torch.float32, (B, 8)),
            ("iscal", iscal, torch.int32, (B, 8)),
            ("gexti", gexti, torch.float32, (B, Lp)),
            ("ol", ol, torch.float32, (B, Lp)),
            ("vlo", vlo, torch.int32, (B, Lp)),
            ("vhi", vhi, torch.int32, (B, Lp)),
            ("ms", ms, torch.float32, (Dpk, B, Lp))]
    for name, t, dt, shape in want:
        if t.dtype != dt:
            raise TypeError("%s must be %s, got %s" % (name, dt, t.dtype))
        if tuple(t.shape) != shape:
            raise ValueError("%s must have shape %s, got %s"
                             % (name, shape, tuple(t.shape)))
        if not t.is_contiguous():
            raise ValueError("%s must be contiguous" % name)
        if t.device != ms.device:
            raise ValueError("%s is on %s, ms on %s"
                             % (name, t.device, ms.device))
    if ms.device.type not in ("cpu", "cuda"):
        raise ValueError("unsupported device %s" % ms.device)
    if Dpk % TD:
        raise ValueError("Dpk %d is not a multiple of TD %d" % (Dpk, TD))
    return Dpk, B, Lp


def probe_plan(Lp: int) -> dict:
    """How kernel F is launched on Lp rows: rows a thread from
    PROBE_LANES (1, 2 or 4 consecutive rows, their M, X, Y in registers;
    1 up to 128 rows, 2 up to 2048, 4 up to 4096: up to 2048 rows kernel
    A's plan, so that F's flag sets split A's step on the build A runs);
    0, F's global build (threads strided over the rows, three diagonals
    in a global scratch), past 4096 rows or on rows that are not a whole
    number of warps; threads: the block. Kernel A runs its tiled build
    past 2048 rows; F has none."""
    rows = next((r for r, top in PROBE_LANES if Lp <= top), 0) \
        if Lp % 32 == 0 else 0
    if rows:
        return dict(rows=rows, threads=_block(Lp, rows),
                    diagonals="registers")
    return dict(rows=0, threads=min(1024, _block(Lp, 1)),
                diagonals="global")


def has_build(plan, Lp: int) -> bool:
    """Whether kernel F has a build for `plan` on Lp rows: a lane build
    of PROBE_LANES, or its global build."""
    if plan["diagonals"] == "global":
        return plan["rows"] == 0 and 32 <= plan["threads"] <= 1024 and \
            plan["threads"] % 32 == 0
    return has_lane_build(plan, Lp, PROBE_LANES)


def _launch(plan, entry, key, flags, neg, fscal, iscal, gexti, ol, vlo,
            vhi, ms):
    """One launch of kernel F's `entry` as `plan` (probe_plan) says. A
    plan with no build raises ValueError before anything is loaded or
    launched."""
    Dpk, B, Lp = ms.shape
    rows, threads = plan["rows"], plan["threads"]
    if not has_build(plan, Lp):
        raise ValueError("kernel F has no build for the plan %s on %d rows"
                         % (plan, Lp))
    if rows and ms.data_ptr() % (4 * rows):
        raise ValueError("ms must be aligned to %d bytes for the %d-row "
                         "build" % (4 * rows, rows))
    lib = kernels.load("viterbi_linear_probe")
    fn = getattr(lib, entry)
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * 12 + [ctypes.c_float] + \
        [ctypes.c_int] * 6 + [ctypes.c_void_p]
    bp = torch.empty((Dpk, B, Lp), dtype=torch.int8, device=ms.device)
    fM, fX, fY = (torch.empty((B, Lp), dtype=torch.float32,
                              device=ms.device) for _ in range(3))
    gbuf = None if rows else torch.empty(
        (B, 9, Lp), dtype=torch.float32, device=ms.device)
    with torch.cuda.device(ms.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(fscal.data_ptr(), iscal.data_ptr(), gexti.data_ptr(),
                 ol.data_ptr(), vlo.data_ptr(), vhi.data_ptr(),
                 ms.data_ptr(), bp.data_ptr(), fM.data_ptr(),
                 fX.data_ptr(), fY.data_ptr(),
                 0 if gbuf is None else gbuf.data_ptr(), neg, B, Dpk, Lp,
                 rows, threads, flags, stream)
    if err == -1:
        raise RuntimeError("%s has no instantiation for flags %d" %
                           (entry, flags))
    kernels.check(err, "viterbi_linear_probe %s" % key)
    LAUNCHES[key] += 1
    return bp, fM, fX, fY


def probe_fill(fscal, iscal, gexti, ol, vlo, vhi, ms, TD: int = 16,
               opts=()):
    """One probe variant (tools/_probe_pallas.py::probe_fill): opts is a
    subset of nobp, noms, nomask, nocorner that is one of the tool's
    cases. Returns (bp (Dpk, B, Lp) int8, fM, fX, fY (B, Lp) f32: the
    rows of each job's diagonal cornerd). Under nobp bp is undefined
    on a card, as in the JAX kernel (nothing is stored, and the timed
    call carries no fill of it); the plain version returns zeros."""
    name = probe_variant(opts)
    _check_args(fscal, iscal, gexti, ol, vlo, vhi, ms, TD)
    key = "probe:" + name
    args = (fscal, iscal, gexti, ol, vlo, vhi, ms)
    if ms.device.type == "cpu":
        PLAIN_CALLS[key] += 1
        return probe_fill_plain(*args, opts=opts)
    return _launch(probe_plan(ms.shape[2]), "viterbi_probe_launch", key,
                   _flags(name), PROBE_NEG, *args)


def bisect_fill(fscal, iscal, gexti, ol, vlo, vhi, ms, variant: str = "",
                TD: int = 16):
    """One bisect variant (tools/_bisect_pallas.py::make_kernel): variant
    is '' (full) or the tool's comma-joined switches of nobp, noroll and
    nomask. Returns (bp, fM, fX, fY) as probe_fill; under nobp every
    code is 0."""
    name = bisect_variant(variant)
    _check_args(fscal, iscal, gexti, ol, vlo, vhi, ms, TD)
    key = "bisect:" + name
    args = (fscal, iscal, gexti, ol, vlo, vhi, ms)
    if ms.device.type == "cpu":
        PLAIN_CALLS[key] += 1
        return bisect_fill_plain(*args, variant=variant)
    return _launch(probe_plan(ms.shape[2]), "viterbi_bisect_launch", key,
                   _flags(name), BISECT_NEG, *args)


# ----------------------------------------------------------------------
def _step_plain(fscal, iscal, gexti, ol, vlo, vhi, ms, *, neg, codes,
                readms, masks, selects, corner, roll, capture=None):
    """The variants' loop over diagonals on (B, Lp) tensors, in the JAX
    kernels' f32 order: candidates formed at every row and the X and M
    ones (and their code bits) moved one row down, circularly. A list
    given as `capture` gets (M, X, Y) of every diagonal appended."""
    Dpk, B, Lp = ms.shape
    dev = ms.device
    f = torch.float32
    negt = torch.tensor(neg, dtype=f, device=dev)
    gext, gend, lgo, lng, orp0 = (fscal[:, k:k + 1] for k in range(5))
    Rdp, cornerd = iscal[:, 0:1], iscal[:, 1:2]
    lane = torch.arange(Lp, device=dev)[None, :]
    pgt0 = lane > 0

    def rolled(v):
        return torch.roll(v, 1, dims=1) if roll else v

    m1 = torch.where(lane == 0, torch.zeros((), dtype=f, device=dev),
                     negt).expand(B, Lp)
    x1 = torch.full((B, Lp), neg, dtype=f, device=dev)
    y1 = m2 = x2 = y2 = fM = fX = fY = x1
    bp = torch.zeros((Dpk, B, Lp), dtype=torch.int8, device=dev)
    zero = torch.zeros((B, Lp), dtype=f, device=dev)
    for t in range(Dpk):
        d = 1 + t
        jsrc = (d - 1) - lane
        jt = jsrc + 1
        t1 = m1 + lng
        gj = torch.where((jsrc == 0) | (jsrc == Rdp - 1), gend, gext) \
            if selects else gext
        cx0 = x1 + gj
        cx1 = y1 + lgo
        cx2 = t1 + ol
        v01 = torch.maximum(cx0, cx1)
        xc = torch.maximum(v01, cx2)
        orp = torch.where(jsrc == 0, orp0, lgo) if selects else lgo
        cy0 = y1 + gexti
        cy1 = x1 + lgo
        cy2 = t1 + orp
        w01 = torch.maximum(cy0, cy1)
        yc = torch.maximum(w01, cy2)
        t2 = m2 + lng
        u01 = torch.maximum(t2, x2)
        mc = torch.maximum(u01, y2)
        msv = ms[t] if readms else zero
        if masks:
            valid = (jt >= vlo) & (jt <= vhi)
            jgt0 = jt > 0
            okx = valid & pgt0
            oky = valid & jgt0
            okm = okx & jgt0
            X = torch.where(okx, rolled(xc), negt)
            Y = torch.where(oky, yc, negt)
            M = torch.where(okm, rolled(mc) + msv, negt)
        else:
            X = rolled(xc)
            Y = yc
            M = rolled(mc) + msv
        if codes:
            bx = torch.where(cx2 > v01, 2, torch.where(cx1 > cx0, 1, 0))
            by = torch.where(cy2 > w01, 2, torch.where(cy1 > cy0, 1, 0))
            bm = torch.where(y2 > u01, 2, torch.where(x2 > t2, 1, 0))
            bp[t] = (rolled(bm | (bx << 2)) | (by << 4)).to(torch.int8)
        if corner:
            hit = cornerd == d
            fM = torch.where(hit, M, fM)
            fX = torch.where(hit, X, fX)
            fY = torch.where(hit, Y, fY)
        if capture is not None:
            capture.append((M, X, Y))
        m2, x2, y2 = m1, x1, y1
        m1, x1, y1 = M, X, Y
    return bp, fM.contiguous(), fX.contiguous(), fY.contiguous()


def probe_fill_plain(fscal, iscal, gexti, ol, vlo, vhi, ms, opts=(),
                     capture=None):
    """Plain PyTorch version of the probe's variant `opts` (`capture` as
    in _step_plain)."""
    probe_variant(opts)
    return _step_plain(fscal, iscal, gexti, ol, vlo, vhi, ms,
                       neg=PROBE_NEG, codes="nobp" not in opts,
                       readms="noms" not in opts,
                       masks="nomask" not in opts, selects=True,
                       corner="nocorner" not in opts, roll=True,
                       capture=capture)


def bisect_fill_plain(fscal, iscal, gexti, ol, vlo, vhi, ms,
                      variant: str = "", capture=None):
    """Plain PyTorch version of the bisect's variant (`capture` as in
    _step_plain)."""
    name = bisect_variant(variant)
    masks = "nomask" not in name
    return _step_plain(fscal, iscal, gexti, ol, vlo, vhi, ms,
                       neg=BISECT_NEG, codes="nobp" not in name,
                       readms=True, masks=masks, selects=masks,
                       corner=True, roll="noroll" not in name,
                       capture=capture)
