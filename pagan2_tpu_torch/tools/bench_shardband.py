"""Bench of kernels G and H (the band-sharded fills,
align/viterbi_shardband.py) at the sharding gate's shapes, the pairs of
chip_smoke.py's kernel_shardband and shardband_path phases: a 65,535 bp
sequence against a 1,023 bp read of it (65,536 x 1,024 cells, kernel G)
and the 454 pair of its first 8,191 bp against another 1,023 bp read
(8,192 x 1,024 cells, kernel H), each over 4 logical shards of one
device, as the executor runs a giant pair alone in its generation.

For each fill and halo it prints the launches, the host walls of the
whole fill, of the fill less the gather of the codes to the host (the
prep's copies to the device, the codes' allocation and the launch
loop), of the launch loop alone where the package records it
(FILL_STATS) and of the gather, and on a card the kernels' device time
from torch.profiler (ms a launch, us a diagonal of a launch), then a
JSON line of every run.

    python -m pagan2_tpu_torch.tools.bench_shardband [--device cpu --small]
    python pagan2_tpu_torch/tools/bench_shardband.py --root DIR \\
        [--halo 32,64,128,256,512] [--geometry 128,1024,L512]
        [--save OUT | --check OUT]

Run as a file, --root times the pagan2_tpu_torch package of the
checkout DIR instead of this one, so that two versions compare on one
card in one call (in turns: parent, change, change, parent). --halo
runs each fill at each halo (default: the package's own, HALO), and
--geometry at each of kernel G's blocks of THREADS threads (two lanes
each) and kernel H's blocks of L lanes (default: the package's launch
plans); a run the package refuses prints so. --save writes a digest of every fill's
codes and corner (snapshot rings) under OUT; --check holds this run's
bit for bit against them. --small (for the CPU) takes a 600 x 60
linear pair and a 200 x 40 454 pair.
"""
from __future__ import annotations

import json
import time

if __package__:
    from . import replay
else:           # run as a file: this directory is sys.path[0]
    import replay

SHARDS = 4
GATE_SEED = 65536


def gate_pairs(n=65535, read=1023, small_454=None):
    """chip_smoke.py's gate draws from np.random.default_rng(65536): the
    n bp base, the linear pair's read of sites 20,000-21,022 (10%
    redrawn) and the 454 pair's read of sites 3,000-4,022; the 454 pair
    takes the base's first 8,191 sites (small_454: its first small_454)
    and the read's first `read`. Returns ((seq, read), (seq, read))."""
    import numpy as np
    rng = np.random.default_rng(GATE_SEED)
    base = rng.choice(list("ACGT"), size=n)

    def mutate(seg):
        mut = seg.copy()
        idx = rng.random(len(seg)) < 0.1
        mut[idx] = rng.choice(list("ACGT"), size=int(idx.sum()))
        return "".join(mut)
    lo = 20000 if n > 21023 else n // 4
    gate_read = mutate(base[lo:lo + 1023])
    lo = 3000 if n > 4023 else n // 8
    read454 = mutate(base[lo:lo + 1023])
    n454 = small_454 or 8191
    return (("".join(base), gate_read[:read]),
            ("".join(base[:n454]), read454[:read]))


def _timed_gather(SB, walls):
    real = SB._gather_lanes

    def gather(mesh, parts):
        t = time.perf_counter()
        out = real(mesh, parts)
        walls.append(time.perf_counter() - t)
        return out
    return real, gather


def _device_ms(torch, fn):
    """The device time of the shardband kernels over one call of fn, from
    torch.profiler (None where the trace has no device time)."""
    from torch.profiler import profile, ProfilerActivity
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    us, n = 0.0, 0
    for e in prof.key_averages():
        if "shardband" in e.key:
            us += getattr(e, "self_device_time_total",
                          getattr(e, "self_cuda_time_total", 0.0))
            n += e.count
    return (us / 1e3 if us > 0 else None), n


def main(argv=None):
    p = replay.parser(__doc__.splitlines()[0], "kernels G and H",
                      "a 600 x 60 linear and a 200 x 40 454 pair "
                      "(for the CPU)")
    p.add_argument("--halo", default="",
                   help="comma-separated halos (default: the package's)")
    p.add_argument("--geometry", default="",
                   help="comma-separated kernel G blocks of THREADS and "
                        "kernel H blocks of LLANES, each run at every halo "
                        "(default: the package's plans)")
    args = p.parse_args(argv)
    torch, dev, root = replay.start(args)
    import numpy as np
    from pagan2_tpu_torch.align import AlignSettings
    from pagan2_tpu_torch.align import viterbi_fanin as VF
    from pagan2_tpu_torch.align import viterbi_shardband as SB
    from pagan2_tpu_torch.graph import build_leaf_graph
    from pagan2_tpu_torch.models import ModelFactory, alphabets as alph
    from pagan2_tpu_torch.parallel.executor import JobsMesh

    model = ModelFactory(alph.DNA).alignment_model(0.1)
    settings = AlignSettings()
    mesh = JobsMesh([dev] * SHARDS)

    def pairs(small):
        """The linear pair's graphs, the 454 pair's prepare_fanin dict,
        its left bridge OLm and ring depth G."""
        if small:
            (s1, r1), (s2, r2) = gate_pairs(600, 60, small_454=200)
            r2 = r2[:40]
        else:
            (s1, r1), (s2, r2) = gate_pairs()
        inp = VF.prepare_fanin(
            build_leaf_graph(s2, alph.DNA, mode454=True),
            build_leaf_graph(r2, alph.DNA, mode454=True), model, settings,
            np.float32)
        OLm = max(inp["OL"], 1)
        return ((build_leaf_graph(s1, alph.DNA),
                 build_leaf_graph(r1, alph.DNA)), inp, OLm,
                SB._g_bucket(OLm + max(inp["OR"], 1)))

    def fill_of(kind, halo, geo, case):
        """(fill, H, steps a launch, meta) of one run; geo: kernel G's
        threads or kernel H's lanes (None: the plan's)."""
        lin, inp, OLm, G = case
        if kind == "linear":
            H = min(halo, SB._lane_split(lin[0].num_sites() - 1, SHARDS))
            shards, meta = SB.shardband_args(*lin, model, settings, SHARDS,
                                             H=H)

            def fill():
                if geo is None:
                    return SB.shardband_fill(mesh, shards, meta)
                saved = SB.G_THREADS
                SB.G_THREADS = geo
                try:
                    return SB.shardband_fill(mesh, shards, meta)
                finally:
                    SB.G_THREADS = saved
            return fill, H, H, meta
        w = SB._lane_split(inp["L"], SHARDS)
        saved = getattr(SB, "H_LANES", None)
        if geo is not None:
            SB.H_LANES = geo
        H = SB.fanin_halo(halo, G, w) if hasattr(SB, "fanin_halo") \
            else min(halo, w)
        T = max(1, H // OLm)
        shards, meta = SB.shardband_fanin_args(inp, SHARDS, H=H)

        def fill():
            if geo is not None:
                SB.H_LANES = geo
            try:
                return SB.shardband_fanin_fill(mesh, shards, meta, G, T)
            finally:
                if geo is not None:
                    SB.H_LANES = saved
        SB.H_LANES = saved
        return fill, H, T, meta

    halos = [int(h) for h in args.halo.split(",") if h] or [SB.HALO]
    geos = {"linear": [int(g) for g in args.geometry.split(",")
                       if g.isdigit()],
            "fanin": [int(g[1:]) for g in args.geometry.split(",")
                      if g.startswith("L")]}
    if dev.type == "cuda":
        # the kernels loaded and the allocator warm before any timing
        small = pairs(True)
        for kind in ("linear", "fanin"):
            fill_of(kind, halos[0], None, small)[0]()
    case = pairs(args.small)
    saved = None
    if args.check:
        import os
        with open(os.path.join(args.check, "shardband.json")) as f:
            saved = json.load(f)
    runs, digests = [], []
    for kind in ("linear", "fanin"):
        for geo in geos[kind] or [None]:
            for halo in halos:
                name = "shardband_%s_block" % kind
                walls = []
                real, gather = _timed_gather(SB, walls)
                SB._gather_lanes = gather
                try:
                    try:
                        fill, H, T, meta = fill_of(kind, halo, geo, case)
                        before = SB.LAUNCHES[name] + SB.PLAIN_CALLS[name]
                        t = time.perf_counter()
                        out = fill()
                    except ValueError as e:
                        print("%-7s H %3d %s: refused (%s)"
                              % (kind, halo, geo, e), flush=True)
                        continue
                    if dev.type == "cuda":
                        torch.cuda.synchronize()
                    wall = time.perf_counter() - t
                    launches = SB.LAUNCHES[name] + SB.PLAIN_CALLS[name] - \
                        before
                    loop = getattr(SB, "FILL_STATS", {}).get("loop_s")
                    kms, kn = (_device_ms(torch, fill) if dev.type == "cuda"
                               else (None, 0))
                finally:
                    SB._gather_lanes = real
                dg = replay.digest([torch.from_numpy(
                    np.ascontiguousarray(x)) for x in out])
                del out
                same = None if saved is None else \
                    len(digests) < len(saved) and saved[len(digests)] == dg
                digests.append(dg)
                rec = dict(kind=kind, halo=halo, H=H, steps=T, geometry=geo,
                           digest=[d["sha256"][:16] for d in dg],
                           L=meta["L"], R=meta["R"], launches=launches,
                           fill_s=wall, gather_s=walls[0],
                           less_gather_s=wall - walls[0], loop_s=loop,
                           kernel_ms=kms,
                           kernel_launches=kn,
                           ms_a_launch=None if kms is None else kms / kn,
                           us_a_diagonal=None if kms is None
                           else 1e3 * kms / kn / T, same=same)
                runs.append(rec)
                print("%-7s H %3d (T %3d)%s: %5d launches, fill %.3f s "
                      "(less gather %.3f, launch loop %s, gather %.3f)%s%s"
                      % (kind, H, T, "" if geo is None else " %s" % (geo,),
                         launches, wall, rec["less_gather_s"],
                         "not recorded" if loop is None else "%.3f" % loop,
                         rec["gather_s"],
                         "" if kms is None else
                         "; kernels %.3f ms on the device, %.4f ms a "
                         "launch, %.3f us a diagonal"
                         % (kms, rec["ms_a_launch"], rec["us_a_diagonal"]),
                         replay.same_text(same)), flush=True)
    if args.save:
        import os
        os.makedirs(args.save, exist_ok=True)
        with open(os.path.join(args.save, "shardband.json"), "w") as f:
            json.dump(digests, f)
    print(json.dumps(dict(package=root, device=(
        torch.cuda.get_device_name(0) if dev.type == "cuda" else "cpu"),
        runs=runs)))
    if args.check and not all(r["same"] for r in runs):
        raise SystemExit("outputs differ from those under %s" % args.check)
    return runs


if __name__ == "__main__":
    main()
