"""What the kernel benches (bench_fanin, bench_fullprob, bench_banded)
share: their command line, the import of another checkout's package
(--root), recording a kernel's calls from a CLI run in its wrappers'
places, and replaying each call once for its outputs (digested, saved
under --save, held bit for bit against --check) and then timed.

It imports nothing of pagan2_tpu_torch at its top: run as a file, a
bench imports this module as its sibling and the package from --root,
so that two versions of a kernel compare on one card in one call (in
turns: parent, change, change, parent)."""
from __future__ import annotations

import argparse
import hashlib
import json
import os
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
# timed calls on a card, after the call that gave the outputs
REPS = 5


def parser(description: str, kernels: str, small: str):
    """The benches' command line: --device, --small, --root, --save and
    --check."""
    p = argparse.ArgumentParser(description=description)
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                   help="cuda (default; raises without a card) launches "
                        "%s; cpu runs the plain versions" % kernels)
    p.add_argument("--small", action="store_true", help=small)
    p.add_argument("--root", default=HERE,
                   help="checkout whose pagan2_tpu_torch is timed")
    p.add_argument("--save", help="directory to write output digests to")
    p.add_argument("--check",
                   help="directory of saved output digests to match")
    return p


def start(args):
    """Import torch and the --root checkout's package and announce the
    device (on a card its name and power limit). Returns (torch, device,
    root)."""
    root = os.path.abspath(args.root)
    sys.path.insert(0, root)
    import torch
    import pagan2_tpu_torch as PT
    if os.path.dirname(os.path.dirname(os.path.abspath(PT.__file__))) \
            != root:
        raise SystemExit("pagan2_tpu_torch was imported from %s, not from "
                         "--root %s: run this tool as a file"
                         % (PT.__file__, root))
    dev = torch.device(args.device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise SystemExit("--device cuda: torch.cuda.is_available() is "
                             "False")
        smi = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            check=True).stdout.strip().splitlines()[0]
        print("device: %s (%s); package %s"
              % (torch.cuda.get_device_name(0), smi, root), flush=True)
    else:
        print("device: cpu (plain versions; times by the host clock, not "
              "device times); package %s" % root, flush=True)
    return torch, dev, root


def record_cli(CLI, module, names, seqs, tree, work, device, flags=()):
    """The calls that one CLI run on (seqs, tree) with `flags` makes to
    the named wrappers of `module`, recorded in their places as
    (name, kwargs). With tree None, seqs are a --pileup run's reads
    (given with -q; `flags` holds --pileup). The inputs and outputs go
    under build/<work>."""
    calls = []
    real = {n: getattr(module, n) for n in names}

    def recorder(name):
        def fill(**kw):
            calls.append((name, kw))
            return real[name](**kw)
        return fill
    work = os.path.join(HERE, "build", work)
    os.makedirs(work, exist_ok=True)
    fas, nh = os.path.join(work, "seqs.fas"), os.path.join(work, "tree.nh")
    with open(fas, "w") as f:
        f.writelines(">%s\n%s\n" % s for s in seqs)
    inputs = ["-q", fas]
    if tree is not None:
        with open(nh, "w") as f:
            f.write(tree + "\n")
        inputs = ["-s", fas, "-t", nh]
    for n in names:
        setattr(module, n, recorder(n))
    try:
        rc = CLI.main(inputs + ["-o", os.path.join(work, "out"), "--silent",
                                "--device", device, *flags])
        if rc:
            raise SystemExit("the CLI returned %d" % rc)
    finally:
        for n in names:
            setattr(module, n, real[n])
    return calls


def digest(outputs):
    """The outputs of one call, compared bit for bit: each tensor's
    dtype, shape and the sha256 of its bytes."""
    out = []
    for t in outputs:
        c = t.detach().cpu().contiguous()
        out.append(dict(dtype=str(c.dtype), shape=list(c.shape),
                        sha256=hashlib.sha256(
                            c.numpy().tobytes()).hexdigest()))
    return out


def time_call(torch, fn, kw, reps):
    """ms per call on a card: CUDA events over `reps` calls after the
    caller's first call."""
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    for _ in range(reps):
        fn(**kw)
    t1.record()
    torch.cuda.synchronize()
    return t0.elapsed_time(t1) / reps


def replay(args, torch, dev, tool, calls):
    """Each of `calls` ([(fn, kwargs, reps)]) once for its outputs, then
    timed; yields (index, kwargs, ms, same) a call. ms: CUDA events over
    `reps` calls on a card, the first call by the host clock on the CPU.
    same: None, or whether the outputs equal those saved under --check.
    After the last call, --save writes the digests to <dir>/<tool>.json."""
    saved = None
    if args.check:
        with open(os.path.join(args.check, tool + ".json")) as f:
            saved = json.load(f)
    digests = []
    for k, (fn, kw, reps) in enumerate(calls):
        t = time.perf_counter()
        outputs = fn(**kw)
        if dev.type == "cuda":
            torch.cuda.synchronize()
        ms = 1e3 * (time.perf_counter() - t)
        dg = digest(outputs)
        digests.append(dg)
        same = None if saved is None else k < len(saved) and saved[k] == dg
        del outputs
        if dev.type == "cuda":
            ms = time_call(torch, fn, kw, reps)
        yield k, kw, ms, same
    if args.save:
        os.makedirs(args.save, exist_ok=True)
        with open(os.path.join(args.save, tool + ".json"), "w") as f:
            json.dump(digests, f)


def same_text(same):
    """The end of a call's line: how its outputs compare with --check's."""
    return ("" if same is None else ", equal to the saved outputs" if same
            else ", DIFFERS from the saved outputs")


def finish(args, torch, dev, root, runs, keys):
    """Print the summary JSON line (calls, sum and mean ms, grouped by
    the values of `keys` in turn) and exit non-zero if --check found a
    call whose outputs differ. Returns `runs`."""
    summary = {}
    for r in runs:
        node = summary
        for key in keys:
            node = node.setdefault(r[key], {})
        node["calls"] = node.get("calls", 0) + 1
        node["sum_ms"] = node.get("sum_ms", 0.0) + r["ms"]
        node["mean_ms"] = node["sum_ms"] / node["calls"]
    print(json.dumps(dict(package=root, device=(
        torch.cuda.get_device_name(0) if dev.type == "cuda" else "cpu"),
        runs=summary)))
    if args.check and not all(r["same"] for r in runs):
        raise SystemExit("outputs differ from those under %s" % args.check)
    return runs
