"""Query placement at full width: bench.py's 16 x 1535 family aligned
by the CLI, then 34 queries of tools/reads.py's placement_queries (8
new members, 24 reads of 150-400 bp, 8 of them reverse-complemented, 2
random 300-bp sequences) placed onto that alignment through the CLI:

  (a) --ref-seqfile --ref-treefile -q q34 --both-strands
      --output-discarded-queries
  (b) the same with --fragments
  (c) -s -t -q with the 8 members
  (d) --ref-seqfile --ref-treefile -q with the 24 reads
      --align-reads-at-root

Each run prints its wall (ending in a synchronize), the launches of
kernels A, B and C, the executor's routes, the placed and discarded
queries and the sha256 of its output files; run (a) also its host
phases. chip_smoke.py's placement_path phase runs a cut of these (the
first 8 queries and the 2 random ones), which fits its time.

    python -m pagan2_tpu_torch.tools.bench_placement            # on a card
    python -m pagan2_tpu_torch.tools.bench_placement --device cpu --small

--small places 4 queries onto a 4 x 120 family (for the CPU: the
plain versions, times by the host clock).
"""
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

# run (a)'s host phases: (module name, function, label)
HOST_PHASES = (
    ("placement", "_build_score_jobs", "scoring prep (graph deep copies)"),
    ("executor", "execute_pair_jobs", "execute_pair_jobs"),
    ("placement", "_match_score_from_anc", "_match_score_from_anc"),
    ("placement", "align_pair", "splice align_pair"),
    ("placement", "read_alignment_scores", "read_alignment_scores"),
    ("placement", "_correct_sites_index", "_correct_sites_index"),
    ("placement", "extract_alignment", "extract_alignment"))


def sha(path):
    with open(path, "rb") as f:
        return hashlib.sha256(f.read()).hexdigest()


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                   help="cuda (default; raises without a card) launches "
                        "the kernels; cpu runs their plain versions")
    p.add_argument("--small", action="store_true",
                   help="4 queries onto a 4 x 120 family (for the CPU)")
    p.add_argument("--work", default=os.path.join(HERE, "build",
                                                  "bench_placement"),
                   help="directory for the inputs and outputs")
    args = p.parse_args(argv)
    sys.path.insert(0, HERE)
    import torch
    from pagan2_tpu_torch import cli as CLI
    from pagan2_tpu_torch.align import viterbi_banded as VB
    from pagan2_tpu_torch.align import viterbi_fanin as VF
    from pagan2_tpu_torch.align import viterbi_linear as VL
    from pagan2_tpu_torch.parallel import executor as EX
    from pagan2_tpu_torch.pipeline import pileup as PILE
    from pagan2_tpu_torch.pipeline import placement as PLACE
    from pagan2_tpu_torch.tools.bench_fanin import family
    from pagan2_tpu_torch.tools.reads import placement_queries, write_reads

    if args.device == "cuda":
        if not torch.cuda.is_available():
            raise SystemExit("--device cuda: torch.cuda.is_available() is "
                             "False")
        smi = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            check=True).stdout.strip().splitlines()[0]
        print("device: %s (%s)" % (torch.cuda.get_device_name(0), smi),
              flush=True)
    os.makedirs(args.work, exist_ok=True)
    n, L = (4, 120) if args.small else (16, 1535)
    seqs, tree = family(n, L)
    fas = write_reads(os.path.join(args.work, "family.fas"), seqs)
    nh = os.path.join(args.work, "family.nh")
    with open(nh, "w") as f:
        f.write(tree + "\n")
    q = (placement_queries(L, 1, 2, 40, 60, 1, 1, 60) if args.small else
         placement_queries(L, 8, 24, 150, 400, 8, 2, 300))
    members = [e for e in q if e[0].startswith("m")]
    reads = [e for e in q if e[0].startswith("r")]
    qall = write_reads(os.path.join(args.work, "queries.fas"), q)
    qm = write_reads(os.path.join(args.work, "members.fas"), members)
    qr = write_reads(os.path.join(args.work, "reads.fas"), reads)
    ref = os.path.join(args.work, "ref")
    device = ["--device", args.device]
    refflags = ["--ref-seqfile", ref + ".fas", "--ref-treefile", nh]
    runs = (("main", ["-s", fas, "-t", nh]),
            ("a", refflags + ["-q", qall, "--both-strands",
                              "--output-discarded-queries"]),
            ("b", refflags + ["-q", qall, "--both-strands",
                              "--output-discarded-queries",
                              "--fragments"]),
            ("c", ["-s", fas, "-t", nh, "-q", qm]),
            ("d", refflags + ["-q", qr, "--align-reads-at-root"]))
    mods = {"placement": PLACE, "executor": EX}
    kernels = {"A": VL, "B": VF, "C": VB}
    results = []
    for run, flags in runs:
        out = ref if run == "main" else os.path.join(args.work, run)
        host = {}
        saved = []
        if run == "a":
            for mod, name, label in HOST_PHASES:
                m = mods[mod]
                fn = getattr(m, name)
                saved.append((m, name, fn))

                def timed(*a, _fn=fn, _label=label, **kw):
                    t = time.time()
                    try:
                        return _fn(*a, **kw)
                    finally:
                        host[_label] = host.get(_label, 0.0) + \
                            time.time() - t
                setattr(m, name, timed)
        outcome = []
        captured = [(PLACE, "place_queries"), (PILE, "pileup_align")]
        for m, name in captured:
            fn = getattr(m, name)
            saved.append((m, name, fn))

            def capture(*a, _fn=fn, **kw):
                outcome.append(_fn(*a, **kw))
                return outcome[-1]
            setattr(m, name, capture)
        EX.reset_stats()
        for m in kernels.values():
            m.LAUNCHES = m.PLAIN_CALLS = 0
        t = time.time()
        try:
            rc = CLI.main(device + flags + ["-o", out, "--silent"])
            if args.device == "cuda":
                torch.cuda.synchronize()
        finally:
            for m, name, fn in saved:
                setattr(m, name, fn)
        wall = time.time() - t
        if rc != 0:
            raise SystemExit("run %s: the CLI returned %d" % (run, rc))
        res = {"run": run, "wall_s": wall,
               "launches": {k: m.LAUNCHES for k, m in kernels.items()},
               "plain_calls": sum(m.PLAIN_CALLS for m in kernels.values()),
               "routes": dict(EX.EXEC_STATS),
               "sha256": {sfx: sha(out + sfx)
                          for sfx in (".fas", ".discarded")
                          if os.path.exists(out + sfx)}}
        if outcome and run == "d":
            res["discarded"] = list(outcome[-1].discarded)
        elif outcome:
            res["placed"] = len(outcome[-1].placed)
            res["discarded"] = [e.name for e in outcome[-1].discarded]
        if host:
            res["host_s"] = host
        print("run %s: %.1f s, launches %s, %d plain-version calls; %s"
              % (run, wall, json.dumps(res["launches"]),
                 res["plain_calls"], json.dumps(
                     {k: v for k, v in res.items()
                      if k in ("placed", "discarded", "sha256")})),
              flush=True)
        for label, v in host.items():
            print("run a host phase %-34s %8.3f s" % (label, v))
        results.append(res)
    print(json.dumps({"bench_placement": results}))
    return results


if __name__ == "__main__":
    main()
