"""Read sets of the pileup paths, made from a seed:

- `amplicon_reads`: bench.py's 454-style amplicon generator
  (bench_pileup_e2e): a homopolymer-rich genome, reads from one locus
  with 1% homopolymer over-calls and 1% under-calls;
- `pair_end_reads`: the same reads made pair-end FASTQ reads, an insert
  cut out of each read's middle and the two ends joined with '0' (the
  FASTQ builder's read1/read2 joint), every base of quality 'I';
- `placement_queries`: queries for a placement onto bench.py's
  progressive family (new members of the family, reads cut from them,
  some reverse-complemented, and unrelated random sequences);
- `write_reads`: FASTA, or FASTQ when the reads carry qualities.

chip_smoke.py and the CPU tests make their pileup and placement inputs
with them. The module imports nothing of the package.
"""
from __future__ import annotations


def amplicon_reads(n_reads, rlen, glen, seed=3):
    """(name, sequence) of bench.py's amplicon reads (bench.py:196-252:
    40 x 384 from a 420-bp genome on the chip, 6 x 96 from 110 bp on
    the CPU)."""
    import numpy as np
    rng = np.random.default_rng(seed)
    parts = []
    total = 0
    while total < glen:
        c = "ACGT"[int(rng.integers(0, 4))]
        run = int(rng.integers(1, 5))
        parts.append(c * run)
        total += run
    genome = "".join(parts)
    reads = []
    for k in range(n_reads):
        start = int(rng.integers(0, max(len(genome) - rlen, 1)))
        r = []
        for c in genome[start:start + rlen]:
            u = rng.random()
            if u < 0.01:
                r.append(c + c)        # homopolymer over-call
            elif u < 0.02:
                pass                   # under-call
            else:
                r.append(c)
        reads.append(("r%03d" % k, "".join(r)))
    return reads


def pair_end_reads(reads, insert_min, insert_max, seed=4):
    """(name, sequence, quality) of each read made a pair: an insert of
    insert_min..insert_max bases (seeded) cut out of its middle, the two
    ends joined with '0', every character of quality 'I'."""
    import numpy as np
    rng = np.random.default_rng(seed)
    out = []
    for name, s in reads:
        n = int(rng.integers(insert_min, insert_max + 1))
        a = (len(s) - n) // 2
        seq = s[:a] + "0" + s[a + n:]
        out.append((name, seq, "I" * len(seq)))
    return out


def placement_queries(L, n_members, n_reads, read_min, read_max,
                      n_revcomp, n_random, random_len, seed=13):
    """(name, sequence) of queries for bench.py's progressive family of
    width L (bench.py:254-273, whose base comes from default_rng(5);
    tools/bench_fanin.py's `family`): first n_members new members of
    the family, drawn from default_rng(seed) the way bench.py draws a
    member (10% substitutions, the 12-bp deletion at L // 3 in every
    third); then n_reads reads of read_min..read_max bases cut from
    them in turn, with 1% substitutions, n_revcomp of them (every
    (n_reads // n_revcomp)-th, from the first) reverse-complemented;
    last n_random unrelated random sequences of random_len bases, which
    a placement must discard. Names: m0.., r00.., x0.."""
    import numpy as np
    base = np.random.default_rng(5).choice(list("ACGT"), size=L)
    rng = np.random.default_rng(seed)
    members = []
    for i in range(n_members):
        mut = base.copy()
        idx = rng.random(L) < 0.1
        mut[idx] = rng.choice(list("ACGT"), size=int(idx.sum()))
        s = "".join(mut)
        if i % 3 == 1:
            s = s[:L // 3] + s[L // 3 + 12:]
        members.append(("m%d" % i, s))
    stride = n_reads // n_revcomp if n_revcomp else 0
    comp = str.maketrans("ACGT", "TGCA")
    reads = []
    for k in range(n_reads):
        src = members[k % n_members][1]
        n = min(int(rng.integers(read_min, read_max + 1)), len(src))
        start = int(rng.integers(0, len(src) - n + 1))
        r = np.array(list(src[start:start + n]))
        idx = rng.random(n) < 0.01
        r[idx] = rng.choice(list("ACGT"), size=int(idx.sum()))
        r = "".join(r)
        if stride and k % stride == 0:
            r = r.translate(comp)[::-1]
        reads.append(("r%02d" % k, r))
    randoms = [("x%d" % k, "".join(rng.choice(list("ACGT"),
                                              size=random_len)))
               for k in range(n_random)]
    return members + reads + randoms


def write_reads(path, reads):
    """Write (name, sequence) as FASTA or (name, sequence, quality) as
    FASTQ; returns path."""
    with open(path, "w") as f:
        for r in reads:
            if len(r) == 3:
                f.write("@%s\n%s\n+\n%s\n" % r)
            else:
                f.write(">%s\n%s\n" % r)
    return path
