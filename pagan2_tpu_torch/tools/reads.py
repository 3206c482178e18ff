"""Read sets of the pileup paths, made from a seed:

- `amplicon_reads`: bench.py's 454-style amplicon generator
  (bench_pileup_e2e): a homopolymer-rich genome, reads from one locus
  with 1% homopolymer over-calls and 1% under-calls;
- `pair_end_reads`: the same reads made pair-end FASTQ reads, an insert
  cut out of each read's middle and the two ends joined with '0' (the
  FASTQ builder's read1/read2 joint), every base of quality 'I';
- `write_reads`: FASTA, or FASTQ when the reads carry qualities.

chip_smoke.py and the CPU tests make their pileup inputs with them. The
module imports nothing of the package.
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
