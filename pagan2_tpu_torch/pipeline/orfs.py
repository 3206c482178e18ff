"""Open-reading-frame search for translated pileup/placement
(Reads_aligner::find_orfs, reads_aligner.cpp:3129-3246).

All six frames are scanned; a stop/unknown codon ends the current frame;
fragments shorter than min_orf_length (or min_orf_coverage * len/3) are
dropped. Reverse-strand ORF coordinates are mapped back onto the forward
strand exactly as the reference does (start = len-1-end etc.).
"""
from __future__ import annotations

from dataclasses import dataclass

from ..graph.builders import revcomp
from ..io.translate import codon_to_amino


@dataclass
class Orf:
    translation: str
    frame: int           # 1..3 forward, -1..-3 reverse
    start: int           # DNA coordinates on the forward strand
    end: int
    dna_sequence: str


def find_orfs(dna: str, name: str = "", min_orf_length: int = 50,
              min_orf_coverage: float | None = None,
              mt: bool = False) -> list[Orf]:
    if min_orf_coverage is not None:
        min_orf_length = int(min_orf_coverage * len(dna) / 3)
    out: list[Orf] = []
    # NB the (len-1)//3 gate rejects a read holding an ORF of EXACTLY
    # min_orf_length (and --min-orf-coverage 1.0 can never pass) — the
    # reference has the identical quirk (reads_aligner.cpp:3138-3144);
    # replicated verbatim
    length = len(dna) - 1
    if length // 3 < min_orf_length:
        return out

    def scan(seq: str, rev: bool):
        for i in range(3):
            prot = []
            start = i
            end = i + 2
            frame = -(i + 1) if rev else i + 1

            def emit():
                s, e = start, end
                if rev:
                    s, e = length - end, length - start
                out.append(Orf(translation="".join(prot), frame=frame,
                               start=s, end=e,
                               dna_sequence=seq[start:end + 1]))

            sub = seq[i:]
            for j in range(0, len(sub), 3):
                codon = sub[j:j + 3]
                aa = codon_to_amino(codon, mt=mt) if len(codon) == 3 \
                    else "X"
                if aa in ("X", "-", "*"):
                    if len(prot) >= min_orf_length:
                        emit()
                    prot = []
                    start = j + i + 3
                else:
                    prot.append(aa)
                end = j + i + 2
            if len(prot) >= min_orf_length:
                emit()

    scan(dna, rev=False)
    scan(revcomp(dna), rev=True)
    return out
