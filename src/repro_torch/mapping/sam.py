"""SAM-like record emission (mapping stage 5; copy of ``repro.mapping.sam``
on the port's traceback and alphabets).

The DP layer's move convention puts the read on the query axis, so a
query-consuming MOVE_UP is a SAM insertion; ``SAM_OPS`` passes the corrected
op map to ``core.traceback.moves_to_cigar``.
"""
from __future__ import annotations

import dataclasses
import re

from repro_torch.core import alphabets
from repro_torch.core import types as T
from repro_torch.core.traceback import moves_to_cigar

FLAG_UNMAPPED = 4
FLAG_REVERSE = 16

# read-on-query-axis op map: MOVE_UP consumes a read char -> 'I'
SAM_OPS = {T.MOVE_DIAG: "M", T.MOVE_UP: "I", T.MOVE_LEFT: "D"}

_CIG_RE = re.compile(r"(\d+)([MIDNSHP=X])")


def moves_to_sam_cigar(moves, n_moves) -> str:
    return moves_to_cigar(moves, n_moves, ops=SAM_OPS)


def cigar_spans(cigar: str):
    """(read_span, ref_span) consumed by a CIGAR string."""
    read = ref = 0
    for cnt, op in _CIG_RE.findall(cigar):
        cnt = int(cnt)
        if op in "MI=XS":
            read += cnt
        if op in "MDN=X":
            ref += cnt
    return read, ref


@dataclasses.dataclass
class SamRecord:
    """One mapped (or unmapped) read; ``pos`` is 1-based, 0 if unmapped."""
    qname: str
    flag: int
    rname: str
    pos: int
    mapq: int
    cigar: str
    seq: str
    score: float = 0.0         # AS: alignment score (DP extension score)
    chain_score: float = 0.0   # s1: best chaining score

    @property
    def is_mapped(self) -> bool:
        return not self.flag & FLAG_UNMAPPED

    @property
    def is_reverse(self) -> bool:
        return bool(self.flag & FLAG_REVERSE)

    def to_line(self) -> str:
        rname = self.rname if self.is_mapped else "*"
        cigar = self.cigar if self.cigar else "*"
        return "\t".join([
            self.qname, str(self.flag), rname, str(self.pos),
            str(self.mapq), cigar, "*", "0", "0", self.seq, "*",
            f"AS:i:{int(self.score)}", f"s1:i:{int(self.chain_score)}"])


def unmapped(qname: str, read_codes) -> SamRecord:
    return SamRecord(qname=qname, flag=FLAG_UNMAPPED, rname="*", pos=0,
                     mapq=0, cigar="", seq=alphabets.decode_dna(read_codes))


def sam_header(rname: str, ref_len: int, program: str = "repro-mapper") -> str:
    return (f"@HD\tVN:1.6\tSO:unknown\n"
            f"@SQ\tSN:{rname}\tLN:{ref_len}\n"
            f"@PG\tID:{program}\tPN:{program}\n")
