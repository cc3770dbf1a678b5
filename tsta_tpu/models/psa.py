"""Pairwise sequence alignment pipeline.

Equivalent of the reference's ``TSTA_psa`` / ``TSTA_psa_notrace`` drivers
(psa/psa.c:539-668): load two FASTA sequences, orient the longer one
horizontally (psa/psa.c:194-199), run the DP, report the matrix-max score
and (traced mode) the aligned pair.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np

from tsta_tpu.config import AlignParams
from tsta_tpu.io import encode_dna
from tsta_tpu.ops import psa_scan, route, traceback
from tsta_tpu.parallel import batch

# The reference initialises its global running max to MIN = -100
# (psa/psa.c:110,590) and only ever raises it, so the printed `maxsorce`
# is floored at -100.  The library reports the true matrix max; the CLI
# applies this floor for stdout parity.
REFERENCE_SCORE_FLOOR = -100


@dataclasses.dataclass
class PsaOutput:
    score: int                      # max over all H cells (reference semantics)
    corner: int                     # H(m-1, n-1): the global alignment score
    swapped: bool                   # True if input order was swapped
    a_row: Optional[bytes] = None   # aligned horizontal sequence ('>1')
    b_row: Optional[bytes] = None   # aligned vertical sequence ('>2')


def align_pair(seq1: bytes, seq2: bytes, params: AlignParams = AlignParams(),
               traced: bool = False, swap: bool = True,
               kernel: str = "auto") -> PsaOutput:
    """Align two byte sequences.

    ``swap`` mirrors the reference: the longer sequence becomes the
    horizontal axis (columns).  ``kernel`` selects 'scan' (pure JAX
    oracle), 'cuda' (the Hopper kernel, a stack of one pair) or 'auto'
    (``ops/route.psa_engine``).
    """
    swapped = False
    if swap and len(seq2) > len(seq1):
        seq1, seq2 = seq2, seq1
        swapped = True
    a = encode_dna(seq1)
    b = encode_dna(seq2)
    if route.psa_engine(kernel) == "cuda":
        res = batch.align_batch([(a, b)], params, traced=traced,
                                swap=False, kernel="cuda")[0]
        out = PsaOutput(score=res.score, corner=res.last, swapped=swapped)
        if traced:
            out.a_row, out.b_row = res.aln
        return out
    res = psa_scan.psa_align(a, b, params, traced=traced)
    out = PsaOutput(score=int(res.score), corner=int(res.last),
                    swapped=swapped)
    if traced:
        aln = traceback.decode_pair(np.asarray(res.back),
                                    np.asarray(res.fback),
                                    np.asarray(res.eback), a, b)
        out.a_row, out.b_row = aln.a_row, aln.b_row
    return out


def align_files(path1: str, path2: str, params: AlignParams = AlignParams(),
                traced: bool = False, kernel: str = "auto") -> PsaOutput:
    """Reference-compatible entry: first record of each input file.

    Accepts FASTA or FASTQ (auto-detected, gzip ok) -- the reference's
    seqio carries a FASTQ reader its tools never call (seqio.c:543-641);
    here it is live.
    """
    from tsta_tpu.io import read_first_record
    rec1 = read_first_record(path1)
    rec2 = read_first_record(path2)
    if rec1 is None or rec2 is None:
        raise ValueError("empty sequence input")
    return align_pair(rec1.sequence, rec2.sequence, params, traced=traced,
                      kernel=kernel)


def write_alignment(out: PsaOutput, path: str) -> None:
    """Write the aligned pair in the reference's output format.

    The reference writes '>1\\n<a>\\n>2\\n<b>' with no trailing newline
    (psa/psa.c:512-515).
    """
    with open(path, "wb") as f:
        f.write(b">1\n" + out.a_row + b"\n>2\n" + out.b_row)
