"""Progressive POA multiple sequence alignment pipeline.

Equivalent of the reference's ``TSTA_msa`` driver (msa/msa.c:75-151):
read N FASTA records, build a linear POA graph from the first, fuse each
subsequent read via an alignment round, and emit the row-wise MSA plus the
heaviest-bundle consensus.

Two engines:

* ``compat`` -- the native C engine (tsta_tpu/native/compat_msa.c), bit-exact
  against the reference binaries (golden-tested);
* ``native`` -- exact int32 POA DP in JAX (ops/msa_native.py), the device
  path; same pipeline, textbook-exact recurrence without the reference's
  int8 clamps, so scores can differ (documented; usually equal or better).
"""

from __future__ import annotations

import ctypes
import dataclasses
from typing import List

from tsta_tpu.config import AlignParams


@dataclasses.dataclass
class MsaOutput:
    rows: List[bytes]            # aligned rows, one per input sequence
    consensus: bytes
    round_scores: List[int]      # per-round absolute end scores (lastsorce)
    graph_len: List[int]         # graph size after each round's fusion
    add_len: List[int]           # nodes added per round (poa_add_len)


def align_seqs(seqs: List[bytes], params: AlignParams = AlignParams(),
               engine: str = "compat", width: int = 10, mesh=None,
               checkpoint_path=None, threads: int = 0,
               progress=None) -> MsaOutput:
    """Run progressive POA MSA over ``seqs`` (list of byte strings).

    ``width`` is the compat engine's stripe multiplier bS (reference -W,
    default 10; L = 16 * width columns per block).  ``threads`` caps the
    compat engine's OpenMP wavefront (reference -T; 0 = all cores).
    ``progress`` (native engine only): per-round callback
    (done, total) -- the CLI's ``\\r[i/n]`` bar (msa/msa.c:134-138);
    the compat engine runs all rounds inside one C call.
    """
    if not seqs:
        raise ValueError("no sequences")
    for i, s in enumerate(seqs):
        if len(s) == 0:
            raise ValueError("sequence %d is empty" % i)
    if engine == "native":
        from tsta_tpu.ops import msa_native
        return msa_native.align_seqs(seqs, params, mesh=mesh,
                                     checkpoint_path=checkpoint_path,
                                     progress=progress)
    if engine != "compat":
        raise ValueError("unknown MSA engine %r" % engine)
    if mesh is not None:
        raise ValueError("mesh sharding requires engine='native'")
    if checkpoint_path is not None:
        raise ValueError("per-round checkpointing requires "
                         "engine='native'")

    from tsta_tpu.native import build
    lib = build.load()
    n = len(seqs)
    arr = (ctypes.c_char_p * n)(*[bytes(s) for s in seqs])
    lens = (ctypes.c_int * n)(*[len(s) for s in seqs])
    res = build.MsaResultStruct()
    rc = lib.tsta_msa_run(
        ctypes.cast(arr, ctypes.POINTER(ctypes.c_char_p)), lens, n,
        params.match, params.mismatch, params.gap_extend, params.gap_open,
        width, threads, ctypes.byref(res))
    if rc != 0:
        # free the result arrays tsta_msa_run calloc'd before failing
        # (rows/msa/consensus are zero-initialised, so free is safe)
        lib.tsta_msa_free(ctypes.byref(res))
        if rc == -2:
            raise RuntimeError(
                "compat MSA engine: a graph node's in-degree exceeded the "
                "engine's 64-predecessor limit (very many divergent reads); "
                "use engine='native', which has no such limit")
        raise RuntimeError("compat MSA engine failed (rc=%d)" % rc)
    try:
        rows = [ctypes.string_at(res.msa[i]) for i in range(res.rows)]
        out = MsaOutput(
            rows=rows,
            consensus=bytes(res.consensus),
            round_scores=[res.last_scores[i] for i in range(res.rounds)],
            graph_len=[res.graph_len[i] for i in range(res.rounds)],
            add_len=[res.add_len[i] for i in range(res.rounds)],
        )
    finally:
        lib.tsta_msa_free(ctypes.byref(res))
    return out


def align_file(path: str, params: AlignParams = AlignParams(),
               engine: str = "compat", width: int = 10, mesh=None,
               checkpoint_path=None, threads: int = 0,
               progress=None) -> MsaOutput:
    from tsta_tpu.io import read_records
    seqs = [r.sequence for r in read_records(path)]
    return align_seqs(seqs, params, engine=engine, width=width, mesh=mesh,
                      checkpoint_path=checkpoint_path, threads=threads,
                      progress=progress)


def write_result(out: MsaOutput, path: str) -> None:
    """Write MSA rows + consensus in the reference's output format
    (result.c:68-78: '>%d' rows then 'consensus:' with no trailing
    newline)."""
    with open(path, "wb") as f:
        for i, row in enumerate(out.rows):
            f.write(b">%d\n" % (i + 1) + row + b"\n")
        f.write(b"consensus:\n" + out.consensus)
