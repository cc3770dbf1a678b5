"""Batched PSA: many pairs, data-parallel over devices.

The reference aligns one pair per process.  Here pairs are bucketed by
padded shape (one compilation per bucket) and stacked.  The engine comes
from ``ops/route.py``: on a GPU each stack runs in the CUDA kernel
(``ops/psa_cuda.py``, one thread block per pair); on the CPU it runs
through a ``vmap`` of the row-scan oracle.  With a mesh the batch
dimension is sharded over the ``data`` axis -- the kernel inside
``shard_map``, the scan under ``NamedSharding``.  Pairs are independent,
so neither needs a collective (SURVEY.md section 7 stage 4).
"""

from __future__ import annotations

import functools
import os
from typing import NamedTuple, Optional, Sequence, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from tsta_tpu.config import AlignParams
from tsta_tpu.io import encode_dna, read_first_record
from tsta_tpu.ops import psa_scan, route, traceback
from tsta_tpu.ops.psa_scan import A_PAD, B_PAD, bucket
from tsta_tpu.parallel import mesh as meshlib

# Traced groups are sized so that one group's planes stay under this many
# bytes: the host walk copies a whole group's planes at once.  A pair whose
# planes alone are larger runs as a group of one.
TRACED_GROUP_BYTES = 4 << 30


class TracedResult(NamedTuple):
    score: int                   # max over all H cells
    last: int                    # H(m-1, n-1): the global alignment score
    aln: traceback.Alignment


def stride_for_process(items: list) -> list:
    """Multi-host input scatter: this process's strided slice of an
    already-filtered input list, per TSTA_NUM_PROCESSES /
    TSTA_PROCESS_ID.  Shared by ``align_manifest`` and ``tsta
    msa-batch`` so identical env settings partition identically."""
    n_proc = int(os.environ.get("TSTA_NUM_PROCESSES", "1"))
    proc_id = int(os.environ.get("TSTA_PROCESS_ID", "0"))
    if n_proc <= 1:
        return items
    return items[proc_id::n_proc]


@functools.partial(jax.jit, static_argnames=("params", "n", "m", "traced"))
def _batch_scan(a_stack, b_stack, n_reals, m_reals, params, n, m, traced):
    def one(a, b, nr, mr):
        return psa_scan._psa_scan(a, b, nr, mr, params, n, m, traced)
    return jax.vmap(one)(a_stack, b_stack, n_reals, m_reals)


def _pad_stack(seqs: Sequence[np.ndarray], width: int, fill: int
               ) -> np.ndarray:
    out = np.full((len(seqs), width), fill, np.uint8)
    for i, s in enumerate(seqs):
        out[i, :len(s)] = s
    return out


def _traced_group_size(n: int, m: int, n_data: int, plane_bytes: int
                       ) -> int:
    """Pairs per traced group for an (m, n) bucket whose traceback takes
    ``plane_bytes`` per cell; refuses a pair whose planes cannot fit the
    device before anything is allocated."""
    plane = plane_bytes * n * m
    free = route.device_bytes_free()
    if free is not None and plane > free * 4 // 5:
        raise ValueError(
            "a traced alignment of %d x %d needs %.1f GB of traceback "
            "planes but the device has %.1f GB free; align this pair "
            "score-only (--notrace)" % (m, n, plane / 1e9, free / 1e9))
    return max(1, TRACED_GROUP_BYTES // plane) * n_data


def align_batch(pairs: Sequence[Tuple[np.ndarray, np.ndarray]],
                params: AlignParams = AlignParams(),
                traced: bool = False,
                mesh=None,
                swap: bool = True,
                kernel: str = "auto") -> list:
    """Align a list of (a, b) byte-array pairs.

    Returns, in input order, a ``psa_scan.PsaResult`` (score, last) per
    pair, or a :class:`TracedResult` (score, last, aln) when
    ``traced``.  Pairs are grouped into shape buckets; each group is
    padded to the mesh's data-axis size so every device holds an equal
    shard.  With ``swap`` the longer sequence of a pair is the horizontal
    one, as in the reference (psa.c:194-199).  ``kernel``: 'auto', 'scan'
    or 'cuda' (``ops/route.psa_engine``).
    """
    p = (params.match, params.mismatch, params.gap_extend, params.gap_open)
    engine = route.psa_engine(kernel)
    if engine == "scan" and not (p[0] > 0 and p[1] < 0 and p[2] < 0
                                 and p[3] <= 0):
        # the scan pads every pair to a common bucket shape; padding is
        # only score-neutral when every pad move strictly decreases the
        # score.  Exotic parameter sets are exact via the unpadded
        # single-pair path (ops/psa_scan.psa_align).  The CUDA kernel
        # stops at each pair's real lengths, so padding never enters it.
        raise ValueError("batch alignment requires M>0>X, E<0, O<=0 "
                         "(got %s); align exotic parameter sets "
                         "pair-by-pair with psa_scan.psa_align" % (p,))
    prepped = []
    for a, b in pairs:
        a = encode_dna(a)
        b = encode_dna(b)
        if swap and b.shape[0] > a.shape[0]:
            a, b = b, a
        prepped.append((a, b))

    buckets = {}
    for idx, (a, b) in enumerate(prepped):
        key = (bucket(a.shape[0]), bucket(b.shape[0]))
        buckets.setdefault(key, []).append(idx)

    n_data = 1 if mesh is None else mesh.shape["data"]
    results: list = [None] * len(prepped)
    for (n, m), idxs in buckets.items():
        # the kernel packs a cell into one byte, the scan into three
        size = (_traced_group_size(n, m, n_data,
                                   1 if engine == "cuda" else 3)
                if traced else len(idxs))
        for g0 in range(0, len(idxs), size):
            group = idxs[g0:g0 + size]
            for i, res in zip(group, _align_group(
                    [prepped[i] for i in group], p, n, m, traced, mesh,
                    n_data, engine)):
                results[i] = res
    return results


def _align_group(group, p, n, m, traced, mesh, n_data, engine):
    """One padded stack through the chosen engine."""
    stack = list(group)
    while len(stack) % n_data:       # pad to a multiple of the data axis
        stack.append(group[0])
    a_stack = _pad_stack([a for a, _ in stack], n, A_PAD)
    b_stack = _pad_stack([b for _, b in stack], m, B_PAD)
    lens = np.array([(a.shape[0], b.shape[0]) for a, b in stack], np.int32)
    if engine == "cuda":
        from tsta_tpu.ops import psa_cuda
        out = psa_cuda.align_stack(a_stack, b_stack, lens, p, traced, mesh)
    else:
        args = [jnp.asarray(a_stack), jnp.asarray(b_stack),
                jnp.asarray(lens[:, 0]), jnp.asarray(lens[:, 1])]
        if mesh is not None:
            sharding = meshlib.data_sharding(mesh)
            args = [jax.device_put(x, sharding) for x in args]
        out = _batch_scan(*args, p, n, m, traced)
    best, corner = np.asarray(out[0]), np.asarray(out[1])
    if not traced:
        return [psa_scan.PsaResult(int(best[k]), int(corner[k]))
                for k in range(len(group))]
    if engine == "cuda":
        alns = traceback.walk_planes(out[2], lens, stack,
                                     route.walk_engine(len(stack), m, n))
    else:
        back, fback, eback = (np.asarray(x) for x in out[2:])
        alns = [traceback.decode_pair(back[k, :mr, :nr], fback[k, :mr, :nr],
                                      eback[k, :mr, :nr], a, b)
                for k, ((a, b), (nr, mr)) in enumerate(zip(group, lens))]
    return [TracedResult(int(best[k]), int(corner[k]), alns[k])
            for k in range(len(group))]


def align_manifest(manifest_path: str, params: AlignParams = AlignParams(),
                   traced: bool = False, out_dir: Optional[str] = None,
                   mesh=None, resume: Optional[str] = None):
    """Align pairs listed in a TSV manifest (name, fasta1, fasta2).

    With ``resume``, results stream into a JSONL store and pairs already
    recorded there are skipped -- a preempted job restarts at pair
    granularity (the reference restarts from scratch; SURVEY.md sec. 5).
    """
    store = None
    if resume:
        from tsta_tpu.utils.checkpoint import ShardedResults
        store = ShardedResults(resume)

    names, pairs, skipped = [], [], []
    with open(manifest_path) as f:
        rows = [ln.strip() for ln in f]
    rows = [ln for ln in rows if ln and not ln.startswith("#")]
    # multi-host: each process takes a strided slice of the manifest
    # (host-level input scatter; results merge via the shared resume
    # store or per-host score files).  Striding happens AFTER
    # comment/blank filtering, matching `tsta msa-batch` (see
    # stride_for_process) -- identical env settings partition identical
    # logical inputs on both tools.
    for line in stride_for_process(rows):
        name, f1, f2 = line.split("\t")[:3]
        if store is not None and store.done(name):
            skipped.append(store.get(name))
            continue
        r1 = read_first_record(f1)
        r2 = read_first_record(f2)
        if r1 is None or r2 is None:
            raise ValueError("manifest pair %r: empty sequence input"
                             % name)
        names.append(name)
        pairs.append((r1.sequence, r2.sequence))
    results = align_batch(pairs, params, traced=traced, mesh=mesh)
    rows = list(skipped)
    for name, (a, b), res in zip(names, pairs, results):
        row = {"name": name, "score": int(res.score),
               "corner": int(res.last), "cells": len(a) * len(b)}
        if traced and out_dir:
            os.makedirs(out_dir, exist_ok=True)
            with open(os.path.join(out_dir, name + ".txt"), "wb") as fo:
                fo.write(b">1\n" + res.aln.a_row + b"\n>2\n" + res.aln.b_row)
        if store is not None:
            store.record(row)
        rows.append(row)
    return rows
