"""Multi-host progressive MSA: replicated graph, globally column-sharded
DP, per-round alignment-delta broadcast.

The replacement for the reference's shared-memory POA graph
(msa/c-t-simd.c:659-977: every pthread mutates one global graph under a
mutex/spin barrier).  Across hosts there is no shared memory; instead
(SURVEY.md section 5; docs/ARCHITECTURE.md "graph-delta broadcast"):

* the POA graph is REPLICATED per host (host-side numpy, a few MB --
  tiny next to the DP planes) and every host replays identical
  mutations;
* each round's DP is column-sharded over the global ``seq`` mesh axis
  (parallel/msa_longseq.py's ppermute pipeline -- on one host this is
  exactly the single-host long-read path);
* the traceback planes STAY where they were computed: the walk runs
  segment-by-segment from the last column shard towards the first,
  each segment on the process that owns those columns, with the tiny
  (row, state, done) handoff and the running alignment column map
  broadcast between hosts (``multihost_utils.broadcast_one_to_all``) --
  O(process_count) broadcasts of (n,) int32 per round;
* the completed alignment map is the round's graph delta:
  ``PoaGraph.apply_delta`` replays the merge -- a deterministic pure
  function of (graph, read, align map) -- so every host's graph stays
  bit-identical with a few KB of traffic per round and the
  deterministic toposort then yields identical dense tensors for the
  next round with zero further traffic.

With ``jax.process_count() == 1`` every step degenerates to the
single-host column-sharded path (broadcasts become identity), which is
how the fast suite covers this module; the real 2-process rendezvous
runs in tests/test_multihost.py.
"""

from __future__ import annotations

from typing import List

import jax
import numpy as np

from tsta_tpu.config import AlignParams

# walk states (mirrors msa_native._walk_host's "H"/"E"/"F")
_H, _E, _F = 0, 1, 2


def _walk_segment(packed, h_pred, e_pred, preds_t, row, state, j_local):
    """Walk msa_native's 3-state traceback inside one column segment.

    ``packed``/``h_pred``/``e_pred`` are (N, C) plane slices for columns
    [c0, c0+C); ``j_local`` the entry column relative to c0.  Returns
    (align_seg, row, state, done): ``done`` set when the walk ran off
    the virtual row (the remaining new-seq prefix is unaligned).
    """
    C = packed.shape[1]
    align = np.full((C,), -1, np.int64)
    while j_local >= 0:
        if row < 0:
            return align, row, state, True
        if state == _H:
            code = int(packed[row, j_local])
            h_type = code >> 2
            if h_type == 0:
                align[j_local] = row
                row = int(preds_t[row, int(h_pred[row, j_local])]) - 1
                j_local -= 1
            elif h_type == 1:
                state = _E
            else:
                state = _F
        elif state == _E:
            code = int(packed[row, j_local])
            prow = int(preds_t[row, int(e_pred[row, j_local])]) - 1
            state = _E if (code >> 1) & 1 else _H
            row = prow
        else:  # F: new-seq base inserted against a gap
            code = int(packed[row, j_local])
            state = _F if code & 1 else _H
            align[j_local] = -1
            j_local -= 1
    return align, row, state, row < 0


def _local_columns(arr) -> tuple:
    """(c0, c1, data): this process's contiguous column range of a
    (N, n) column-sharded global array, assembled from its addressable
    shards.  Asserts contiguity (mesh construction orders devices by
    process, so each process owns one contiguous block)."""
    shards = sorted(arr.addressable_shards,
                    key=lambda s: s.index[1].start or 0)
    c0 = shards[0].index[1].start or 0
    datas = []
    cur = c0
    for s in shards:
        s0 = s.index[1].start or 0
        assert s0 == cur, "non-contiguous column shards on this process"
        d = np.asarray(s.data)
        cur = s0 + d.shape[1]
        datas.append(d)
    return c0, cur, np.concatenate(datas, axis=1)


def _broadcast(tree, source_proc: int):
    """broadcast_one_to_all from ``source_proc`` (identity 1-process)."""
    if jax.process_count() == 1:
        return tree
    from jax.experimental import multihost_utils
    return multihost_utils.broadcast_one_to_all(
        tree, is_source=jax.process_index() == source_proc)


def _distributed_walk(planes, hpreds, epreds, preds_t, best_row: int,
                      n_real: int) -> np.ndarray:
    """Segment walk over the column-sharded planes; every process
    returns the full (n_real,) alignment column map."""
    c0, c1, pk = _local_columns(planes)
    _, _, hp = _local_columns(hpreds)
    _, _, ep = _local_columns(epreds)
    # every process learns every segment's range (ranges are derived
    # from the sharding, identical everywhere -- no traffic)
    nglob = planes.shape[1]
    ranges = {}
    for dev, idx in planes.sharding.devices_indices_map(
            planes.shape).items():
        s = idx[1]
        s0, s1 = s.start or 0, s.stop if s.stop is not None else nglob
        r = ranges.setdefault(dev.process_index, [s0, s1])
        r[0], r[1] = min(r[0], s0), max(r[1], s1)
    segs = sorted(((v[0], v[1], p) for p, v in ranges.items()),
                  reverse=True)   # walk right-to-left

    align = np.full((nglob,), -1, np.int64)
    row, state, done = best_row, _H, False
    for s0, s1, proc in segs:
        if done or s0 >= n_real:
            # segment entirely past the last real column (or walk done):
            # nothing to do, keep -1s (no broadcast needed -- every
            # process takes this branch identically)
            continue
        if jax.process_index() == proc:
            j_entry = min(n_real - 1, s1 - 1) - c0
            seg, row, state, done = _walk_segment(
                pk, hp, ep, preds_t, row, state, j_entry)
            align[c0:c1] = seg
        align, row, state, done = _broadcast(
            (align, row, state, done), proc)
        align = np.array(align)   # broadcast output is read-only
        row, state = int(row), int(state)
        done = bool(done)
    return align[:n_real]


def align_seqs_multihost(seqs: List[bytes],
                         params: AlignParams = AlignParams(),
                         mesh=None):
    """Progressive POA MSA with the round DP column-sharded over the
    GLOBAL mesh (all hosts' devices) and graph deltas broadcast.

    Every process must call this with identical ``seqs``/``params`` (the
    usual multi-controller SPMD contract).  Returns MsaOutput, identical
    on every host.
    """
    from tsta_tpu.models.msa import MsaOutput
    from tsta_tpu.models.poa_graph import PoaGraph
    from tsta_tpu.parallel import mesh as meshlib
    from tsta_tpu.parallel import msa_longseq

    if mesh is None:
        mesh = meshlib.make_mesh(data=1, seq=len(jax.devices()))
    if not seqs:
        raise ValueError("empty read set")
    g = PoaGraph.from_sequence(seqs[0], len(seqs))
    reads = list(range(1, len(seqs))) if len(seqs) > 1 else [0]
    round_scores, graph_lens, add_lens = [], [], []
    for seq_no in reads:
        seq = bytes(seqs[seq_no])
        (sink, planes, hpreds, epreds, order,
         preds_t, n) = msa_longseq.round_dp_arrays(g, seq, params, mesh)
        # sink scores were pmax'd over the seq axis (replicated values),
        # but the jit's output layout may not be addressable everywhere:
        # gather the small (N,) vector to every host explicitly.
        if jax.process_count() > 1:
            from jax.experimental import multihost_utils
            sink_np = np.asarray(
                multihost_utils.process_allgather(sink, tiled=True))
            if sink_np.ndim > 1:      # tiled gather of a replicated vec
                sink_np = sink_np.reshape(-1)[:sink.shape[0]]
        else:
            sink_np = np.asarray(sink)
        sink_np = sink_np[:len(order)]
        sinks = set(g.sinks())
        sink_rows = [i for i, v in enumerate(order) if v in sinks]
        best_row = max(sink_rows, key=lambda i: int(sink_np[i]))
        align = _distributed_walk(planes, hpreds, epreds, preds_t,
                                  best_row, len(seq))
        round_scores.append(int(sink_np[best_row]))
        add_lens.append(g.apply_delta(seq, seq_no, order, align))
        graph_lens.append(len(g))
        g.toposort()
    return MsaOutput(rows=g.msa_rows(), consensus=g.consensus(),
                     round_scores=round_scores, graph_len=graph_lens,
                     add_len=add_lens)
