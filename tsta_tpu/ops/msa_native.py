"""Native MSA engine: exact int32 POA DP in JAX.

The scalable counterpart of the bit-exact C compat engine
(native/compat_msa.c).  Per round, the DP over (graph rows x new-sequence
columns) runs on device as a ``lax.scan`` over topo-ordered graph rows;
each step gathers the H/E rows of the node's predecessors, applies the
exact affine POA recurrence, and resolves the in-row F dependency with
the same closed-form prefix-max as the PSA kernels (see
ops/psa_scan.py)::

    E(v,j) = max_p max(E(p,j) + e, H(p,j) + o + e)
    F(v,j) = o + j*e + max_{k<j}(C(k) - k*e),  C = max(diag, E)
    H(v,j) = max(max_p H(p,j-1) + sub(v, a_j), E(v,j), F(v,j))

with boundary H(v,-1) = o + (depth(v)+1) e (depth = shortest pred chain,
matching the reference's ``frist_col_sorce`` +E chain, c-t-simd.c:196-199)
and a virtual row H(-1,j) = o + (j+1)e for source nodes.

Differences vs the compat engine (by design -- this engine is *exact*):
no int8 saturation, no Logo/ogap clamps, no carry ladder.  On inputs
where the reference's clamps never fire the round scores coincide; for 2
sequences the round score equals the pairwise Gotoh corner score (tested
against ops/psa_scan).

Graph fusion, topological sorting, consensus, and row emission live on
the host (models/poa_graph.py); fusion walks a 3-state (H/E/F) textbook
traceback from packed device planes.
"""

from __future__ import annotations

import functools
from typing import List

import jax
import jax.numpy as jnp
import numpy as np

from tsta_tpu.config import AlignParams
from tsta_tpu.models.poa_graph import PoaGraph
from tsta_tpu.ops import route
from tsta_tpu.ops.psa_scan import NEG, bucket


_AMB_WARNED = False


def _warn_ambiguity(seqs) -> None:
    """One-time warning for ambiguity codes (any non-ACGT byte).

    The reference scores read-'N' columns as score-neutral through its
    difference normalisation (SN blend, c-t-simd.c:461,481) -- a
    path-dependent rule the bit-exact compat engine reproduces
    byte-for-byte (differential fuzz incl. N inputs,
    test_fuzz_vs_reference).  The native engine's contract is the
    clean exact recurrence, which scores N like any other mismatching
    byte, so N-heavy reads score differently between the engines; point
    users at engine='compat' when reference parity on such reads
    matters."""
    global _AMB_WARNED
    if _AMB_WARNED:
        return
    acgt = frozenset(b"ACGT")
    if any(set(bytes(s)) - acgt for s in seqs):
        from tsta_tpu.utils.logging import get_logger
        get_logger().warning(
            "input contains ambiguity codes (non-ACGT): the native "
            "engine scores them as ordinary mismatches; use "
            "engine='compat' for the reference's score-neutral 'N' "
            "handling")
        _AMB_WARNED = True


@functools.partial(jax.jit, static_argnames=("params", "N", "n", "max_in"))
def _round_dp(bases, preds, pmask, hm1, valid, a, n_real, params, N, n,
              max_in):
    """One MSA round: returns per-node sink scores + traceback planes.

    bases:(N,) preds:(N,max_in) [buffer row ids, 0=virtual] pmask bool,
    hm1:(N+1,) col(-1) boundary per buffer row, valid:(N,), a:(n,) uint8.
    """
    m_, x_, e_, o_ = (jnp.int32(params[0]), jnp.int32(params[1]),
                      jnp.int32(params[2]), jnp.int32(params[3]))
    a = a.astype(jnp.int32)
    j_idx = jnp.arange(n, dtype=jnp.int32)
    # buffer row 0 = virtual boundary row H(-1,j) = o + (j+1)e
    h_virtual = o_ + (j_idx + 1) * e_
    # rows 1..N hold the topo rows; row N+1 is a dump row that padded
    # (invalid) rows write to, so every step updates the carry
    # unconditionally and XLA can update it in place
    Hbuf0 = jnp.full((N + 2, n), NEG, jnp.int32).at[0].set(h_virtual)
    Ebuf0 = jnp.full((N + 2, n), NEG, jnp.int32)

    def step(carry, xs):
        Hbuf, Ebuf = carry
        i, base, pr, pm, hv_m1 = xs
        Hp = jnp.take(Hbuf, pr, axis=0)          # (max_in, n)
        Ep = jnp.take(Ebuf, pr, axis=0)
        pm_col = pm[:, None]
        Hm1p = jnp.take(hm1, pr)                 # H(p, -1) per pred

        sub = jnp.where(a == base, m_, x_)
        diag_p = jnp.concatenate([Hm1p[:, None], Hp[:, :-1]], axis=1)
        diag_p = jnp.where(pm_col, diag_p, NEG)
        diag_best = jnp.max(diag_p, axis=0)
        h_pred = jnp.argmax(diag_p, axis=0).astype(jnp.int8)
        diag = diag_best + sub

        e_cand = jnp.maximum(Ep + e_, Hp + (o_ + e_))
        e_cand = jnp.where(pm_col, e_cand, NEG)
        e_row = jnp.max(e_cand, axis=0)
        e_pred = jnp.argmax(e_cand, axis=0).astype(jnp.int8)
        # extend if the winning candidate came from Ep + e
        e_ext = (jnp.take_along_axis(
            Ep + e_, e_pred[None].astype(jnp.int32), axis=0)[0] == e_row)

        c = jnp.maximum(diag, e_row)
        g = jnp.concatenate([jnp.full((1,), hv_m1 + e_, jnp.int32),
                             c[:-1] - j_idx[:-1] * e_])
        p = jax.lax.cummax(g)
        f_row = o_ + j_idx * e_ + p
        h_row = jnp.maximum(c, f_row)
        # F extend test: F(v,j) == F(v,j-1) + e
        f_prev = jnp.concatenate([jnp.full((1,), NEG, jnp.int32),
                                  f_row[:-1]])
        f_ext = f_row == f_prev + e_

        # precedence: diagonal > E > F
        h_type = jnp.where(h_row == diag, jnp.int32(0),
                           jnp.where(h_row == e_row, jnp.int32(1),
                                     jnp.int32(2)))

        row_id = jnp.where(valid[i], i + 1, N + 1)
        Hbuf = jax.lax.dynamic_update_slice(Hbuf, h_row[None], (row_id, 0))
        Ebuf = jax.lax.dynamic_update_slice(Ebuf, e_row[None], (row_id, 0))
        sink_score = h_row[n_real - 1]
        packed = (h_type * 4 + e_ext.astype(jnp.int32) * 2
                  + f_ext.astype(jnp.int32)).astype(jnp.int8)
        return (Hbuf, Ebuf), (sink_score, packed, h_pred, e_pred)

    xs = (jnp.arange(N, dtype=jnp.int32), bases, preds, pmask,
          jnp.take(hm1, jnp.arange(1, N + 1)))
    (_, _), (sink_scores, packed, h_pred, e_pred) = jax.lax.scan(
        step, (Hbuf0, Ebuf0), xs)
    return sink_scores, packed, h_pred, e_pred


def _prepare_round(g: PoaGraph, params: AlignParams):
    """Dense per-round tensors from the host graph (topo order)."""
    order = g.topo
    N_real = len(order)
    pos = {v: i for i, v in enumerate(order)}  # node -> topo row
    max_in = max(1, g.max_in_degree())
    N = bucket(N_real)
    preds = np.zeros((N, max_in), np.int32)
    pmask = np.zeros((N, max_in), bool)
    bases = np.zeros((N,), np.int32)
    hm1 = np.full((N + 1,), NEG, np.int64)
    hm1[0] = 0  # virtual H(-1,-1)
    e_, o_ = params.gap_extend, params.gap_open
    g_bases, g_ndeg, g_preds = g._bases, g._ndeg, g._preds
    for i, v in enumerate(order):
        bases[i] = g_bases[v]
        k = int(g_ndeg[v])
        if not k:
            preds[i, 0] = 0  # virtual row
            pmask[i, 0] = True
            hm1[i + 1] = o_ + e_
        else:
            rows = [pos[int(pv)] + 1 for pv in g_preds[v, :k]]
            preds[i, :k] = rows
            pmask[i, :k] = True
            hm1[i + 1] = max(hm1[r] for r in rows) + e_
    valid = np.zeros((N,), bool)
    valid[:N_real] = True
    return (bases, preds, pmask, hm1.astype(np.int32), valid, N, N_real,
            max_in, pos, order)


def _walk_host(packed, h_pred, e_pred, preds_tensor, best_row: int,
               n: int):
    """Host 3-state traceback walk -> per-position aligned node row
    (-1 for gap/insertion)."""
    align = np.full((n,), -1, np.int64)
    state = "H"
    row, j = best_row, n - 1
    while j >= 0:
        if row < 0:  # ran off the virtual row: rest is a prefix
            break
        if state == "H":
            code = int(packed[row, j])
            h_type = code >> 2
            if h_type == 0:
                align[j] = row
                prow = int(preds_tensor[row, int(h_pred[row, j])]) - 1
                row, j = prow, j - 1
            elif h_type == 1:
                state = "E"
            else:
                state = "F"
        elif state == "E":
            code = int(packed[row, j])
            prow = int(preds_tensor[row, int(e_pred[row, j])]) - 1
            state = "E" if (code >> 1) & 1 else "H"
            row = prow
        else:  # F: new-seq base j inserted against a gap
            code = int(packed[row, j])
            state = "F" if code & 1 else "H"
            align[j] = -1
            j -= 1
    return align


def _merge(g: PoaGraph, seq: bytes, seq_no: int, order,
           align_rows) -> int:
    """Merge ``seq`` into the graph given the per-position aligned node
    rows (from either the host or device walk).  Returns nodes added.

    The loop is the hot host path of long-read rounds (~0.3 s/round at
    200 kbp before the graph's array-backed storage landed); it now
    runs in C (native/poa_fast.c tsta_poa_merge) directly on the
    graph's buffers, with the Python loop below kept as the semantics
    reference and fallback (TSTA_NATIVE_MERGE=0 opts out; fuzz-asserted
    identical in tests/test_msa_native.py).  Capacity is pre-grown so
    the C pass never reallocates: a merge adds at most len(seq) nodes
    and grows any single node's in-degree / variant ring by at most 1
    (each alignment column is consumed once per round)."""
    import os
    n = len(seq)
    before = len(g)
    ar = np.asarray(align_rows, np.int64)
    if ar.shape[0] != n:
        raise ValueError("align_rows length != len(seq)")
    if int(ar.max(initial=-1)) >= len(order):
        # loud, not clamped: a row past the real node count means the
        # device walk emitted a padded/bucketed row -- clamping would
        # merge the base into the wrong column and silently corrupt
        # every later round
        raise ValueError("align_rows contains topo row %d >= %d nodes"
                         % (int(ar.max()), len(order)))
    if len(order):
        order_arr = np.asarray(order, np.int64)
        align = np.where(ar >= 0, order_arr[np.maximum(ar, 0)],
                         np.int64(-1))
    else:
        align = np.full(n, -1, np.int64)
    # pre-grow so the C pass never reallocates.  A VALID alignment
    # path consumes each graph column at most once (in-degree / ring
    # growth <= 1 per node per round), but the bound is derived from
    # ``align`` itself so arbitrary align_rows (fuzz, foreign deltas)
    # are also safe: the max per-variant-group hit count bounds both
    # the new pred slots any node can gain and its column's ring
    # growth.  Pathological inputs (one column hit many times) would
    # blow the padded buffers up, so extra > 8 routes to the Python
    # loop below, which grows on demand instead.
    if before and n:
        hit = align[align >= 0]
        if hit.size:
            vn = g._nvar[:before].astype(np.int64)
            vmask = np.arange(g._vars.shape[1]) < vn[:, None]
            ring_min = np.where(vmask, g._vars[:before],
                                before).min(axis=1)
            gid = np.minimum(np.arange(before, dtype=np.int64),
                             ring_min)
            extra = int(np.bincount(gid[hit],
                                    minlength=before).max(initial=0))
        else:
            extra = 0
    else:
        extra = 1 if n else 0
    extra = max(extra, 1)
    g._grow(n_cap=before + n,
            pmax=g.max_in_degree() + min(extra, 8),
            vmax=int(g._nvar[:before].max(initial=0)) + min(extra, 8))
    seq_arr = (np.frombuffer(bytes(seq), np.uint8)
               if isinstance(seq, (bytes, bytearray))
               else np.asarray(list(seq), np.uint8))
    g._csr = None
    g._succs = None
    if (extra <= 8
            and os.environ.get("TSTA_NATIVE_MERGE", "1")
            not in ("", "0")):
        added = _merge_native(g, seq_arr, seq_no, align)
        if added >= 0:
            g._n = before + added
            return added
    bases = g._bases
    ndeg = g._ndeg
    passing = g._passing
    nvar = g._nvar
    vars_ = g._vars
    nn = before
    prev = -1
    for jj in range(n):
        v = int(align[jj])
        ch = int(seq_arr[jj])
        if v >= 0:
            if bases[v] == ch:
                passing[v, seq_no] = True
                # preds/weights via the graph: _edge_py may reallocate
                # them when a non-path align forces pred-slot growth
                if ndeg[v] and g._preds[v, 0] == prev:  # chain edge
                    g._weights[v, 0] += 1
                else:
                    _edge_py(g, prev, v)
                prev = v
                continue
            # mismatch: reuse an aligned variant with this base or create
            k = int(nvar[v])
            ring = vars_[v, :k].copy()
            cand = -1
            for w in ring:
                if bases[w] == ch:
                    cand = int(w)
                    break
            if cand < 0:
                w = nn
                nn += 1
                g._n = nn   # keep _n current: an on-demand _grow below
                #             copies only rows [:_n]
                bases[w] = ch
                # new node's ring = [v] + v's ring; register w in every
                # member's ring.  Grow on demand (only reachable for
                # non-path align_rows -- the pre-grow covers valid
                # alignments) and re-bind the reallocated buffers.
                if k + 1 >= vars_.shape[1]:
                    g._grow(vmax=k + 2)
                    nvar, vars_ = g._nvar, g._vars
                vars_[w, 0] = v
                vars_[w, 1:k + 1] = ring
                nvar[w] = k + 1
                vars_[v, k] = w
                nvar[v] = k + 1
                for r in ring:
                    kr = int(nvar[r])
                    if kr >= vars_.shape[1]:
                        g._grow(vmax=kr + 1)
                        nvar, vars_ = g._nvar, g._vars
                    vars_[r, kr] = w
                    nvar[r] = kr + 1
                v = w
            else:
                v = cand
        else:
            v = nn
            nn += 1
            g._n = nn
            bases[v] = ch
        passing[v, seq_no] = True
        _edge_py(g, prev, v)
        prev = v
    g._n = nn
    return nn - before


def _edge_py(g: PoaGraph, src: int, dst: int) -> None:
    """add_edge without cache invalidation (the merge invalidates
    once); grows pred slots on demand (only reachable for non-path
    align_rows -- the pre-grow covers valid alignments)."""
    if src < 0:
        return
    nd = int(g._ndeg[dst])
    row = g._preds[dst]
    for k in range(nd):
        if row[k] == src:
            g._weights[dst, k] += 1
            return
    if nd >= g._preds.shape[1]:
        g._grow(pmax=nd + 1)
        row = g._preds[dst]
    row[nd] = src
    g._weights[dst, nd] = 1
    g._ndeg[dst] = nd + 1


def _merge_native(g: PoaGraph, seq_arr: np.ndarray, seq_no: int,
                  align: np.ndarray) -> int:
    """C merge over the graph's buffers; returns nodes added or -1
    (library unavailable -- the caller falls back to the Python loop).
    A capacity breach inside C (impossible given the pre-grow
    invariant) raises instead of corrupting the buffers."""
    try:
        from tsta_tpu.native.build import load_poa
        lib = load_poa()
    except Exception:  # pragma: no cover - toolchain-less host
        return -1
    import ctypes
    added = lib.tsta_poa_merge(
        len(g), g._bases.shape[0],
        g._preds.shape[1], g._vars.shape[1],
        g._bases.ctypes.data_as(ctypes.POINTER(ctypes.c_ubyte)),
        g._ndeg.ctypes.data_as(ctypes.POINTER(ctypes.c_int)),
        g._preds.ctypes.data_as(ctypes.POINTER(ctypes.c_int)),
        g._weights.ctypes.data_as(ctypes.POINTER(ctypes.c_int)),
        g._passing.ctypes.data_as(ctypes.POINTER(ctypes.c_ubyte)),
        g.n_seq, seq_no,
        g._nvar.ctypes.data_as(ctypes.POINTER(ctypes.c_int)),
        g._vars.ctypes.data_as(ctypes.POINTER(ctypes.c_int)),
        seq_arr.ctypes.data_as(ctypes.POINTER(ctypes.c_ubyte)),
        seq_arr.shape[0],
        np.ascontiguousarray(align, np.int64).ctypes.data_as(
            ctypes.POINTER(ctypes.c_long)))
    if added == -2:  # pragma: no cover - guarded by the pre-grow
        raise RuntimeError(
            "tsta_poa_merge capacity breach: the alignment consumed a "
            "graph column more than once (invalid align_rows?)")
    return int(added)


def _fuse(g: PoaGraph, seq: bytes, seq_no: int, order, packed, h_pred,
          e_pred, preds_tensor, best_row: int) -> int:
    """Walk the 3-state traceback and merge ``seq`` into the graph.

    Returns the number of nodes added.
    """
    align_rows = _walk_host(packed, h_pred, e_pred, preds_tensor,
                            best_row, len(seq))
    return _merge(g, seq, seq_no, order, align_rows)


def round_bytes(N: int, n: int) -> int:
    """Device bytes one scan-engine round holds: the H and E row buffers
    (int32, N+2 rows) and the three int8 traceback planes it returns."""
    return 2 * 4 * (N + 2) * n + 3 * N * n


def _check_round_fits(N: int, n: int) -> None:
    """Refuse a round that cannot fit the device before it allocates."""
    free = route.device_bytes_free()
    need = round_bytes(N, n)
    if free is not None and need > free:
        raise ValueError(
            "a native MSA round over %d graph rows x %d columns needs "
            "%.1f GB of device memory but %.1f GB are free; use "
            "engine='compat' (the C engine on the host) for this input"
            % (N, n, need / 1e9, free / 1e9))


def _dispatch_round(g: PoaGraph, seq: bytes, params: AlignParams):
    """Start one round of DP on the device (asynchronously); returns the
    device results (sink scores, packed, h_pred, e_pred) and the host
    (preds, order) the walk needs."""
    p = (params.match, params.mismatch, params.gap_extend,
         params.gap_open)
    (bases, preds, pmask, hm1, valid, N, N_real, max_in, pos,
     order) = _prepare_round(g, params)
    n_real = len(seq)
    n = bucket(n_real)
    _check_round_fits(N, n)
    a = np.zeros((n,), np.uint8)
    a[:n_real] = np.frombuffer(seq, np.uint8)
    outs = _round_dp(
        jnp.asarray(bases), jnp.asarray(preds), jnp.asarray(pmask),
        jnp.asarray(hm1), jnp.asarray(valid), jnp.asarray(a),
        jnp.int32(n_real), p, N, n, max_in)
    return outs, preds, order


def _scan_engine_round(g: PoaGraph, seq: bytes, params: AlignParams):
    """One round of DP via the per-node scan engine; returns the dense
    results in the walk/fuse consumption layout."""
    outs, preds, order = _dispatch_round(g, seq, params)
    return tuple(np.asarray(x) for x in outs) + (preds, order)


def _select_and_fuse(g: PoaGraph, seq: bytes, seq_no: int, sink_scores,
                     packed, h_pred, e_pred, preds, order):
    """Pick the best sink and merge the read; returns (score, added)."""
    sinks = set(g.sinks())
    sink_rows = [i for i, v in enumerate(order) if v in sinks]
    best_row = max(sink_rows, key=lambda i: sink_scores[i])
    added = _fuse(g, seq, seq_no, order, packed, h_pred, e_pred, preds,
                  best_row)
    return int(sink_scores[best_row]), added


def align_seqs(seqs: List[bytes], params: AlignParams = AlignParams(),
               checkpoint_path: str | None = None, mesh=None,
               progress=None):
    """Progressive POA MSA, device DP per round (native engine).

    With ``checkpoint_path``, the graph is snapshotted after every round
    (npz) and a matching snapshot resumes the run mid-way -- the
    reference restarts multi-hour progressive alignments from scratch
    (SURVEY.md section 5).  ``progress`` (callable taking
    (done_rounds, total_rounds)) is invoked after each round -- the CLI
    wires it to the reference's ``\\r[i/n]`` bar (msa/msa.c:134-138).
    """
    from tsta_tpu.models.msa import MsaOutput
    from tsta_tpu.models.poa_graph import load_graph, save_graph
    from tsta_tpu.utils.checkpoint import seqs_digest

    if not seqs:
        raise ValueError("no sequences")
    _warn_ambiguity(seqs)
    n_seq = len(seqs)
    digest = seqs_digest(seqs)
    g = PoaGraph.from_sequence(seqs[0], n_seq)
    p = (params.match, params.mismatch, params.gap_extend, params.gap_open)
    round_scores, graph_lens, add_lens = [], [], []
    reads = list(range(1, n_seq)) if n_seq > 1 else [0]
    if n_seq < 2:
        checkpoint_path = None  # degenerate self-alignment: nothing to resume
    if checkpoint_path:
        import os
        if os.path.exists(checkpoint_path):
            g2, extra = load_graph(checkpoint_path)
            if extra.get("digest") == digest and extra.get("params") == \
                    list(p):
                g = g2
                round_scores = extra["round_scores"]
                graph_lens = extra["graph_len"]
                add_lens = extra["add_len"]
                reads = reads[extra["next_read_idx"]:]
    # total rounds: normally len(seqs)-1, but a single-sequence input
    # still runs one self-alignment round (reads == [0])
    n_rounds = max(len(seqs) - 1, len(reads))
    for read_idx, seq_no in enumerate(reads):
        seq = seqs[seq_no]
        if progress is not None:
            progress(n_rounds - len(reads) + read_idx, n_rounds)
        if mesh is not None:
            # long-read path: columns sharded over the mesh 'seq' axis
            from tsta_tpu.parallel import msa_longseq
            (sink_scores, packed, h_pred, e_pred, order,
             preds) = msa_longseq.round_dp(g, bytes(seq), params, mesh)
        else:
            (sink_scores, packed, h_pred, e_pred, preds,
             order) = _scan_engine_round(g, bytes(seq), params)
        score, added = _select_and_fuse(
            g, bytes(seq), seq_no, sink_scores, packed, h_pred, e_pred,
            preds, order)
        round_scores.append(score)
        add_lens.append(added)
        graph_lens.append(len(g))
        g.toposort()
        if checkpoint_path:
            save_graph(checkpoint_path, g, extra={
                "digest": digest, "params": list(p),
                "round_scores": round_scores, "graph_len": graph_lens,
                "add_len": add_lens,
                "next_read_idx": read_idx + 1 + (len(seqs) - 1
                                                - len(reads))})
    if progress is not None:
        progress(n_rounds, n_rounds)
    return MsaOutput(rows=g.msa_rows(), consensus=g.consensus(),
                     round_scores=round_scores, graph_len=graph_lens,
                     add_len=add_lens)


def align_seqs_many(seq_sets: List[List[bytes]],
                    params: AlignParams = AlignParams()):
    """Progressive MSA of MANY independent read sets, pipelined so host
    graph fusion overlaps device DP.

    The reference's Amdahl bottleneck is the serial host fraction
    (node_fuse + t_sort, SURVEY.md section 3.3).  Within ONE progressive
    MSA that serialization is a true data dependency -- round r+1's DP
    runs on the graph produced by round r's fusion, so it cannot be
    dispatched early.  Across independent problems it is not: every
    problem's round is dispatched to the device asynchronously, and while
    problem i's fusion runs on the host, the rounds of problems i+1.. run
    on the device.

    Returns a list of MsaOutput in input order; each equals
    ``align_seqs`` on that read set alone.
    """
    from tsta_tpu.models.msa import MsaOutput

    states = []
    for seqs in seq_sets:
        if not seqs:
            raise ValueError("empty read set")
        _warn_ambiguity(seqs)
        reads = list(range(1, len(seqs))) if len(seqs) > 1 else [0]
        states.append({
            "seqs": seqs,
            "g": PoaGraph.from_sequence(seqs[0], len(seqs)),
            "reads": reads, "next": 0,
            "scores": [], "glen": [], "alen": [],
            "pending": None,
        })

    def dispatch(st):
        seq_no = st["reads"][st["next"]]
        seq = bytes(st["seqs"][seq_no])
        st["pending"] = (seq_no, seq,
                         _dispatch_round(st["g"], seq, params))

    for st in states:
        dispatch(st)
    while any(st["pending"] is not None for st in states):
        for st in states:
            if st["pending"] is None:
                continue
            seq_no, seq, (outs, preds, order) = st["pending"]
            st["pending"] = None
            g = st["g"]
            score, added = _select_and_fuse(
                g, seq, seq_no, *(np.asarray(x) for x in outs), preds,
                order)
            st["scores"].append(score)
            st["alen"].append(added)
            st["glen"].append(len(g))
            g.toposort()
            st["next"] += 1
            if st["next"] < len(st["reads"]):
                dispatch(st)   # the device works on this while we fuse others

    return [MsaOutput(rows=st["g"].msa_rows(),
                      consensus=st["g"].consensus(),
                      round_scores=st["scores"], graph_len=st["glen"],
                      add_len=st["alen"]) for st in states]
