"""Decoding of PSA traceback planes into an aligned pair (host or device).

Port of the reference's sequential two-pass ``trace()`` walk
(psa/psa.c:434-519), operating on natural-layout (row-major) planes instead
of the reference's striped NUM2 layout.  The decode rules -- including the
affine open/extend *propagation* writes into the ``back`` plane that force a
gap run to continue through open/extend ties -- are reproduced exactly so
the emitted alignment is byte-identical to the reference's output file.

Moves at cell (i, j) with rows = b, columns = a:
  back == 1 -> diagonal (consume a[j] and b[i])
  back == 0 -> left     (consume a[j], gap in b)
  back == 2 -> up       (consume b[i], gap in a)

Gap-run propagation (psa/psa.c:450-459): on a left move, if ``fback`` marks
an extended gap (+-1), or an opened gap (+-2) whose predecessor cell carries
a negative (open==extend tie) mark, the previous column is forced to also
take a left move; symmetrically for up moves via ``eback``.
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np


class Alignment(NamedTuple):
    a_row: bytes   # aligned sequence a (columns; '>1' in reference output)
    b_row: bytes   # aligned sequence b (rows; '>2')


def decode_pair(back: np.ndarray, fback: np.ndarray, eback: np.ndarray,
                a: np.ndarray, b: np.ndarray) -> Alignment:
    """Walk the planes from (m-1, n-1) and emit the aligned pair."""
    back = np.array(back, dtype=np.int8, copy=True)  # mutated during walk
    m, n = back.shape
    if a.shape[0] < n or b.shape[0] < m:
        raise ValueError("sequence shorter than traceback plane")
    i, j = m - 1, n - 1
    out_a = bytearray()
    out_b = bytearray()
    gap = ord("-")
    while i >= 0 and j >= 0:
        d = back[i, j]
        if d == 1:
            out_a.append(a[j])
            out_b.append(b[i])
            i -= 1
            j -= 1
        elif d == 0:
            fb = fback[i, j]
            if j - 1 >= 0 and (fb == 1 or fb == -1 or
                               ((fb == 2 or fb == -2) and fback[i, j - 1] < 0)):
                back[i, j - 1] = 0
            out_a.append(a[j])
            out_b.append(gap)
            j -= 1
        else:
            eb = eback[i, j]
            if i - 1 >= 0 and (eb == 1 or eb == -1 or
                               ((eb == 2 or eb == -2) and eback[i - 1, j] < 0)):
                back[i - 1, j] = 2
            out_a.append(gap)
            out_b.append(b[i])
            i -= 1
    while j >= 0:
        out_a.append(a[j])
        out_b.append(gap)
        j -= 1
    while i >= 0:
        out_a.append(gap)
        out_b.append(b[i])
        i -= 1
    out_a.reverse()
    out_b.reverse()
    return Alignment(bytes(out_a), bytes(out_b))


def score_alignment(a_row: bytes, b_row: bytes, params) -> int:
    """Re-score an emitted alignment (validity check for tests).

    Scores matches/mismatches plus ``O + k*E`` per gap run; boundary gaps
    pay the open penalty too, matching the DP boundary H(-1,j) = O+(j+1)E.
    """
    m_, x_, e_, o_ = (params.match, params.mismatch, params.gap_extend,
                      params.gap_open)
    score = 0
    in_gap_a = in_gap_b = False
    for ca, cb in zip(a_row, b_row):
        ga, gb = ca == ord("-"), cb == ord("-")
        if ga and gb:
            raise ValueError("gap aligned to gap")
        if ga:
            score += e_ + (0 if in_gap_a else o_)
            in_gap_a, in_gap_b = True, False
        elif gb:
            score += e_ + (0 if in_gap_b else o_)
            in_gap_a, in_gap_b = False, True
        else:
            score += m_ if ca == cb else x_
            in_gap_a = in_gap_b = False
    return score


# ---------------------------------------------------------------------
# Walks of the packed plane the CUDA kernel writes (ops/psa_cuda.py).
#
# The reference's trace() mutates the back plane as it walks: on a left
# move whose fback marks an extended (or tie-continued) gap it forces
# back[i][j-1] = 0, and symmetrically for up moves (psa/psa.c:450-459).
# The mutated cell is always the next cell visited, so the walk is
# equivalent to carrying a "forced move" flag -- a pure function of the
# packed plane (back*9 + f*3 + e; f/e 0 extend, 1 open, 2 open-tie).
# ---------------------------------------------------------------------


def _decode_step(in_core, i, j, forced, code, fprev, eprev):
    """The walk's move + gap-run-propagation rules (reference trace()
    semantics, psa/psa.c:450-459): given the current cell's packed code,
    the entered-left cell's f-code and the entered-up cell's e-code,
    return (move, forced_next).  Works on scalars and on vectors."""
    back = code // 9
    f = (code // 3) % 3   # 0 extend, 1 open, 2 open-tie
    e = code % 3
    move = jnp.where(in_core,
                     jnp.where(forced > 0, forced - 1, back),
                     jnp.where(j >= 0, 0, 2))
    # extend (code 0) always continues the gap run; an open (1 or 2)
    # continues iff the entered cell carries the tie mark (code 2,
    # i.e. the reference's negative fback/eback)
    force_left = jnp.logical_and(
        move == 0,
        jnp.logical_and(j - 1 >= 0, jnp.logical_or(
            f == 0, jnp.logical_and(f >= 1, fprev == 2))))
    force_up = jnp.logical_and(
        move == 2,
        jnp.logical_and(i - 1 >= 0, jnp.logical_or(
            e == 0, jnp.logical_and(e >= 1, eprev == 2))))
    forced_next = jnp.where(in_core,
                            jnp.where(force_left, 1,
                                      jnp.where(force_up, 3, 0)),
                            0)
    return move, forced_next


@jax.jit
def _decode_moves(plane, m, n):
    """Device walk: ``lax.while_loop`` over one packed plane, which may be
    padded beyond (m, n) -- the walk starts at (m-1, n-1) and never reads
    outside.  ``m``/``n`` may be traced, so one compile serves every pair
    of a padded bucket, and ``jax.vmap`` walks a stack in lockstep.

    Returns (moves, count): moves[t] in {0:left, 1:diag, 2:up}, emitted
    from the walk start; count = number of moves until both i and j are
    exhausted (boundary tails included).
    """
    maxlen = plane.shape[0] + plane.shape[1]

    def cond(st):
        i, j, t, forced, moves = st
        return jnp.logical_or(i >= 0, j >= 0)

    def body(st):
        i, j, t, forced, moves = st
        in_core = jnp.logical_and(i >= 0, j >= 0)
        code = jnp.where(in_core,
                         plane[jnp.maximum(i, 0), jnp.maximum(j, 0)],
                         0).astype(jnp.int32)
        # run-continuation: look up the mark of the *entered* cell
        fprev = jnp.where(j > 0,
                          (plane[jnp.maximum(i, 0),
                                 jnp.maximum(j - 1, 0)] // 3) % 3,
                          0).astype(jnp.int32)
        eprev = jnp.where(i > 0,
                          (plane[jnp.maximum(i - 1, 0),
                                 jnp.maximum(j, 0)] % 3),
                          0).astype(jnp.int32)
        move, forced_next = _decode_step(in_core, i, j, forced, code,
                                         fprev, eprev)
        moves = moves.at[t].set(move.astype(jnp.int8))
        di = jnp.where(move == 0, 0, 1)
        dj = jnp.where(move == 2, 0, 1)
        return i - di, j - dj, t + 1, forced_next, moves

    i0 = jnp.asarray(m, jnp.int32) - 1
    j0 = jnp.asarray(n, jnp.int32) - 1
    moves0 = jnp.zeros((maxlen,), jnp.int8)
    i, j, t, _, moves = jax.lax.while_loop(
        cond, body, (i0, j0, jnp.int32(0), jnp.int32(0), moves0))
    return moves, t


_decode_moves_stack = jax.jit(jax.vmap(_decode_moves))


def walk_moves_host(plane: np.ndarray, m: int, n: int) -> np.ndarray:
    """Host walk of one packed plane (rows may be padded beyond ``n``):
    the same rules as :func:`_decode_step`, one cell at a time.  Returns
    the moves from the walk start (0 left, 1 diag, 2 up)."""
    stride = plane.shape[1]
    cells = memoryview(np.ascontiguousarray(plane)).cast("B")
    moves = bytearray()
    i, j, forced = m - 1, n - 1, 0
    while i >= 0 and j >= 0:
        code = cells[i * stride + j]
        move = forced - 1 if forced else code // 9
        forced = 0
        if move == 0:
            f = (code // 3) % 3
            if j > 0 and (f == 0 or (cells[i * stride + j - 1] // 3) % 3
                          == 2):
                forced = 1
            j -= 1
        elif move == 1:
            i -= 1
            j -= 1
        else:
            e = code % 3
            if i > 0 and (e == 0 or cells[(i - 1) * stride + j] % 3 == 2):
                forced = 3
            i -= 1
        moves.append(move)
    moves.extend(b"\x00" * (j + 1) + b"\x02" * (i + 1))
    return np.frombuffer(bytes(moves), np.uint8)


def walk_planes(plane, lens: np.ndarray, pairs, engine: str = "host"
                ) -> list:
    """Alignments from a stack of packed planes.

    ``plane`` (P, m_pad, n_pad) int8, on the device or the host;
    ``lens`` (P, 2) real (n, m); ``pairs`` the P encoded (a, b) pairs.
    ``engine`` 'host' copies the planes to the host and walks them there;
    'device' walks all P in lockstep with :func:`_decode_moves` and copies
    only the move lists (``ops/route.walk_engine`` chooses by shape).
    """
    lens = np.asarray(lens)
    if engine == "device":
        moves, counts = _decode_moves_stack(
            plane, jnp.asarray(lens[:, 1], jnp.int32),
            jnp.asarray(lens[:, 0], jnp.int32))
        moves, counts = np.asarray(moves), np.asarray(counts)
        walked = [moves[k, :counts[k]] for k in range(len(pairs))]
    elif engine == "host":
        host = np.asarray(plane)
        walked = [walk_moves_host(host[k], int(lens[k, 1]), int(lens[k, 0]))
                  for k in range(len(pairs))]
    else:
        raise ValueError("unknown walk engine %r" % engine)
    return [emit_alignment(mv, a, b, int(nm[0]), int(nm[1]))
            for mv, (a, b), nm in zip(walked, pairs, lens)]


def emit_alignment(moves: np.ndarray, a: np.ndarray, b: np.ndarray,
                   n: int, m: int) -> Alignment:
    """Vectorised move-list -> aligned strings (moves run backwards from
    the alignment end; 1=diag, 0=left/gap-in-b, 2=up/gap-in-a)."""
    gap = ord("-")
    ca = moves != 2                      # consumes a
    cb = moves != 0                      # consumes b
    ai = n - 1 - (np.cumsum(ca) - ca)    # exclusive prefix
    bi = m - 1 - (np.cumsum(cb) - cb)
    out_a = np.where(ca, a[np.clip(ai, 0, n - 1)], gap).astype(np.uint8)
    out_b = np.where(cb, b[np.clip(bi, 0, m - 1)], gap).astype(np.uint8)
    return Alignment(out_a[::-1].tobytes(), out_b[::-1].tobytes())
