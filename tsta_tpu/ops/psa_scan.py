"""Exact affine-gap global alignment (Gotoh) as a JAX row scan.

This is the reference oracle of the framework: pure ``lax.scan`` int32 DP,
runs unchanged on the CPU and the GPU, and is bit-compatible with the reference's
int8 *difference method* kernel (psa/psa.c:234-363) because for any sane
scoring the reference's wrapping-int8 differences never overflow -- the
difference representation is exact, so exact int32 arithmetic reproduces it.

Semantics reproduced from the reference (see SURVEY.md section 2.1):

* Recurrence (derived from the difference-space update psa/psa.c:284-354)::

    H(i,j) = max(H(i-1,j-1) + sub(a_j, b_i), E(i,j), F(i,j))
    E(i,j) = max(E(i-1,j) + e,  H(i-1,j) + o + e)   # gap in a (up moves)
    F(i,j) = max(F(i,j-1) + e,  H(i,j-1) + o + e)   # gap in b (left moves)

  with boundary H(-1,-1)=0, H(-1,j)=o+(j+1)e, H(i,-1)=o+(i+1)e
  (psa/psa.c:219-232), i.e. boundary gaps also pay the open penalty.

* Reported score = max over *all* cells of H (not H(m,n)!) -- the reference
  folds per-row int32 maxima of its absolute-score anchors into a global
  max (psa/psa.c:330-357, 416-424).

* Traceback planes, stored per cell as int8:
  - ``back``: 1 if H equals the diagonal candidate, else 0 if H == F, else 2
    (precedence diag > left > up; psa/psa.c:294-298).
  - ``fback``: 2 if F(i,j) == H(i,j-1)+o+e (gap opened) else 1 (extended);
    negated to -2 when additionally F(i,j)+e == H(i,j)+o+e, the
    open/extend tie for the *next* F (psa/psa.c:301-313).
  - ``eback``: same for E with rows/cols swapped (psa/psa.c:315-327).

The within-row F dependency is resolved in closed form instead of the
reference's lazy-F two-pass (psa/psa.c:250-274): with o <= 0,

    F(i,j) = o + j*e + max_{-1 <= k <= j-1} (C(k) - k*e),

where C(j) = max(diag(j), E(i,j)) and C(-1) = H(i,-1), because a gap
re-opened from inside another gap is never strictly better.  The max is a
cumulative max -- one ``lax.cummax`` per row -- which makes every row a pure
vector op chain: fit for ``vmap`` batching and sharding.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

# Large-negative guard that cannot overflow int32 when gap arithmetic is
# added a few times.  (The reference uses I_MIN = -2e9 for int32 maxima and
# MIN = -100 for int8 difference seeds; exact arithmetic needs only "very
# negative".)
NEG = jnp.int32(-(2 ** 28))


class PsaResult(NamedTuple):
    score: jnp.ndarray              # int32 scalar: max over all H cells
    last: jnp.ndarray               # int32 scalar: H(m-1, n-1) (corner score)
    back: jnp.ndarray | None = None   # (m, n) int8
    fback: jnp.ndarray | None = None  # (m, n) int8
    eback: jnp.ndarray | None = None  # (m, n) int8


# Shape buckets bound the number of distinct compilations: sequences are
# right-padded (a with byte 0, b with byte 1 -- distinct so pad never
# matches pad) to the next bucket edge.  With M > 0 > X and E < 0, O <= 0
# every padded-region DP candidate adds a negative delta, so padded cells
# can never exceed the real-region matrix max, and the causal DP leaves all
# real-region values and traceback planes bit-identical.
A_PAD, B_PAD = 0, 1


def bucket(n: int) -> int:
    if n <= 2048:
        return (n + 127) // 128 * 128
    return (n + 1023) // 1024 * 1024


def _row_step(m_, x_, e_, o_, a, n, n_real, traced, carry, b_i):
    """One DP row.  carry = (h_prev, e_prev, i, best)."""
    h_prev, e_prev, i, best = carry
    # boundary values for this row / previous row; H(-1,-1) = 0
    h_im1_m1 = jnp.where(i == 0, jnp.int32(0), o_ + i * e_)  # H(i-1, -1)
    h_i_m1 = o_ + (i + 1) * e_                               # H(i, -1)

    sub = jnp.where(a == b_i, m_, x_)
    # diag(j) = H(i-1, j-1) + sub
    h_shift = jnp.concatenate([jnp.full((1,), h_im1_m1, jnp.int32),
                               h_prev[:-1]])
    diag = h_shift + sub
    # E(i,j) from previous row
    e_row = jnp.maximum(e_prev + e_, h_prev + (o_ + e_))
    c = jnp.maximum(diag, e_row)
    # F(i,j) = o + j*e + cummax_{k<=j-1}(C~(k) - k*e), with the k = -1
    # boundary term folded in as C~(-1) - (-1)*e = H(i,-1) + e.
    g = jnp.concatenate([jnp.full((1,), h_i_m1 + e_, jnp.int32),
                         c[:-1] - jnp.arange(n - 1, dtype=jnp.int32) * e_])
    p = jax.lax.cummax(g)
    j_idx = jnp.arange(n, dtype=jnp.int32)
    f_row = o_ + j_idx * e_ + p
    h_row = jnp.maximum(c, f_row)

    best = jnp.maximum(best, jnp.max(h_row))
    corner_col = h_row[n_real - 1]

    if traced:
        back = jnp.where(
            h_row == diag, jnp.int8(1),
            jnp.where(h_row == f_row, jnp.int8(0), jnp.int8(2)))
        # H(i, j-1) for the F-open test
        h_left = jnp.concatenate([jnp.full((1,), h_i_m1, jnp.int32),
                                  h_row[:-1]])
        f_open = f_row == h_left + (o_ + e_)
        f_tie = f_row + e_ == h_row + (o_ + e_)
        fback = jnp.where(f_open,
                          jnp.where(f_tie, jnp.int8(-2), jnp.int8(2)),
                          jnp.int8(1))
        e_open = e_row == h_prev + (o_ + e_)
        e_tie = e_row + e_ == h_row + (o_ + e_)
        eback = jnp.where(e_open,
                          jnp.where(e_tie, jnp.int8(-2), jnp.int8(2)),
                          jnp.int8(1))
        out = (corner_col, back, fback, eback)
    else:
        out = (corner_col,)
    return (h_row, e_row, i + 1, best), out


# Scoring params are *static* (python ints baked into the compiled program):
# with traced scalar params, XLA:CPU's simplification passes blow compile time
# up by >100x (measured 393s vs 0.9s on a 10k-row scan).  Alignments rarely
# change scoring mid-run; a recompile per parameter set is the right trade.
@functools.partial(jax.jit, static_argnames=("params", "traced", "n", "m"))
def _psa_scan(a, b, n_real, m_real, params, n, m, traced):
    m_, x_, e_, o_ = (jnp.int32(params[0]), jnp.int32(params[1]),
                      jnp.int32(params[2]), jnp.int32(params[3]))
    a = a.astype(jnp.int32)
    b = b.astype(jnp.int32)
    # virtual row -1: H(-1, j) = o + (j+1)e ; E(-1, j) = -inf
    j_idx = jnp.arange(n, dtype=jnp.int32)
    h0 = o_ + (j_idx + 1) * e_
    e0 = jnp.full((n,), NEG, jnp.int32)
    step = functools.partial(_row_step, m_, x_, e_, o_, a, n, n_real, traced)
    carry, rows = jax.lax.scan(step, (h0, e0, jnp.int32(0), NEG), b)
    _, _, _, best = carry
    corner = rows[0][m_real - 1]
    if traced:
        _, back, fback, eback = rows
        return best, corner, back, fback, eback
    return best, corner


def psa_align(a: np.ndarray, b: np.ndarray, params, traced: bool = False
              ) -> PsaResult:
    """Align byte-encoded sequences ``a`` (columns) x ``b`` (rows).

    ``params`` is (match, mismatch, gap_extend, gap_open) or an AlignParams.
    Returns scores and, when ``traced``, the three traceback planes of shape
    ``(len(b), len(a))`` in natural (row-major, unstriped) layout.
    """
    if hasattr(params, "match"):
        params = (params.match, params.mismatch, params.gap_extend,
                  params.gap_open)
    p = tuple(int(v) for v in params)
    if p[3] > 0:
        # the closed-form F (cummax over C(k) - k*e) assumes re-opening a
        # gap from inside a gap never wins, which requires gap_open <= 0.
        # (The reference binary accepts O>0 but then emits scores that
        # contradict its own recurrence -- audited in
        # tests/test_param_audit.py -- so there is nothing to match.)
        # Every other sign combination, including X>=0 and E>0, is exact
        # here: bucketed padding simply turns off (can_pad below).
        raise ValueError("scan kernel requires gap_open <= 0 "
                         "(got O=%d)" % p[3])
    a = np.asarray(a, dtype=np.uint8)
    b = np.asarray(b, dtype=np.uint8)
    n_real, m_real = int(a.shape[0]), int(b.shape[0])
    if n_real == 0 or m_real == 0:
        raise ValueError("empty sequence")
    # Bucketed padding is only score-preserving for sane scoring (see above).
    can_pad = p[0] > 0 and p[1] < 0 and p[2] < 0 and p[3] <= 0
    n = bucket(n_real) if can_pad else n_real
    m = bucket(m_real) if can_pad else m_real
    if n != n_real:
        a = np.concatenate([a, np.full(n - n_real, A_PAD, np.uint8)])
    if m != m_real:
        b = np.concatenate([b, np.full(m - m_real, B_PAD, np.uint8)])
    out = _psa_scan(jnp.asarray(a), jnp.asarray(b), jnp.int32(n_real),
                    jnp.int32(m_real), p, n, m, traced)
    if traced:
        best, last, back, fback, eback = out
        return PsaResult(best, last, back[:m_real, :n_real],
                         fback[:m_real, :n_real], eback[:m_real, :n_real])
    best, last = out
    return PsaResult(best, last)
