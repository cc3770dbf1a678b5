"""CPU stand-ins for the CUDA PSA kernel (tsta_tpu/ops/cuda/psa_dp.cu).

* :func:`kernel_model` follows the kernel's schedule step for step in
  NumPy -- stripes of ``threads * R`` rows, thread t owning R rows and
  working on column group k - t at step k, boundary H/E handed over from
  thread t-1's previous step or from the row buffer between stripes, the
  traced plane flushed 16 columns at a time -- so the arithmetic and the
  schedule the kernel implements are tested without a GPU.
* :func:`dp_reference` has the FFI call's signature and output layout
  (``psa_cuda.dp``) but computes with ``psa_scan``; patched in its place,
  it drives the whole GPU path of ``parallel.batch`` and ``models.psa``
  (stacking, padding, sharding, group sizes, walks) on the CPU.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

from tsta_tpu.ops import psa_scan

NEG = -(1 << 28)
R, C = 8, 4          # rows per thread, columns per step (psa_dp.cu)
B_PAD = psa_scan.B_PAD


def _gap_code(open_, tie):
    return np.where(open_, np.where(tie, 2, 1), 0)


def kernel_model(a, b, n_real, m_real, params, threads, traced):
    """One pair through psa_dp.cu's schedule.  ``a`` (n_pad,) and ``b``
    (m_pad,) are padded byte rows.  Returns (score, corner, plane)."""
    M, X, E, O = (int(v) for v in params)
    OE = O + E
    n_pad, m_pad = len(a), len(b)
    a = np.asarray(a, np.int64)
    b = np.asarray(b, np.int64)
    T = threads
    G = -(-n_real // 16) * 4 if traced else -(-n_real // C)
    S = -(-m_real // (T * R))
    plane = np.zeros((m_pad, n_pad), np.int8)
    rowbuf = np.full((2, 2, n_pad), NEG, np.int64)   # [parity][H, E]
    best, corner = NEG, None
    t = np.arange(T)
    for s in range(S):
        rows = s * T * R + t[:, None] * R + np.arange(R)        # (T, R)
        brow = np.where(rows < m_pad, b[np.minimum(rows, m_pad - 1)],
                        B_PAD)
        row_ok = rows < m_real
        hleft = O + (rows + 1) * E
        fleft = np.full((T, R), NEG, np.int64)
        row0 = rows[:, 0]
        hdiag_top = np.where(row0 == 0, 0, O + row0 * E)
        outH = np.full((T, C), NEG, np.int64)
        outE = np.full((T, C), NEG, np.int64)
        words = [[] for _ in range(T)]   # traced: buffered group codes
        for k in range(G + T - 1):
            g = k - t
            j0 = g * C
            valid = (g >= 0) & (g < G)
            # boundary row above each strip: thread t-1's previous step
            upH = np.vstack([np.full((1, C), NEG), outH[:-1]])
            upE = np.vstack([np.full((1, C), NEG), outE[:-1]])
            if s == 0:
                upH[0] = O + (j0[0] + np.arange(C) + 1) * E
                upE[0] = NEG
            elif valid[0]:
                upH[0] = rowbuf[(s + 1) & 1, 0, j0[0]:j0[0] + C]
                upE[0] = rowbuf[(s + 1) & 1, 1, j0[0]:j0[0] + C]
            code = np.zeros((T, R), np.int64)
            new_hl, new_fl = hleft.copy(), fleft.copy()
            new_oh, new_oe = outH.copy(), outE.copy()
            for c in range(C):
                j = j0 + c
                aj = a[np.clip(j, 0, n_pad - 1)]
                col_ok = j < n_real
                hd = hdiag_top if c == 0 else upH[:, c - 1]
                hu, eu = upH[:, c], upE[:, c]
                for r in range(R):
                    diag = hd + np.where(aj == brow[:, r], M, X)
                    e = np.maximum(eu + E, hu + OE)
                    f = np.maximum(new_fl[:, r] + E, new_hl[:, r] + OE)
                    h = np.maximum(np.maximum(diag, e), f)
                    if traced:
                        back = np.where(h == diag, 1, np.where(h == f, 0, 2))
                        fc = _gap_code(f == new_hl[:, r] + OE, f + E == h + OE)
                        ec = _gap_code(e == hu + OE, e + E == h + OE)
                        code[:, r] |= (back * 9 + fc * 3 + ec) << (8 * c)
                    sel = valid & row_ok[:, r] & col_ok
                    if sel.any():
                        best = max(best, int(h[sel].max()))
                        hit = sel & (rows[:, r] == m_real - 1) & (
                            j == n_real - 1)
                        if hit.any():
                            corner = int(h[hit][0])
                    hd = new_hl[:, r].copy()
                    new_hl[:, r] = h
                    new_fl[:, r] = f
                    hu, eu = h, e
                new_oh[:, c] = hu
                new_oe[:, c] = eu
            keep = valid[:, None]
            hleft = np.where(keep, new_hl, hleft)
            fleft = np.where(keep, new_fl, fleft)
            outH = np.where(keep, new_oh, outH)
            outE = np.where(keep, new_oe, outE)
            hdiag_top = np.where(valid, upH[:, C - 1], hdiag_top)
            for tt in np.nonzero(valid)[0]:
                if traced:
                    words[tt].append(code[tt])
                    if g[tt] % 4 == 3:     # flush 16 columns
                        col = (g[tt] - 3) * C
                        for r in range(R):
                            if row_ok[tt, r]:
                                for q, w in enumerate(words[tt]):
                                    for c in range(C):
                                        plane[rows[tt, r], col + 4 * q + c] \
                                            = (w[r] >> (8 * c)) & 0xFF
                        words[tt] = []
                if tt == T - 1 and s + 1 < S:
                    jj = j0[tt]
                    rowbuf[s & 1, 0, jj:jj + C] = outH[tt]
                    rowbuf[s & 1, 1, jj:jj + C] = outE[tt]
    return best, corner, plane


def pack_planes(back, fback, eback):
    """psa_scan's three planes -> the kernel's one-byte packing."""
    f = np.asarray(fback)
    e = np.asarray(eback)
    fc = np.where(f == 1, 0, np.where(f == 2, 1, 2))
    ec = np.where(e == 1, 0, np.where(e == 2, 1, 2))
    return (np.asarray(back) * 9 + fc * 3 + ec).astype(np.int8)


@functools.partial(jax.jit, static_argnames=("params", "traced"))
def _scan_stack(a, b, lens, params, traced):
    """psa_scan's row step over a padded stack, with the max taken over
    each pair's real cells only (as the kernel does, so exotic scoring
    stays exact) and the traced planes packed into one byte."""
    n = a.shape[1]
    m_, x_, e_, o_ = (jnp.int32(v) for v in params)
    j_idx = jnp.arange(n, dtype=jnp.int32)

    def one(a1, b1, nm):
        step = functools.partial(psa_scan._row_step, m_, x_, e_, o_,
                                 a1.astype(jnp.int32), n, nm[0], traced)

        def body(carry, b_i):
            state, best = carry
            state, out = step(state, b_i)
            h_row, _, i, _ = state
            real = (j_idx < nm[0]) & (i - 1 < nm[1])
            best = jnp.maximum(best, jnp.max(jnp.where(real, h_row,
                                                       psa_scan.NEG)))
            return (state, best), out

        h0 = o_ + (j_idx + 1) * e_
        e0 = jnp.full((n,), psa_scan.NEG, jnp.int32)
        (_, best), rows = jax.lax.scan(
            body, ((h0, e0, jnp.int32(0), psa_scan.NEG), psa_scan.NEG),
            b1.astype(jnp.int32))
        corner = rows[0][nm[1] - 1]
        if not traced:
            return best, corner
        _, back, fback, eback = rows
        fc = jnp.where(fback == 1, 0, jnp.where(fback == 2, 1, 2))
        ec = jnp.where(eback == 1, 0, jnp.where(eback == 2, 1, 2))
        return best, corner, (back * 9 + fc * 3 + ec).astype(jnp.int8)
    return jax.vmap(one)(a, b, lens)


def dp_reference(a, b, lens, params, traced, threads):
    """Drop-in for ``psa_cuda.dp`` computed with psa_scan's row step."""
    del threads
    return _scan_stack(a, b, lens, tuple(int(v) for v in params), traced)
