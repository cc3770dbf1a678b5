"""Column-sharded PSA for one long pair over several devices.

The reference's analogue is the anti-diagonal block wavefront across a
thread pool (psa/psa.c:619-639): tiles of one anti-diagonal run in
parallel, with a spin barrier between diagonals.  On a device mesh the same
dependency structure becomes a *device pipeline* over the ``seq`` axis:

* the horizontal sequence (columns) is sharded across devices;
* rows advance in blocks of ``T`` rows; at pipeline step ``s`` device
  ``d`` processes row-block ``s - d`` (devices trail their left neighbor
  by one step, exactly like tiles on consecutive anti-diagonals);
* between steps each device passes its right-edge state to its right
  neighbor with ``lax.ppermute`` (NCCL on GPUs): per row, the H value at the
  shard's last column and the running F-chain prefix
  ``max_k (C(k) - k*e)`` (see ops/psa_scan.py for why this closed form
  makes F exact), i.e. (T+1) + T scalars -- the tile-edge exchange the
  reference does through shared memory (psa/psa.c:392-394,412-414).

Score-only; implemented with ``shard_map``.  Exact: verified against the
single-device oracle on a virtual CPU mesh in tests.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np
try:
    from jax import shard_map  # jax >= 0.9
except ImportError:  # pragma: no cover
    from jax.experimental.shard_map import shard_map
from jax.sharding import PartitionSpec as P

from tsta_tpu.config import AlignParams
from tsta_tpu.io import encode_dna
from tsta_tpu.ops.psa_scan import A_PAD, B_PAD, NEG


def _row_update(a, col_idx, e_, o_, m_, x_, h_prev, e_prev, b_i, i,
                diag_fill, gmax_left, is_first_shard):
    """One DP row over this device's C columns.

    ``diag_fill`` = H(i-1, first_col-1); ``gmax_left`` = inclusive
    max_{k < first_col} (C~(k) - k*e) from the left neighbor (NEG on the
    first shard, which instead folds in the k = -1 boundary term).
    """
    C = a.shape[0]
    sub = jnp.where(a == b_i, m_, x_)
    h_shift = jnp.concatenate([jnp.full((1,), diag_fill, jnp.int32),
                               h_prev[:-1]])
    diag = h_shift + sub
    e_row = jnp.maximum(e_prev + e_, h_prev + (o_ + e_))
    c = jnp.maximum(diag, e_row)
    g = c - col_idx * e_
    h_i_m1 = o_ + (i + 1) * e_  # H(i, -1), first shard's boundary
    boundary = jnp.where(is_first_shard, h_i_m1 + e_, jnp.int32(NEG))
    seed = jnp.maximum(gmax_left, boundary)
    # p[j] = max(seed, g(first..j-1)): inclusive cummax of g shifted one
    # with the incoming prefix as the first element
    g_shift = jnp.concatenate([jnp.full((1,), seed, jnp.int32), g[:-1]])
    p = jax.lax.cummax(g_shift)
    f_row = o_ + col_idx * e_ + p
    h_row = jnp.maximum(c, f_row)
    gmax_out = jnp.maximum(jnp.maximum(gmax_left, boundary), jnp.max(g))
    return h_row, e_row, gmax_out


@functools.partial(jax.jit,
                   static_argnames=("params", "n", "m", "n_real", "m_real",
                                    "block", "mesh_"))
def _longseq_scan(a_sh, b_all, params, n, m, n_real, m_real, block, mesh_):
    mesh = mesh_
    D = mesh.shape["seq"]
    C = n // D
    m_blocks = m // block
    steps = m_blocks + D - 1
    m_, x_, e_, o_ = (jnp.int32(params[0]), jnp.int32(params[1]),
                      jnp.int32(params[2]), jnp.int32(params[3]))

    def shard_fn(a_local, b_full):
        a_local = a_local.astype(jnp.int32).reshape(-1)
        b_full = b_full.astype(jnp.int32).reshape(-1)
        d = jax.lax.axis_index("seq")
        first = d == 0
        col_idx = d * C + jnp.arange(C, dtype=jnp.int32)
        h0 = o_ + (col_idx + 1) * e_
        e0 = jnp.full((C,), NEG, jnp.int32)

        # incoming packet: edge H for rows [rb*T-1 .. rb*T+T-1] (T+1) and
        # F-prefix for rows [rb*T .. rb*T+T-1] (T)
        pkt_h0 = jnp.full((block + 1,), NEG, jnp.int32)
        pkt_g0 = jnp.full((block,), NEG, jnp.int32)

        def step_fn(carry, s):
            h_prev, e_prev, best, corner, pkt_h, pkt_g = carry
            rb = s - d
            active = jnp.logical_and(rb >= 0, rb < m_blocks)

            def run_block(args):
                h_prev, e_prev, best, corner = args
                out_h = vary(jnp.zeros((block + 1,), jnp.int32))
                out_h = out_h.at[0].set(h_prev[-1])
                out_g = vary(jnp.zeros((block,), jnp.int32))

                def row_fn(r, st):
                    h_prev, e_prev, best, corner, out_h, out_g = st
                    i = rb * block + r
                    diag_fill = jnp.where(
                        first,
                        jnp.where(i == 0, jnp.int32(0), o_ + i * e_),
                        pkt_h[r])
                    gmax_left = jnp.where(first, jnp.int32(NEG), pkt_g[r])
                    h_row, e_row, gmax_out = _row_update(
                        a_local, col_idx, e_, o_, m_, x_, h_prev, e_prev,
                        b_full[i], i, diag_fill, gmax_left, first)
                    valid = i < m_real
                    h_prev = jnp.where(valid, h_row, h_prev)
                    e_prev = jnp.where(valid, e_row, e_prev)
                    best = jnp.where(valid,
                                     jnp.maximum(best, jnp.max(h_row)), best)
                    corner = jnp.where(
                        jnp.logical_and(valid, i == m_real - 1),
                        jnp.where(
                            jnp.logical_and(col_idx[0] <= n_real - 1,
                                            n_real - 1 <= col_idx[-1]),
                            h_row[jnp.clip(n_real - 1 - d * C, 0, C - 1)],
                            corner),
                        corner)
                    out_h = out_h.at[r + 1].set(h_prev[-1])
                    out_g = out_g.at[r].set(gmax_out)
                    return h_prev, e_prev, best, corner, out_h, out_g

                return jax.lax.fori_loop(
                    0, block, row_fn,
                    (h_prev, e_prev, best, corner, out_h, out_g))

            h_prev, e_prev, best, corner, out_h, out_g = jax.lax.cond(
                active, run_block,
                lambda args: (args[0], args[1], args[2], args[3],
                              vary(jnp.full((block + 1,), NEG, jnp.int32)),
                              vary(jnp.full((block,), NEG, jnp.int32))),
                (h_prev, e_prev, best, corner))

            perm = [(i, (i + 1) % D) for i in range(D)]
            pkt_h = jax.lax.ppermute(out_h, "seq", perm)
            pkt_g = jax.lax.ppermute(out_g, "seq", perm)
            return (h_prev, e_prev, best, corner, pkt_h, pkt_g), None

        # constants start replicated; mark them varying over 'seq' so the
        # scan carry types stay consistent once device-dependent values
        # flow in (jax>=0.9 shard_map vma check)
        vary = lambda x: jax.lax.pcast(x, "seq", to="varying")  # noqa: E731
        init = (h0, vary(e0), vary(jnp.int32(NEG)), vary(jnp.int32(NEG)),
                vary(pkt_h0), vary(pkt_g0))
        carry, _ = jax.lax.scan(step_fn, init,
                                jnp.arange(steps, dtype=jnp.int32))
        _, _, best, corner, _, _ = carry
        best = jax.lax.pmax(best, "seq")
        corner = jax.lax.pmax(corner, "seq")
        return best[None], corner[None]

    fn = shard_map(shard_fn, mesh=mesh,
                   in_specs=(P("seq"), P()),
                   out_specs=(P("seq"), P("seq")))
    best, corner = fn(a_sh, b_all)
    return best[0], corner[0]


def align_long(a, b, params: AlignParams = AlignParams(), mesh=None,
               block: int = 32):
    """Score-only alignment of one long pair, columns sharded over the
    mesh 'seq' axis."""
    if mesh is None:
        raise ValueError("align_long requires a mesh with a 'seq' axis")
    p = (params.match, params.mismatch, params.gap_extend, params.gap_open)
    a = encode_dna(a)
    b = encode_dna(b)
    n_real, m_real = int(a.shape[0]), int(b.shape[0])
    D = mesh.shape["seq"]
    n = -(-n_real // (128 * D)) * (128 * D)
    m = -(-m_real // block) * block
    a_p = np.full(n, A_PAD, np.uint8)
    a_p[:n_real] = a
    b_p = np.full(m, B_PAD, np.uint8)
    b_p[:m_real] = b
    best, corner = _longseq_scan(jnp.asarray(a_p), jnp.asarray(b_p), p, n, m,
                                 n_real, m_real, block, mesh)
    return int(best), int(corner)
