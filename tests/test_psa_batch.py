"""Batch PSA (parallel.batch.align_batch) against the single-pair scan
oracle over the shape and parameter grids the batch paths must hold:
ragged groups, bucket edges, long similar pairs, unswapped m > n, gap
runs with open/extend ties and tiny pairs.

Each case runs twice: through the plain engine (``kernel='scan'``, the
CPU route) and through the GPU route with the CUDA call replaced by its
stand-in (``psa_kernel_model.dp_reference``), which exercises the
kernel path's stacking, padding, group sizes and plane walks.
"""

import numpy as np
import pytest

from psa_kernel_model import dp_reference
from tsta_tpu.config import AlignParams
from tsta_tpu.ops import psa_cuda, psa_scan, route, traceback
from tsta_tpu.parallel import batch

P0 = (2, -5, -2, -4)


@pytest.fixture(params=["scan", "cuda"])
def engine(request, monkeypatch):
    if request.param == "cuda":
        monkeypatch.setattr(route, "platform", lambda: "gpu")
        monkeypatch.setattr(psa_cuda, "dp", dp_reference)
    return request.param


def _rnd(rng, n):
    return rng.integers(65, 69, n).astype(np.uint8)


def _check_scores(pairs, params, swap=True):
    p = AlignParams(*params)
    got = batch.align_batch(pairs, p, swap=swap)
    for (a, b), r in zip(pairs, got):
        if swap and len(b) > len(a):
            a, b = b, a
        ref = psa_scan.psa_align(a, b, p)
        assert (r.score, r.last) == (int(ref.score), int(ref.last))


def _check_traced(pairs, params, swap=True):
    p = AlignParams(*params)
    got = batch.align_batch(pairs, p, traced=True, swap=swap)
    for (a, b), r in zip(pairs, got):
        if swap and len(b) > len(a):
            a, b = b, a
        ref = psa_scan.psa_align(a, b, p, traced=True)
        aln = traceback.decode_pair(np.asarray(ref.back),
                                    np.asarray(ref.fback),
                                    np.asarray(ref.eback), a, b)
        assert (r.score, r.last, r.aln) == (int(ref.score), int(ref.last),
                                            aln)
    return got


@pytest.mark.parametrize("params", [
    P0, (1, -1, -1, 0), (5, -4, -1, -6), (24, -24, -24, -24),
    (3, -2, -11, -46), (2, -57, -2, -4),
])
def test_batch_matches_oracle_params(engine, params):
    rng = np.random.default_rng(sum(abs(v) for v in params))
    pairs = [(_rnd(rng, int(rng.integers(5, 700))),
              _rnd(rng, int(rng.integers(5, 700)))) for _ in range(5)]
    _check_scores(pairs, params)


@pytest.mark.parametrize("lengths", [
    (127, 128, 129), (2047, 2048, 2049), (1, 2, 3), (255, 256, 257)])
def test_batch_bucket_edges(engine, lengths):
    """Pairs on both sides of a bucket edge land in different stacks;
    each keeps its own real lengths."""
    rng = np.random.default_rng(sum(lengths))
    pairs = [(_rnd(rng, n), _rnd(rng, max(1, n - 3))) for n in lengths]
    pairs += [(_rnd(rng, 5), _rnd(rng, n)) for n in lengths]   # swapped
    _check_scores(pairs, P0)


def test_batch_similar_sequences_long(engine):
    """Similar pairs (scores drift upward) over many rows."""
    rng = np.random.default_rng(5)
    pairs = []
    for _ in range(3):
        n = int(rng.integers(600, 1500))
        a = _rnd(rng, n)
        b = a.copy()
        idx = rng.integers(0, n, max(1, n // 25))
        b[idx] = _rnd(rng, len(idx))
        pairs.append((a, np.delete(b, rng.integers(0, len(b), n // 40))))
    _check_scores(pairs, P0)


def test_batch_unswapped_m_gt_n(engine):
    rng = np.random.default_rng(0)
    pairs = [(_rnd(rng, 100), _rnd(rng, 300)), (_rnd(rng, 1000),
                                                _rnd(rng, 1024))]
    _check_scores(pairs, P0, swap=False)
    _check_traced(pairs[:1], P0, swap=False)


def test_traced_batch_mixed_lengths(engine):
    """Mixed lengths in a shared padded stack; walks of different
    lengths end at different steps."""
    rng = np.random.default_rng(17)
    pairs = []
    for _ in range(5):
        n = int(rng.integers(40, 500))
        pairs.append((_rnd(rng, n), _rnd(rng, int(rng.integers(30, n + 1)))))
    _check_traced(pairs, P0)


@pytest.mark.parametrize("params", [P0, (3, -2, -1, -6), (1, -2, -2, 0)])
def test_traced_batch_params(engine, params):
    rng = np.random.default_rng(sum(abs(v) for v in params) + 7)
    pairs = [(_rnd(rng, 300), _rnd(rng, 280)),
             (_rnd(rng, 290), _rnd(rng, 290))]
    _check_traced(pairs, params)


def test_traced_batch_gap_runs(engine):
    """Similar sequences with indels: forced gap-run propagation through
    open/extend ties."""
    rng = np.random.default_rng(23)
    pairs = []
    for _ in range(3):
        n = int(rng.integers(200, 400))
        a = _rnd(rng, n)
        b = np.delete(a, rng.integers(0, n, n // 10))
        b = np.insert(b, rng.integers(0, len(b), n // 20),
                      _rnd(rng, n // 20))
        pairs.append((a, b))
    _check_traced(pairs, P0)
    _check_traced(pairs, (2, -5, -1, -1))


def test_traced_batch_tiny_pairs(engine):
    rng = np.random.default_rng(83)
    pairs = [(np.frombuffer(b"A", np.uint8), np.frombuffer(b"A", np.uint8)),
             (np.frombuffer(b"ACGT", np.uint8),
              np.frombuffer(b"T", np.uint8)),
             (_rnd(rng, 7), _rnd(rng, 7)),
             (_rnd(rng, 9), _rnd(rng, 8))]
    _check_traced(pairs, P0)


def test_traced_batch_identical_pairs_walk_the_diagonal(engine):
    rng = np.random.default_rng(97)
    pairs = [(a, a.copy()) for a in (_rnd(rng, 512), _rnd(rng, 513))]
    for (a, _), r in zip(pairs, _check_traced(pairs, P0)):
        assert r.aln.a_row == r.aln.b_row == bytes(a)


def test_batch_rejects_exotic_params_on_the_scan():
    a = np.frombuffer(b"ACGTAC", np.uint8)
    with pytest.raises(ValueError, match="exotic"):
        batch.align_batch([(a, a)], AlignParams(2, 1, -2, -4))
