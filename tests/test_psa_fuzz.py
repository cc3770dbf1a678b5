"""Property tests: the scan kernel vs a brute-force O(nm) Gotoh oracle."""

import numpy as np
import pytest

from tsta_tpu.config import AlignParams
from tsta_tpu.ops import psa_scan, traceback

NEGINF = -(10 ** 9)


def brute_gotoh(a, b, p: AlignParams):
    """Naive int64 DP implementing SURVEY.md section 2.1 semantics."""
    M, X, E, O = p.match, p.mismatch, p.gap_extend, p.gap_open
    n, m = len(a), len(b)
    H = np.zeros((m + 1, n + 1), np.int64)
    Ev = np.full((m + 1, n + 1), NEGINF, np.int64)
    F = np.full((m + 1, n + 1), NEGINF, np.int64)
    H[0, 1:] = O + np.arange(1, n + 1) * E
    H[1:, 0] = O + np.arange(1, m + 1) * E
    for i in range(1, m + 1):
        for j in range(1, n + 1):
            Ev[i, j] = max(Ev[i - 1, j] + E, H[i - 1, j] + O + E)
            F[i, j] = max(F[i, j - 1] + E, H[i, j - 1] + O + E)
            sub = M if a[j - 1] == b[i - 1] else X
            H[i, j] = max(H[i - 1, j - 1] + sub, Ev[i, j], F[i, j])
    return H, Ev, F


PARAM_SETS = [
    AlignParams(),
    AlignParams(mismatch=-3),
    AlignParams(3, -2, -1, -6),
    AlignParams.linear(1, -2, -2),
]


@pytest.mark.parametrize("seed", range(6))
def test_scan_matches_brute(seed):
    rng = np.random.default_rng(seed)
    p = PARAM_SETS[seed % len(PARAM_SETS)]
    n, m = int(rng.integers(1, 80)), int(rng.integers(1, 80))
    a = rng.integers(65, 69, n).astype(np.uint8)
    b = rng.integers(65, 69, m).astype(np.uint8)
    H, Ev, F = brute_gotoh(a, b, p)
    res = psa_scan.psa_align(a, b, p, traced=True)
    assert int(res.score) == H[1:, 1:].max()
    assert int(res.last) == H[m, n]
    # traceback plane encodings (psa/psa.c:294-327 semantics)
    for i in range(m):
        for j in range(n):
            sub = p.match if a[j] == b[i] else p.mismatch
            diag = H[i, j] + sub
            h = H[i + 1, j + 1]
            want = 1 if h == diag else (0 if h == F[i + 1, j + 1] else 2)
            assert res.back[i, j] == want, (i, j)
            f_open = F[i + 1, j + 1] == H[i + 1, j] + p.ogap
            f_tie = F[i + 1, j + 1] + p.gap_extend == h + p.ogap
            want_f = (-2 if f_tie else 2) if f_open else 1
            assert res.fback[i, j] == want_f, (i, j)
            e_open = Ev[i + 1, j + 1] == H[i, j + 1] + p.ogap
            e_tie = Ev[i + 1, j + 1] + p.gap_extend == h + p.ogap
            want_e = (-2 if e_tie else 2) if e_open else 1
            assert res.eback[i, j] == want_e, (i, j)


@pytest.mark.parametrize("seed", range(8))
def test_alignment_valid_and_scores_corner(seed):
    """Decoded alignment reconstructs both sequences and re-scores to H(m,n)."""
    rng = np.random.default_rng(100 + seed)
    p = PARAM_SETS[seed % len(PARAM_SETS)]
    n, m = int(rng.integers(2, 120)), int(rng.integers(2, 120))
    a = rng.integers(65, 69, n).astype(np.uint8)
    b = rng.integers(65, 69, m).astype(np.uint8)
    res = psa_scan.psa_align(a, b, p, traced=True)
    aln = traceback.decode_pair(np.asarray(res.back), np.asarray(res.fback),
                                np.asarray(res.eback), a, b)
    assert aln.a_row.replace(b"-", b"") == a.tobytes()
    assert aln.b_row.replace(b"-", b"") == b.tobytes()
    assert traceback.score_alignment(aln.a_row, aln.b_row, p) == int(res.last)


def test_tiny_sequences():
    """1-3 bp inputs through the single-pair and the batch paths."""
    from tsta_tpu.parallel import batch
    for n, m in [(1, 1), (1, 5), (2, 3), (3, 1)]:
        a = np.frombuffer(b"ACGTA"[:n], np.uint8)
        b = np.frombuffer(b"TGCAT"[:m], np.uint8)
        p = AlignParams()
        H, _, _ = brute_gotoh(a, b, p)
        r1 = psa_scan.psa_align(a, b, p, traced=True)
        r2 = batch.align_batch([(a, b)], p, swap=False)[0]
        assert int(r1.score) == H[1:, 1:].max() == r2.score
        assert int(r1.last) == H[m, n] == r2.last
