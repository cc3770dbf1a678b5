"""Randomized-params differential fuzz of the PSA batch paths
(``parallel.batch.align_batch``, score-only and traced) vs the unpadded
single-pair scan oracle.

Existing tests pin fixed seeds and the default scoring; this sweep
randomizes the scoring parameters too (any M>0>X, E<0, O<=0 -- the
batch paths' supported family), batch composition, and pair order
(unswapped m>n included).  Alignments are validated by re-scoring.
"""

import numpy as np
import pytest

from tsta_tpu.config import AlignParams
from tsta_tpu.ops import psa_scan
from tsta_tpu.ops import traceback as tb
from tsta_tpu.parallel import batch

pytestmark = pytest.mark.slow


@pytest.mark.parametrize("trial", range(3))
def test_batch_paths_random_params(trial):
    rng = np.random.default_rng(7000 + trial)
    p = (int(rng.integers(1, 5)), -int(rng.integers(1, 9)),
         -int(rng.integers(1, 5)), -int(rng.integers(0, 7)))
    nb = int(rng.integers(2, 6))
    pairs = [(rng.integers(65, 69, int(rng.integers(1, 700))).astype(
        np.uint8),
        rng.integers(65, 69, int(rng.integers(1, 700))).astype(np.uint8))
        for _ in range(nb)]
    refs = [psa_scan.psa_align(a, b, p) for a, b in pairs]

    params = AlignParams(*p)
    res = batch.align_batch(pairs, params, swap=False)
    for r, got in zip(refs, res):
        assert (int(r.score), int(r.last)) == (got.score, got.last)

    out = batch.align_batch(pairs, params, traced=True, swap=False)
    for (a, b), r, (s, c, aln) in zip(pairs, refs, out):
        assert int(r.score) == int(s) and int(r.last) == int(c)
        assert tb.score_alignment(aln.a_row, aln.b_row, params) == int(c)
        assert aln.a_row.replace(b"-", b"") == a.tobytes()
        assert aln.b_row.replace(b"-", b"") == b.tobytes()
