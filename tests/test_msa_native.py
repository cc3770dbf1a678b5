"""Tests for the native (exact int32) MSA engine."""

import numpy as np
import pytest

from tsta_tpu.config import AlignParams
from tsta_tpu.models import msa
from tsta_tpu.ops import msa_native, psa_scan

BASES = np.frombuffer(b"ACGT", np.uint8)


def _mutate(rng, s, rate=0.1):
    s = np.frombuffer(s, np.uint8).copy()
    mask = rng.random(len(s)) < rate
    s[mask] = BASES[rng.integers(0, 4, mask.sum())]
    return s.tobytes()


@pytest.mark.parametrize("seed", range(3))
def test_two_seq_round_equals_pairwise_corner(seed):
    """For 2 sequences, POA round 1 == global pairwise alignment."""
    rng = np.random.default_rng(seed)
    s1 = BASES[rng.integers(0, 4, 120)].tobytes()
    s2 = _mutate(rng, s1)
    p = AlignParams() if seed % 2 == 0 else AlignParams(3, -2, -1, -6)
    out = msa_native.align_seqs([s1, s2], p)
    ref = psa_scan.psa_align(np.frombuffer(s2, np.uint8),
                             np.frombuffer(s1, np.uint8), p)
    assert out.round_scores[0] == int(ref.last)
    for row, s in zip(out.rows, [s1, s2]):
        assert row.replace(b"-", b"") == s


def test_multiseq_rows_reconstruct():
    rng = np.random.default_rng(7)
    seqs = [BASES[rng.integers(0, 4, 150)].tobytes()]
    for _ in range(4):
        seqs.append(_mutate(rng, seqs[0], 0.08))
    out = msa_native.align_seqs(seqs)
    assert len(out.rows) == 5
    for row, s in zip(out.rows, seqs):
        assert row.replace(b"-", b"") == s
    assert len({len(r) for r in out.rows}) == 1
    assert len(out.consensus) > 0


def test_native_matches_compat_on_fixtures(golden_dir):
    """Without clamp activity the exact engine reproduces compat scores."""
    from tsta_tpu.io import read_fasta
    import os
    seqs = [r.sequence for r in
            read_fasta(os.path.join(golden_dir, "msa_small1/seqs.fa"))]
    c = msa.align_seqs(seqs, AlignParams(), engine="compat")
    n = msa.align_seqs(seqs, AlignParams(), engine="native")
    assert n.round_scores == c.round_scores


def test_engine_dispatch():
    with pytest.raises(ValueError):
        msa.align_seqs([b"ACGT"], engine="bogus")


def test_native_checkpoint_resume(tmp_path):
    rng = np.random.default_rng(9)
    seqs = [BASES[rng.integers(0, 4, 80)].tobytes()]
    for _ in range(3):
        seqs.append(_mutate(rng, seqs[0]))
    full = msa_native.align_seqs(seqs, AlignParams())
    ck = str(tmp_path / "g.npz")
    out1 = msa_native.align_seqs(seqs, AlignParams(), checkpoint_path=ck)
    assert out1.round_scores == full.round_scores
    # resume from the complete snapshot: no rounds re-run, same output
    out2 = msa_native.align_seqs(seqs, AlignParams(), checkpoint_path=ck)
    assert out2.rows == full.rows and out2.consensus == full.consensus
    # different params must invalidate the snapshot
    out3 = msa_native.align_seqs(seqs, AlignParams(mismatch=-3),
                                 checkpoint_path=str(tmp_path / "g2.npz"))
    assert len(out3.round_scores) == 3


@pytest.mark.parametrize("seed", [3000, 3004, 3007, 3011])
def test_cross_engine_scores_fuzz(seed):
    """On realistic inputs the exact engine reproduces the compat
    engine's round scores (reference clamps don't fire at ~7%
    divergence) -- two independent implementations cross-check."""
    rng = np.random.default_rng(seed)
    base = BASES[rng.integers(0, 4, int(rng.integers(60, 250)))].tobytes()
    seqs = [base]
    for _ in range(int(rng.integers(2, 5))):
        s = np.frombuffer(base, np.uint8).copy()
        m = rng.random(len(s)) < 0.07
        s[m] = BASES[rng.integers(0, 4, m.sum())]
        seqs.append(s.tobytes())
    c = msa.align_seqs(seqs, AlignParams(), engine="compat")
    n = msa.align_seqs(seqs, AlignParams(), engine="native")
    assert c.round_scores == n.round_scores


def test_native_toposort_matches_python(monkeypatch):
    """native/poa_fast.c's Kahn emits the BIT-IDENTICAL order to the
    Python implementation (round-score parity depends on it), across
    progressive fuzz graphs with variant rings."""
    import numpy as np

    from tsta_tpu.config import AlignParams
    from tsta_tpu.ops import msa_native

    rng = np.random.default_rng(41)
    bases = np.frombuffer(b"ACGT", np.uint8)
    for trial in range(4):
        base = rng.choice(bases, int(rng.integers(150, 400))).tobytes()
        seqs = [base]
        for _ in range(3):
            s = np.frombuffer(base, np.uint8).copy()
            m = rng.random(len(s)) < 0.12
            s[m] = bases[rng.integers(0, 4, m.sum())]
            seqs.append(np.delete(
                s, rng.integers(0, len(s), len(s) // 25)).tobytes())
        monkeypatch.setenv("TSTA_NATIVE_TOPO", "force")
        out_c = msa_native.align_seqs(seqs, AlignParams())
        monkeypatch.setenv("TSTA_NATIVE_TOPO", "0")
        out_py = msa_native.align_seqs(seqs, AlignParams())
        assert out_c.round_scores == out_py.round_scores
        assert out_c.rows == out_py.rows
        assert out_c.consensus == out_py.consensus


def test_native_merge_matches_python(monkeypatch):
    """native/poa_fast.c's tsta_poa_merge mutates the graph buffers
    BIT-IDENTICALLY to the Python merge loop (the semantics reference),
    across fuzzed rounds with insertions, mismatch-variant creation and
    ring reuse."""
    import copy

    import numpy as np

    from tsta_tpu.models.poa_graph import PoaGraph
    from tsta_tpu.ops import msa_native

    rng = np.random.default_rng(17)
    abc = np.frombuffer(b"ACGT", np.uint8)

    def rand_seq(n):
        return rng.choice(abc, n).tobytes()

    def clone(g):
        g2 = PoaGraph(g.n_seq)
        for f in PoaGraph.__slots__:
            v = getattr(g, f)
            setattr(g2, f, v.copy() if isinstance(v, np.ndarray)
                    else copy.deepcopy(v))
        return g2

    for trial in range(10):
        g1 = PoaGraph.from_sequence(rand_seq(int(rng.integers(5, 60))), 4)
        g1.toposort()
        for sno in (1, 2, 3):
            seq = rand_seq(int(rng.integers(3, 70)))
            order = list(g1.topo)
            n = len(seq)
            # plausible align_rows: increasing topo rows with -1 gaps
            rows = sorted(rng.choice(
                len(order), size=min(n, len(order)),
                replace=False).tolist())
            ar = np.full(n, -1, np.int64)
            take = rng.random(n) < 0.7
            ri = 0
            for j in range(n):
                if take[j] and ri < len(rows):
                    ar[j] = rows[ri]
                    ri += 1
            g2 = clone(g1)
            monkeypatch.setenv("TSTA_NATIVE_MERGE", "1")
            a1 = msa_native._merge(g1, seq, sno, order, ar)
            monkeypatch.setenv("TSTA_NATIVE_MERGE", "0")
            a2 = msa_native._merge(g2, seq, sno, order, ar)
            assert a1 == a2
            assert g1.bases == g2.bases
            assert g1.preds == g2.preds
            assert g1.weights == g2.weights
            assert g1.variants == g2.variants
            assert [p.tolist() for p in g1.passing] == \
                [p.tolist() for p in g2.passing]
            g1.toposort()


def test_merge_ring_double_hit(monkeypatch):
    """Non-path align_rows may consume two members of one variant ring
    in a single round (real walks cannot, but fuzz / foreign deltas
    can).  The merge must stay loud-or-correct: both engines grow
    capacity as needed and produce identical graphs."""
    import copy

    import numpy as np

    from tsta_tpu.models.poa_graph import PoaGraph
    from tsta_tpu.ops import msa_native

    def clone(g):
        g2 = PoaGraph(g.n_seq)
        for f in PoaGraph.__slots__:
            v = getattr(g, f)
            setattr(g2, f, v.copy() if isinstance(v, np.ndarray)
                    else copy.deepcopy(v))
        return g2

    # chain A-C-G with a full variant ring at the middle column
    g = PoaGraph.from_sequence(b"ACG", 6)
    order0 = list(g.toposort())
    # create variants T and N at column 1 via two adversarial merges
    msa_native._merge(g, b"T", 1, order0, np.asarray([1]))
    g.toposort()
    msa_native._merge(g, b"N", 2, list(g.topo),
                      np.asarray([g.topo.index(1)]))
    g.toposort()
    assert sorted(g.variants[1]) == [3, 4]
    order = list(g.topo)
    # one round hitting BOTH ring members 1 and 3 with new bases each:
    # ring growth of 2 in one merge (breaches the valid-path +1 bound)
    r1, r3 = order.index(1), order.index(3)
    lo, hi = min(r1, r3), max(r1, r3)
    seq = b"XY"
    ar = np.asarray([lo, hi])
    g_c, g_p = clone(g), clone(g)
    monkeypatch.setenv("TSTA_NATIVE_MERGE", "1")
    a1 = msa_native._merge(g_c, seq, 3, order, ar)
    monkeypatch.setenv("TSTA_NATIVE_MERGE", "0")
    a2 = msa_native._merge(g_p, seq, 4, order, ar)
    assert a1 == a2 == 2
    assert g_c.bases == g_p.bases
    assert g_c.preds == g_p.preds
    assert g_c.variants == g_p.variants
    # the column's ring now holds 4 variants (A/T/N/X/Y share it)
    assert len(g_c.variants[1]) == 4
    # out-of-range rows fail loudly, never clamp
    import pytest
    with pytest.raises(ValueError):
        msa_native._merge(clone(g), b"A", 3, order,
                          np.asarray([len(order)]))
