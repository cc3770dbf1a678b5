"""The native MSA scan engine (ops/msa_native.py) on the corpora that
used to compare it with a POA round kernel, now checked against the
bit-exact compat engine; plus its device-memory refusal, the padded dump
row, and the pipelined fleet runner."""

import copy

import numpy as np
import pytest

from tsta_tpu.config import AlignParams
from tsta_tpu.models import msa
from tsta_tpu.models.poa_graph import PoaGraph
from tsta_tpu.ops import msa_native, route
from tsta_tpu.ops.msa_native import _fuse, _merge, _walk_host


def _mutate(rng, base, div):
    b = bytearray(base)
    for i in rng.integers(0, len(b), max(1, int(len(b) * div))):
        b[i] = b"ACGT"[rng.integers(0, 4)]
    for _ in range(max(1, int(len(b) * div / 8))):
        j = int(rng.integers(0, len(b) - 2))
        del b[j]
    return bytes(b)


def _corpus(seed, n_reads=4, div=0.1):
    rng = np.random.default_rng(seed)
    base = rng.choice(np.frombuffer(b"ACGT", np.uint8),
                      100 + 60 * (seed % 3)).tobytes()
    return [_mutate(rng, base, div) for _ in range(n_reads)]


@pytest.mark.parametrize("seed", range(6))
def test_scan_engine_matches_compat(seed):
    """On these clamp-free corpora the exact engine and the reference's
    int8 engine agree on every round score, row and the consensus."""
    seqs = _corpus(seed)
    nat = msa.align_seqs(seqs, AlignParams(), engine="native")
    com = msa.align_seqs(seqs, AlignParams(), engine="compat")
    assert nat.round_scores == com.round_scores
    assert nat.rows == com.rows
    assert nat.consensus == com.consensus


def _grown_graph(seed):
    seqs = _corpus(seed, n_reads=3)
    g = PoaGraph.from_sequence(seqs[0], 4)
    for s_no in range(1, 3):
        msa_native._select_and_fuse(
            g, seqs[s_no], s_no,
            *msa_native._scan_engine_round(g, seqs[s_no], AlignParams()))
        g.toposort()
    return g, seqs


def test_walk_host_merge_refactor_roundtrip():
    """_fuse == _walk_host + _merge (refactor regression)."""
    g, seqs = _grown_graph(3)
    new = _mutate(np.random.default_rng(3), seqs[0], 0.1)
    ss, packed, hp, ep, preds, order = msa_native._scan_engine_round(
        g, new, AlignParams())
    sinks = set(g.sinks())
    rows = [i for i, v in enumerate(order) if v in sinks]
    best = max(rows, key=lambda i: ss[i])
    g2 = copy.deepcopy(g)
    a1 = _fuse(g, new, 2, order, packed, hp, ep, preds, best)
    walk = _walk_host(packed, hp, ep, preds, best, len(new))
    a2 = _merge(g2, new, 2, order, walk)
    assert a1 == a2
    assert g.bases == g2.bases
    assert g.preds == g2.preds


@pytest.mark.parametrize("seed", range(3))
def test_padded_rows_write_the_dump_row(seed):
    """Bucket-padded graph rows update only the dump row: the real rows'
    sink scores and planes are those of an unpadded-equivalent run
    (checked through the 2-read identity with pairwise Gotoh)."""
    from tsta_tpu.ops import psa_scan
    rng = np.random.default_rng(50 + seed)
    s1 = rng.choice(np.frombuffer(b"ACGT", np.uint8), 90 + seed).tobytes()
    s2 = _mutate(rng, s1, 0.1)
    out = msa_native.align_seqs([s1, s2], AlignParams())
    ref = psa_scan.psa_align(np.frombuffer(s2, np.uint8),
                             np.frombuffer(s1, np.uint8), AlignParams())
    assert out.round_scores == [int(ref.last)]


def test_round_bytes_counts_buffers_and_planes():
    # H and E int32 with a virtual and a dump row, three int8 planes
    assert msa_native.round_bytes(100, 256) == 8 * 102 * 256 + 3 * 100 * 256


def test_round_over_device_memory_raises(monkeypatch):
    """A round that cannot fit the device is refused with a clear error
    naming the compat engine, before anything is allocated."""
    calls = []
    monkeypatch.setattr(route, "device_bytes_free", lambda: 10 ** 5)
    monkeypatch.setattr(msa_native, "_round_dp",
                        lambda *a, **k: calls.append(1))
    seqs = _corpus(1, n_reads=3)
    with pytest.raises(ValueError, match="engine='compat'"):
        msa_native.align_seqs(seqs, AlignParams())
    with pytest.raises(ValueError, match="engine='compat'"):
        msa_native.align_seqs_many([seqs], AlignParams())
    assert not calls


def test_round_within_device_memory_runs(monkeypatch):
    seqs = _corpus(2, n_reads=3)
    ref = msa_native.align_seqs(seqs, AlignParams())
    monkeypatch.setattr(route, "device_bytes_free", lambda: 10 ** 9)
    assert msa_native.align_seqs(seqs, AlignParams()) == ref


def test_align_seqs_many_matches_single():
    """Pipelined multi-problem runner == per-problem runs."""
    rng = np.random.default_rng(9)
    sets = []
    for _ in range(3):
        base = rng.choice(np.frombuffer(b"ACGT", np.uint8),
                          int(rng.integers(80, 160))).tobytes()
        sets.append([_mutate(rng, base, 0.1) for _ in range(3)])
    sets.append([sets[0][0]])            # a single read: self-alignment
    outs = msa_native.align_seqs_many(sets, AlignParams())
    for seqs, out in zip(sets, outs):
        assert out == msa_native.align_seqs(seqs, AlignParams())


def test_align_seqs_many_high_in_degree(monkeypatch):
    """A graph node with more than 64 predecessors runs like any other
    (the scan engine has no in-degree cap)."""
    rng = np.random.default_rng(2)
    base = rng.choice(np.frombuffer(b"ACGT", np.uint8), 60).tobytes()
    seqs = [base, _mutate(rng, base, 0.1), _mutate(rng, base, 0.1)]
    orig_from = PoaGraph.from_sequence

    def hacked(seq, n_seq):
        g = orig_from(seq, n_seq)
        tail = len(g) - 1
        for _ in range(65):
            w = g.add_node(ord("A"), 0)
            g.add_edge(w, tail)
        g.toposort()
        return g

    monkeypatch.setattr(PoaGraph, "from_sequence", staticmethod(hacked))
    outs = msa_native.align_seqs_many([seqs], AlignParams())
    assert len(outs[0].round_scores) == 2
    assert outs[0] == msa_native.align_seqs(seqs, AlignParams())
