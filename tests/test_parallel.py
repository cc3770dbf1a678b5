"""Multi-device tests on the virtual 8-device CPU mesh (conftest sets
xla_force_host_platform_device_count=8; SURVEY.md section 4 plan item d)."""

import numpy as np
import pytest

from tsta_tpu.config import AlignParams
from tsta_tpu.ops import psa_scan, traceback
from tsta_tpu.parallel import batch, longseq
from tsta_tpu.parallel import mesh as meshlib


@pytest.fixture(scope="module")
def mesh24():
    return meshlib.make_mesh(data=2, seq=4)


@pytest.fixture(scope="module")
def mesh81():
    return meshlib.make_mesh(data=8, seq=1)


def test_mesh_shapes(mesh24):
    assert mesh24.shape == {"data": 2, "seq": 4}


def test_batch_sharded_matches_oracle(mesh81):
    rng = np.random.default_rng(11)
    pairs = []
    for _ in range(11):  # deliberately not a multiple of 8
        n, m = int(rng.integers(20, 300)), int(rng.integers(20, 300))
        pairs.append((rng.integers(65, 69, n).astype(np.uint8),
                      rng.integers(65, 69, m).astype(np.uint8)))
    res = batch.align_batch(pairs, AlignParams(), mesh=mesh81)
    for (a, b), r in zip(pairs, res):
        if len(b) > len(a):
            a, b = b, a
        ref = psa_scan.psa_align(a, b, AlignParams())
        assert r.score == int(ref.score)
        assert r.last == int(ref.last)


def test_batch_traced_planes(mesh81):
    rng = np.random.default_rng(5)
    pairs = [(rng.integers(65, 69, 100).astype(np.uint8),
              rng.integers(65, 69, 80).astype(np.uint8))
             for _ in range(4)]
    res = batch.align_batch(pairs, AlignParams(), traced=True, mesh=mesh81)
    for (a, b), r in zip(pairs, res):
        ref = psa_scan.psa_align(a, b, AlignParams(), traced=True)
        aln = traceback.decode_pair(np.asarray(ref.back),
                                    np.asarray(ref.fback),
                                    np.asarray(ref.eback), a, b)
        assert (r.score, r.last, r.aln) == (int(ref.score), int(ref.last),
                                            aln)


@pytest.mark.parametrize("seed", range(3))
def test_longseq_sharded_matches_oracle(mesh24, seed):
    rng = np.random.default_rng(seed)
    n, m = int(rng.integers(64, 1200)), int(rng.integers(20, 300))
    a = rng.integers(65, 69, n).astype(np.uint8)
    b = rng.integers(65, 69, m).astype(np.uint8)
    p = AlignParams() if seed % 2 == 0 else AlignParams(3, -2, -1, -6)
    best, corner = longseq.align_long(a, b, p, mesh=mesh24)
    ref = psa_scan.psa_align(a, b, p)
    assert best == int(ref.score)
    assert corner == int(ref.last)


def test_graft_entry_dryrun():
    import __graft_entry__ as ge
    ge.dryrun_multichip(8)


def test_graft_entry_forward():
    import jax

    import __graft_entry__ as ge
    fn, args = ge.entry()
    best, corner = jax.jit(fn)(*args)
    assert best.shape == (4,)


def test_msa_sharded_round_matches_native(mesh24):
    from tsta_tpu.ops import msa_native
    rng = np.random.default_rng(31)
    bases = np.frombuffer(b"ACGT", np.uint8)

    def mut(s, rate=0.1):
        s = np.frombuffer(s, np.uint8).copy()
        m = rng.random(len(s)) < rate
        s[m] = bases[rng.integers(0, 4, m.sum())]
        return s.tobytes()

    seqs = [bases[rng.integers(0, 4, 250)].tobytes()]
    for _ in range(3):
        seqs.append(mut(seqs[0]))
    ref = msa_native.align_seqs(seqs, AlignParams())
    shd = msa_native.align_seqs(seqs, AlignParams(), mesh=mesh24)
    assert shd.round_scores == ref.round_scores
    assert shd.rows == ref.rows
    assert shd.consensus == ref.consensus


def test_msa_sharded_gap_run_crosses_shard_boundary(mesh24):
    """Regression: an F gap run spanning a shard boundary must decode
    identically to the unsharded engine (the boundary cell's 'extend'
    mark needs the left shard's F exit value)."""
    from tsta_tpu.ops import msa_native
    rng = np.random.default_rng(0)
    bases = np.frombuffer(b"ACGT", np.uint8)
    s1 = bases[rng.integers(0, 4, 120)].tobytes()
    s2 = s1[:60] + bases[rng.integers(0, 4, 300)].tobytes() + s1[60:]
    ref = msa_native.align_seqs([s1, s2], AlignParams())
    shd = msa_native.align_seqs([s1, s2], AlignParams(), mesh=mesh24)
    assert shd.rows == ref.rows
    assert shd.round_scores == ref.round_scores


def test_batch_sharded_matches_unsharded(mesh81):
    """Per-pair results of a batch sharded over the data axis equal the
    single-device run."""
    rng = np.random.default_rng(21)
    pairs = []
    for _ in range(13):  # not a multiple of 8
        n, m = int(rng.integers(30, 400)), int(rng.integers(30, 400))
        pairs.append((rng.integers(65, 69, n).astype(np.uint8),
                      rng.integers(65, 69, m).astype(np.uint8)))
    assert (batch.align_batch(pairs, mesh=mesh81)
            == batch.align_batch(pairs))


def test_traced_batch_sharded_matches_unsharded(mesh24):
    """Traced batches shard over the data axis: scores, corners and
    alignments equal the single-device run (pairs are independent, so
    the sharded program has no collectives)."""
    rng = np.random.default_rng(41)
    pairs = []
    for _ in range(5):  # not a multiple of the data axis
        n = int(rng.integers(60, 260))
        m = int(rng.integers(40, n + 1))
        pairs.append((rng.integers(65, 69, n).astype(np.uint8),
                      rng.integers(65, 69, m).astype(np.uint8)))
    assert (batch.align_batch(pairs, traced=True, mesh=mesh24)
            == batch.align_batch(pairs, traced=True))


def test_traced_manifest_sharded(mesh81, tmp_path):
    """align_manifest threads the mesh through to the traced batch."""
    rng = np.random.default_rng(43)
    lines = []
    for k in range(3):
        paths = []
        for side, n in (("a", 150), ("b", 120)):
            p = tmp_path / ("%d%s.fa" % (k, side))
            p.write_bytes(b">s\n" + rng.choice(
                np.frombuffer(b"ACGT", np.uint8), n).tobytes() + b"\n")
            paths.append(str(p))
        lines.append("p%d\t%s\t%s\n" % (k, paths[0], paths[1]))
    man = tmp_path / "pairs.tsv"
    man.write_text("".join(lines))
    one = batch.align_manifest(str(man), traced=True,
                               out_dir=str(tmp_path / "one"))
    shd = batch.align_manifest(str(man), traced=True, mesh=mesh81,
                               out_dir=str(tmp_path / "shd"))
    assert one == shd
    for k in range(3):
        name = "p%d.txt" % k
        assert ((tmp_path / "one" / name).read_bytes()
                == (tmp_path / "shd" / name).read_bytes())


def test_batch_sharded_on_2d_mesh(mesh24):
    rng = np.random.default_rng(22)
    pairs = [(rng.integers(65, 69, 200).astype(np.uint8),
              rng.integers(65, 69, 180).astype(np.uint8))
             for _ in range(3)]
    assert (batch.align_batch(pairs, mesh=mesh24)
            == batch.align_batch(pairs))


def test_traced_sharded_groups_over_budget(mesh24, monkeypatch):
    """A sharded traced batch whose planes exceed the group budget splits
    into several sharded calls; results equal the unconstrained run."""
    rng = np.random.default_rng(47)
    pairs = []
    for _ in range(10):
        n = int(rng.integers(60, 120))
        m = int(rng.integers(40, n + 1))
        pairs.append((rng.integers(65, 69, n).astype(np.uint8),
                      rng.integers(65, 69, m).astype(np.uint8)))
    ref = batch.align_batch(pairs, traced=True)
    calls = []
    orig = batch._align_group

    def spy(group, *args):
        calls.append(len(group))
        return orig(group, *args)
    monkeypatch.setattr(batch, "_align_group", spy)
    monkeypatch.setattr(batch, "TRACED_GROUP_BYTES", 2 * 3 * 128 * 128)
    shd = batch.align_batch(pairs, traced=True, mesh=mesh24)
    assert len(calls) >= 2, "expected the batch to split into groups"
    assert max(calls) <= 2 * 2      # two pairs per device, data axis 2
    assert shd == ref
