"""Mixed-shape batches + manifest resume."""

import numpy as np

from tsta_tpu.config import AlignParams
from tsta_tpu.ops import psa_scan
from tsta_tpu.parallel import batch


def test_pallas_batch_matches_oracle():
    rng = np.random.default_rng(5)
    pairs = [(rng.integers(65, 69, int(rng.integers(30, 300))).astype(
        np.uint8),
        rng.integers(65, 69, int(rng.integers(30, 300))).astype(np.uint8))
        for _ in range(5)]
    res = batch.align_batch(pairs, AlignParams(), swap=False)
    for (a, b), r in zip(pairs, res):
        ref = psa_scan.psa_align(a, b, (2, -5, -2, -4))
        assert int(ref.score) == r.score and int(ref.last) == r.last


def _write_pair(tmp_path, name, rng, n, m):
    a = rng.integers(65, 69, n).astype(np.uint8)
    b = rng.integers(65, 69, m).astype(np.uint8)
    f1 = tmp_path / (name + "_a.fa")
    f2 = tmp_path / (name + "_b.fa")
    f1.write_bytes(b">a\n" + a.tobytes() + b"\n")
    f2.write_bytes(b">b\n" + b.tobytes() + b"\n")
    return str(f1), str(f2)


def test_manifest_resume(tmp_path):
    rng = np.random.default_rng(3)
    manifest = tmp_path / "pairs.tsv"
    lines = []
    for i in range(4):
        f1, f2 = _write_pair(tmp_path, "p%d" % i, rng, 150, 120)
        lines.append("p%d\t%s\t%s" % (i, f1, f2))
    manifest.write_text("\n".join(lines) + "\n")
    store = str(tmp_path / "done.jsonl")

    r1 = batch.align_manifest(str(manifest), AlignParams(), resume=store)
    assert len(r1) == 4
    # second run: everything skipped, results identical
    r2 = batch.align_manifest(str(manifest), AlignParams(), resume=store)
    assert sorted(r["name"] for r in r2) == sorted(r["name"] for r in r1)
    assert {r["name"]: r["score"] for r in r2} == \
        {r["name"]: r["score"] for r in r1}


def test_manifest_traced_outputs(tmp_path):
    """align_manifest traced mode writes per-pair alignment files whose
    rows reconstruct the inputs (covers the longer-horizontal re-encode
    swap in the scan fallback path)."""
    import numpy as np

    from tsta_tpu.config import AlignParams
    from tsta_tpu.parallel import batch as pbatch

    rng = np.random.default_rng(4)
    lines = []
    for i, (n, m) in enumerate([(80, 120), (150, 60)]):  # both swap dirs
        fa1 = tmp_path / ("a%d.fa" % i)
        fa2 = tmp_path / ("b%d.fa" % i)
        s1 = rng.choice(np.frombuffer(b"ACGT", np.uint8), n).tobytes()
        s2 = rng.choice(np.frombuffer(b"ACGT", np.uint8), m).tobytes()
        fa1.write_bytes(b">s\n" + s1 + b"\n")
        fa2.write_bytes(b">s\n" + s2 + b"\n")
        lines.append(("p%d" % i, str(fa1), str(fa2), s1, s2))
    man = tmp_path / "pairs.tsv"
    man.write_text("".join("%s\t%s\t%s\n" % l[:3] for l in lines))
    out_dir = tmp_path / "alns"
    rows = pbatch.align_manifest(str(man), AlignParams(), traced=True,
                                 out_dir=str(out_dir))
    assert len(rows) == 2
    for name, _, _, s1, s2 in lines:
        data = (out_dir / (name + ".txt")).read_bytes()
        r1 = data.split(b">1\n")[1].split(b"\n>2\n")[0]
        r2 = data.split(b"\n>2\n")[1]
        # rows reconstruct the two inputs (longer sequence is row 1)
        long_s, short_s = (s1, s2) if len(s1) >= len(s2) else (s2, s1)
        assert r1.replace(b"-", b"") == long_s
        assert r2.replace(b"-", b"") == short_s
        assert len(r1) == len(r2)
