"""Differential fuzzing against the *reference binaries* (if present).

Stronger evidence than vendored goldens: random inputs generated at test
time, reference run fresh, outputs compared byte-for-byte.  Skipped when
the reference build is unavailable (binaries live outside the repo).

PSA sequence lengths are multiples of L=160: for other lengths the
reference pads seq1 with uninitialised heap bytes (psa.c:202-207), making
its own output environment-dependent.  MSA pads with 'N' (deterministic),
so any lengths go.
"""

import os
import subprocess

import numpy as np
import pytest

from tsta_tpu.config import AlignParams
from tsta_tpu.models import msa, psa

REF = "/tmp/refbuild"
BASES = np.frombuffer(b"ACGT", np.uint8)

pytestmark = pytest.mark.skipif(
    not os.path.exists(REF + "/TSTA_psa"),
    reason="reference binaries not built (see /tmp/refbuild)")


def _mutate(rng, s, rate=0.12, n_rate=0.0):
    s = np.frombuffer(s, np.uint8).copy()
    mask = rng.random(len(s)) < rate
    s[mask] = BASES[rng.integers(0, 4, mask.sum())]
    if n_rate:
        # genuine ambiguity codes: the reference's SN blend
        # (c-t-simd.c:461,481) makes read-'N' columns score-neutral in
        # a path-dependent way -- parity must hold for them too
        nmask = rng.random(len(s)) < n_rate
        s[nmask] = ord("N")
    out = list(s.tobytes())
    for _ in range(max(1, len(out) // 80)):
        pos = int(rng.integers(0, len(out)))
        if rng.random() < 0.5:
            del out[pos:pos + int(rng.integers(1, 4))]
        else:
            ins = BASES[rng.integers(0, 4, int(rng.integers(1, 4)))]
            out[pos:pos] = list(ins.tobytes())
    return bytes(out)


@pytest.mark.slow
@pytest.mark.parametrize("seed", range(4))
def test_psa_fuzz_vs_binary(tmp_path, seed):
    rng = np.random.default_rng(1000 + seed)
    n = int(rng.integers(1, 5)) * 160
    m = int(rng.integers(1, 5)) * 160
    s1 = BASES[rng.integers(0, 4, n)].tobytes()
    n_rate = 0.04 if seed % 2 == 1 else 0.0   # psa.c has no N rule --
    s2 = (_mutate(rng, s1, n_rate=n_rate)     # N is an ordinary byte
          + BASES[rng.integers(0, 4, m)].tobytes())[:m]
    f1, f2 = tmp_path / "a.fa", tmp_path / "b.fa"
    f1.write_bytes(b">a\n" + s1 + b"\n")
    f2.write_bytes(b">b\n" + s2 + b"\n")
    extra = [] if seed % 2 == 0 else ["-X", "-3", "-O", "-6"]
    params = AlignParams() if seed % 2 == 0 else \
        AlignParams(mismatch=-3, gap_open=-6)
    ref_out = tmp_path / "ref.txt"
    r = subprocess.run(
        [REF + "/TSTA_psa", "-1", str(f1), "-2", str(f2),
         "-o", str(ref_out)] + extra, capture_output=True, check=True)
    out = psa.align_files(str(f1), str(f2), params, traced=True,
                          kernel="scan")
    assert b"maxsorce=%d" % out.score == r.stdout.strip()
    my = tmp_path / "my.txt"
    psa.write_alignment(out, str(my))
    assert my.read_bytes() == ref_out.read_bytes()


@pytest.mark.slow
@pytest.mark.parametrize("seed", range(3))
def test_msa_fuzz_vs_binary(tmp_path, seed):
    rng = np.random.default_rng(2000 + seed)
    k = int(rng.integers(3, 7))
    base = BASES[rng.integers(0, 4, int(rng.integers(80, 400)))].tobytes()
    n_rate = 0.05 if seed % 3 == 0 else 0.0   # N-containing reads too
    seqs = [base] + [_mutate(rng, base, n_rate=n_rate)
                     for _ in range(k - 1)]
    fa = tmp_path / "seqs.fa"
    with open(fa, "wb") as f:
        for i, s in enumerate(seqs):
            f.write(b">s%d\n" % i + s + b"\n")
    extra = [] if seed % 2 == 0 else ["-X", "-3"]
    params = AlignParams() if seed % 2 == 0 else AlignParams(mismatch=-3)
    ref_out = tmp_path / "ref.txt"
    subprocess.run([REF + "/TSTA_msa", "-i", str(fa), "-o", str(ref_out)]
                   + extra, capture_output=True, check=True)
    out = msa.align_file(str(fa), params)
    my = tmp_path / "my.txt"
    msa.write_result(out, str(my))
    assert my.read_bytes() == ref_out.read_bytes()


@pytest.mark.slow
def test_msa_fuzz_vs_binary_mixed_alphabet(tmp_path):
    """The engines are byte-equality-agnostic like the reference: a
    mixed-case DNA + protein-letter alphabet must stay byte-identical
    (only 'N' has a special rule, c-t-simd.c:461; lowercase 'n' does
    NOT trigger it -- this pins that too)."""
    rng = np.random.default_rng(2100)
    alpha = np.frombuffer(b"ACGTacgtnKRWY", np.uint8)
    base = alpha[rng.integers(0, len(alpha), 200)].tobytes()
    seqs = [base]
    for _ in range(3):
        s = np.frombuffer(base, np.uint8).copy()
        m = rng.random(len(s)) < 0.1
        s[m] = alpha[rng.integers(0, len(alpha), int(m.sum()))]
        seqs.append(s.tobytes())
    fa = tmp_path / "seqs.fa"
    with open(fa, "wb") as f:
        for i, s in enumerate(seqs):
            f.write(b">s%d\n" % i + s + b"\n")
    ref_out = tmp_path / "ref.txt"
    subprocess.run([REF + "/TSTA_msa", "-i", str(fa), "-o",
                    str(ref_out)], capture_output=True, check=True)
    out = msa.align_file(str(fa), AlignParams())
    my = tmp_path / "my.txt"
    msa.write_result(out, str(my))
    assert my.read_bytes() == ref_out.read_bytes()


@pytest.mark.slow
@pytest.mark.parametrize("seed", range(3))
def test_batch_kernel_fuzz_vs_binary(tmp_path, seed):
    """The batch path's scores vs the reference binary, run fresh per
    pair.  Lengths are L=160 multiples
    (reference heap-padding quirk); swap semantics replicated by
    align_batch."""
    from tsta_tpu.parallel import batch as pbatch

    rng = np.random.default_rng(3000 + seed)
    pairs, expected = [], []
    for k in range(5):
        n = int(rng.integers(1, 6)) * 160
        m = int(rng.integers(1, 6)) * 160
        s1 = BASES[rng.integers(0, 4, n)].tobytes()
        s2 = (_mutate(rng, s1) + BASES[rng.integers(0, 4, m)].tobytes())[:m]
        f1 = tmp_path / ("a%d.fa" % k)
        f2 = tmp_path / ("b%d.fa" % k)
        f1.write_bytes(b">a\n" + s1 + b"\n")
        f2.write_bytes(b">b\n" + s2 + b"\n")
        r = subprocess.run(
            [REF + "/TSTA_psa_notrace", "-1", str(f1), "-2", str(f2),
             "-o", str(tmp_path / "o.txt")],
            capture_output=True, check=True)
        expected.append(int(r.stdout.split(b"=")[1]))
        pairs.append((np.frombuffer(s1, np.uint8),
                      np.frombuffer(s2, np.uint8)))
    res = pbatch.align_batch(pairs, AlignParams())
    got = [r.score for r in res]
    assert got == expected


@pytest.mark.slow
@pytest.mark.parametrize("seed", range(3))
def test_traced_packed_fuzz_vs_binary(tmp_path, seed):
    """The traced batch path vs the reference TSTA_psa alignments,
    byte-for-byte.  Lengths are L=160 multiples (reference heap-padding
    quirk)."""
    from tsta_tpu.parallel import batch as pbatch

    rng = np.random.default_rng(4000 + seed)
    pairs, expected = [], []
    for k in range(4):
        n = int(rng.integers(1, 6)) * 160
        m = int(rng.integers(1, (n // 160) + 1)) * 160
        s1 = BASES[rng.integers(0, 4, n)].tobytes()
        s2 = (_mutate(rng, s1) + BASES[rng.integers(0, 4, m)].tobytes())[:m]
        f1 = tmp_path / ("a%d.fa" % k)
        f2 = tmp_path / ("b%d.fa" % k)
        f1.write_bytes(b">a\n" + s1 + b"\n")
        f2.write_bytes(b">b\n" + s2 + b"\n")
        ref_out = tmp_path / ("ref%d.txt" % k)
        r = subprocess.run(
            [REF + "/TSTA_psa", "-1", str(f1), "-2", str(f2),
             "-o", str(ref_out)], capture_output=True, check=True)
        expected.append((int(r.stdout.split(b"=")[1]),
                         ref_out.read_bytes()))
        pairs.append((np.frombuffer(s1, np.uint8),
                      np.frombuffer(s2, np.uint8)))
    out = pbatch.align_batch(pairs, AlignParams(), traced=True, swap=False)
    for (s, c, aln), (escore, eout) in zip(out, expected):
        assert s == escore
        assert b">1\n" + aln.a_row + b"\n>2\n" + aln.b_row == eout
