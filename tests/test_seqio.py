import gzip
import io
import os

import pytest

from tsta_tpu.io import (SeqRecord, read_fasta, read_fastq, read_records,
                         write_fasta, write_fastq)

EXAMPLE = os.path.join(os.path.dirname(__file__), "golden", "example_big")


def test_read_fasta_basic(tmp_path):
    p = tmp_path / "x.fa"
    p.write_bytes(b">one a comment\nACGT\nACGT\n>two\nGGGG\n")
    recs = list(read_fasta(p))
    assert [r.name for r in recs] == ["one", "two"]
    assert recs[0].comment == "a comment"
    assert recs[0].sequence == b"ACGTACGT"
    assert recs[1].sequence == b"GGGG"
    assert not recs[0].is_fastq


def test_read_fasta_crlf_and_blank_lines(tmp_path):
    p = tmp_path / "x.fa"
    p.write_bytes(b"\n>one\r\nAC\r\nGT\r\n\r\n>two\r\nTT\r\n")
    recs = list(read_fasta(p))
    assert recs[0].sequence == b"ACGT"
    assert recs[1].sequence == b"TT"


def test_read_gzip_by_magic_not_extension(tmp_path):
    p = tmp_path / "x.notgz"  # deliberately wrong extension
    p.write_bytes(gzip.compress(b">z\nACGTT\n"))
    recs = list(read_fasta(p))
    assert recs[0].sequence == b"ACGTT"


def test_read_fastq(tmp_path):
    p = tmp_path / "x.fq"
    p.write_bytes(b"@r1 c\nACGT\n+\nIIII\n@r2\nGG\nTT\n+anything\nIII\nI\n")
    recs = list(read_fastq(p))
    assert recs[0].quality == b"IIII"
    assert recs[1].sequence == b"GGTT"
    assert recs[1].quality == b"IIII"


def test_fastq_quality_length_mismatch(tmp_path):
    p = tmp_path / "bad.fq"
    p.write_bytes(b"@r1\nACGT\n+\nIII\n")
    with pytest.raises(ValueError):
        list(read_fastq(p))


def test_type_detection_and_mismatch(tmp_path):
    p = tmp_path / "x.fq"
    p.write_bytes(b"@r1\nACGT\n+\nIIII\n")
    assert next(iter(read_records(p))).is_fastq
    with pytest.raises(ValueError):
        list(read_fasta(p))


def test_write_fasta_roundtrip_wraps(tmp_path):
    rec = SeqRecord("n", b"A" * 205, "com")
    p = tmp_path / "o.fa"
    write_fasta(p, [rec])
    data = p.read_bytes()
    lines = data.split(b"\n")
    assert lines[0] == b">n"
    assert len(lines[1]) == 80  # default wrap width (seqio.h:19)
    back = list(read_fasta(p))
    assert back[0].sequence == rec.sequence


def test_write_fastq_roundtrip(tmp_path):
    rec = SeqRecord("q", b"ACGT", quality=b"!!!!")
    p = tmp_path / "o.fq"
    write_fastq(p, [rec])
    back = list(read_fastq(p))
    assert back[0].sequence == b"ACGT" and back[0].quality == b"!!!!"


def test_write_gz(tmp_path):
    p = tmp_path / "o.fa.gz"
    write_fasta(p, [SeqRecord("n", b"ACGT")])
    assert list(read_fasta(p))[0].sequence == b"ACGT"


def test_read_reference_example():
    recs = list(read_fasta(os.path.join(EXAMPLE, "seq1.fa")))
    assert len(recs) == 5
    assert all(len(r.sequence) > 4000 for r in recs)


def test_file_object_input():
    recs = list(read_records(io.BufferedReader(io.BytesIO(b">a\nAC\n"))))
    assert recs[0].sequence == b"AC"


# ---------------------------------------------------------------------
# Native C parser (native/seqio_fast.c): byte-for-byte parity with the
# Python streaming parser, which stays the reference implementation.
# ---------------------------------------------------------------------

def _native_available():
    try:
        from tsta_tpu.native import build
        build.load_seqio()
        return True
    except Exception:
        return False


needs_native = pytest.mark.skipif(not _native_available(),
                                  reason="no C toolchain")


def _parse_both(data, monkeypatch):
    from tsta_tpu.io import seqio
    out = []
    for knob in ("0", "1"):
        monkeypatch.setenv("TSTA_NATIVE_SEQIO", knob)
        out.append(list(read_records(io.BytesIO(data))))
    return out


@needs_native
def test_native_parity_fuzz(monkeypatch):
    import numpy as np
    rng = np.random.default_rng(7)
    bases = np.frombuffer(b"ACGT", np.uint8)
    for trial in range(40):
        fastq = bool(rng.integers(0, 2))
        eol = b"\r\n" if rng.integers(0, 2) else b"\n"
        parts = [eol * int(rng.integers(0, 2))]
        for r in range(int(rng.integers(1, 6))):
            ln = int(rng.integers(0, 300))
            seq = bases[rng.integers(0, 4, ln)].tobytes()
            name = b"r%d_%d" % (trial, r)
            com = [b"", b" a comment", b"  two  words ",
                   b"\ttabbed"][int(rng.integers(0, 4))]
            wrap = int(rng.integers(1, 120))
            lines = [seq[i:i + wrap] for i in range(0, ln, wrap)] or [b""]
            if fastq:
                qual = bytes([int(33 + rng.integers(0, 40))]) * ln
                qlines = [qual[i:i + wrap] for i in range(0, ln, wrap)] \
                    or [b""]
                parts.append(b"@" + name + com + eol
                             + eol.join(lines) + eol
                             + b"+" + (name if rng.integers(0, 2) else b"")
                             + eol + eol.join(qlines) + eol)
            else:
                parts.append(b">" + name + com + eol
                             + eol.join(lines) + eol
                             + eol * int(rng.integers(0, 2)))
        data = b"".join(parts)
        py, nat = _parse_both(data, monkeypatch)
        assert py == nat, "trial %d: %r" % (trial, data[:120])


@needs_native
def test_native_parity_reference_example(monkeypatch):
    from tsta_tpu.io import seqio
    with open(os.path.join(EXAMPLE, "seq1.fa"), "rb") as f:
        data = f.read()
    py, nat = _parse_both(data, monkeypatch)
    assert py == nat and len(nat) == 5


@needs_native
def test_native_error_parity(monkeypatch):
    bads = [b"ACGT\n>x\nAC\n", b"xyz\n", b"@r\nACGT\n+\nII\n",
            b"@r\nAC\n+\nIIII\nNOPE\n"]
    for bad in bads:
        for knob in ("0", "1"):
            monkeypatch.setenv("TSTA_NATIVE_SEQIO", knob)
            with pytest.raises(ValueError):
                list(read_records(io.BytesIO(bad)))


@needs_native
def test_native_gzip_path(tmp_path, monkeypatch):
    monkeypatch.setenv("TSTA_NATIVE_SEQIO", "1")
    p = tmp_path / "x.plain"
    p.write_bytes(gzip.compress(b">z\nACGTACGT\nTT\n"))
    recs = list(read_records(p))
    assert recs == [SeqRecord("z", b"ACGTACGTTT")]


@needs_native
def test_native_partial_records_before_error(monkeypatch):
    """A malformed LATER record must not break consumers that stop
    early (align_manifest reads only the first record): both engines
    yield the completed records, then raise at the bad one."""
    data = b"@r1 ok\nACGT\n+\nIIII\n@r2\nACGT\n+\nII\n"
    for knob in ("0", "1"):
        monkeypatch.setenv("TSTA_NATIVE_SEQIO", knob)
        it = read_records(io.BytesIO(data))
        first = next(it)
        assert first.name == "r1" and first.sequence == b"ACGT"
        with pytest.raises(ValueError):
            list(it)


def test_read_first_record(tmp_path):
    from tsta_tpu.io import read_first_record
    p = tmp_path / "x.fa"
    p.write_bytes(b">a c\nAC\nGT\n>b\nGG\n")
    rec = read_first_record(p)
    assert rec == SeqRecord("a", b"ACGT", "c")
    e = tmp_path / "e.fa"
    e.write_bytes(b"")
    assert read_first_record(e) is None


def test_native_size_gate_streams_large_files(tmp_path, monkeypatch):
    """Files past TSTA_NATIVE_SEQIO_MAX_MB stream with the Python
    parser (the native engine would hold ~3x the file in memory)."""
    from tsta_tpu.io import seqio
    p = tmp_path / "big.fa"
    p.write_bytes(b">a\n" + b"ACGT" * 500 + b"\n")
    monkeypatch.setenv("TSTA_NATIVE_SEQIO_MAX_MB", "0.001")  # ~1 KB cap
    called = []
    monkeypatch.setattr(seqio, "_parse_native",
                        lambda d: called.append(1) or ([], None))
    recs = list(read_records(p))
    assert not called and recs[0].sequence == b"ACGT" * 500
    monkeypatch.setenv("TSTA_NATIVE_SEQIO_MAX_MB", "1024")
    small = tmp_path / "small.fa"
    small.write_bytes(b">b\nAC\n")
    list(read_records(small))
    assert called or seqio._NATIVE_STATE[0] is False
