"""End-to-end CLI tests (the reference's user surface)."""

import json
import os

import pytest

from tsta_tpu import cli

EXAMPLE = os.path.join(os.path.dirname(__file__), "golden", "example_big")


def run_cli(argv, capsys):
    rc = cli.main(argv)
    out = capsys.readouterr().out
    return rc, out


def test_psa_cli_golden(golden_dir, tmp_path, capsys):
    d = os.path.join(golden_dir, "psa_small1")
    out_file = tmp_path / "o.txt"
    rc, out = run_cli(["psa", "-1", d + "/a.fa", "-2", d + "/b.fa",
                       "-o", str(out_file), "--kernel", "scan"], capsys)
    assert rc == 0
    assert out.strip() == open(d + "/ref.stdout").read().strip()
    assert out_file.read_bytes() == open(d + "/ref.out", "rb").read()


def test_psa_cli_kernel_without_gpu_fails(golden_dir, tmp_path, capsys):
    """--kernel cuda where JAX has no GPU is an error, not a fallback."""
    d = os.path.join(golden_dir, "psa_small1")
    out_file = tmp_path / "o.txt"
    rc, out = run_cli(["psa", "-1", d + "/a.fa", "-2", d + "/b.fa",
                       "-o", str(out_file), "--kernel", "cuda"], capsys)
    assert rc == 1 and out == "" and not out_file.exists()


def test_psa_cli_negative_flag_values(golden_dir, tmp_path, capsys):
    d = os.path.join(golden_dir, "psa_small4")  # generated with -X -3
    out_file = tmp_path / "o.txt"
    rc, out = run_cli(["psa", "-X", "-3", "-1", d + "/a.fa",
                       "-2", d + "/b.fa", "-o", str(out_file),
                       "--kernel", "scan"], capsys)
    assert rc == 0
    assert out_file.read_bytes() == open(d + "/ref.out", "rb").read()


def test_psa_cli_notrace_json(golden_dir, capsys):
    d = os.path.join(golden_dir, "psa_small1")
    rc, out = run_cli(["psa", "--notrace", "--json", "-1", d + "/a.fa",
                       "-2", d + "/b.fa", "--kernel", "scan"], capsys)
    assert rc == 0
    rec = json.loads(out)
    assert rec["score"] == 155 and rec["output"] is None


def test_psa_cli_missing_file(capsys):
    rc, _ = run_cli(["psa", "-1", "/nonexistent.fa", "-2", "/also.fa"],
                    capsys)
    assert rc == 1


def test_psa_cli_bad_params(capsys):
    rc, _ = run_cli(["psa", "-E", "1", "-1", "x", "-2", "y"], capsys)
    assert rc == 1


def test_msa_cli_golden(golden_dir, tmp_path, capsys):
    d = os.path.join(golden_dir, "msa_small1")
    out_file = tmp_path / "m.txt"
    rc, _ = run_cli(["msa", "-i", d + "/seqs.fa", "-o", str(out_file)],
                    capsys)
    assert rc == 0
    assert out_file.read_bytes() == open(d + "/ref.out", "rb").read()


def test_psa_cli_fastq_input(tmp_path, capsys):
    f1 = tmp_path / "a.fq"
    f2 = tmp_path / "b.fq"
    f1.write_bytes(b"@r1\nACGTACGTAC\n+\nIIIIIIIIII\n")
    f2.write_bytes(b"@r2\nACGTTCGTAC\n+\nIIIIIIIIII\n")
    rc, out = run_cli(["psa", "--notrace", "--json", "-1", str(f1),
                       "-2", str(f2), "--kernel", "scan"], capsys)
    assert rc == 0
    assert json.loads(out)["score"] > 0


def test_batch_cli(golden_dir, tmp_path, capsys):
    d = os.path.join(golden_dir, "psa_small1")
    manifest = tmp_path / "m.tsv"
    manifest.write_text("p0\t%s\t%s\n" % (d + "/a.fa", d + "/b.fa"))
    scores = tmp_path / "s.tsv"
    rc, out = run_cli(["batch", "--pairs", str(manifest),
                       "--scores", str(scores)], capsys)
    assert rc == 0
    assert json.loads(out)["pairs"] == 1
    assert scores.read_text().strip() == "p0\t155"


@pytest.mark.slow
def test_msa_cli_w30_golden(golden_dir, tmp_path, capsys):
    """example_msa.sh parameters (-X -3 -W 30) byte-parity."""
    out_file = tmp_path / "m.txt"
    rc, _ = run_cli(["msa", "-X", "-3", "-W", "30",
                     "-i", os.path.join(EXAMPLE, "seq1.fa"),
                     "-o", str(out_file)], capsys)
    assert rc == 0
    ref = open(os.path.join(golden_dir, "example_big/msa_x3w30.out"),
               "rb").read()
    assert out_file.read_bytes() == ref


def test_msa_batch_cli(tmp_path):
    """tsta msa-batch: pipelined fleet over a list of read FASTAs."""
    import numpy as np

    from tsta_tpu.cli import main

    rng = np.random.default_rng(5)
    paths = []
    for i in range(2):
        base = rng.choice(np.frombuffer(b"ACGT", np.uint8), 80).tobytes()
        fa = tmp_path / ("set%d.fa" % i)
        with open(fa, "wb") as f:
            for k in range(3):
                s = bytearray(base)
                for j in rng.integers(0, len(s), 6):
                    s[j] = b"ACGT"[rng.integers(0, 4)]
                f.write(b">r%d\n" % k + bytes(s) + b"\n")
        paths.append(str(fa))
    lst = tmp_path / "list.txt"
    lst.write_text("\n".join(paths) + "\n")
    out_dir = tmp_path / "outs"
    rc = main(["msa-batch", "--inputs", str(lst),
               "--out-dir", str(out_dir)])
    assert rc == 0
    for i in range(2):
        data = (out_dir / ("set%d.txt" % i)).read_bytes()
        assert b"consensus" in data


def test_msa_batch_single_input(tmp_path):
    """msa-batch with ONE input routes through the pipelined scheduler
    and matches `tsta msa --engine native` byte-for-byte (README's
    'use msa-batch unconditionally' guidance; r4 VERDICT item 6)."""
    import numpy as np

    from tsta_tpu.cli import main

    rng = np.random.default_rng(8)
    base = rng.choice(np.frombuffer(b"ACGT", np.uint8), 120).tobytes()
    fa = tmp_path / "only.fa"
    with open(fa, "wb") as f:
        for k in range(3):
            s = bytearray(base)
            for j in rng.integers(0, len(s), 8):
                s[j] = b"ACGT"[rng.integers(0, 4)]
            f.write(b">r%d\n" % k + bytes(s) + b"\n")
    lst = tmp_path / "list.txt"
    lst.write_text(str(fa) + "\n")
    out_dir = tmp_path / "outs"
    assert main(["msa-batch", "--inputs", str(lst),
                 "--out-dir", str(out_dir)]) == 0
    single = tmp_path / "single.txt"
    assert main(["msa", "-i", str(fa), "--engine", "native",
                 "-o", str(single)]) == 0
    assert (out_dir / "only.txt").read_bytes() == single.read_bytes()


def test_msa_batch_multiprocess_striding(tmp_path, monkeypatch):
    """TSTA_NUM_PROCESSES/TSTA_PROCESS_ID stride the input list; output
    names are globally unique across sibling processes."""
    import numpy as np

    from tsta_tpu.cli import main as cli_main
    rng = np.random.default_rng(3)
    paths = []
    for i in range(4):
        fa = tmp_path / ("set%d.fa" % i)
        with open(fa, "wb") as f:
            for k in range(3):
                s = rng.choice(np.frombuffer(b"ACGT", np.uint8),
                               120).tobytes()
                f.write(b">r%d\n" % k + s + b"\n")
        paths.append(str(fa))
    inputs = tmp_path / "inputs.txt"
    inputs.write_text("\n".join(paths) + "\n")
    out_dir = tmp_path / "out"
    monkeypatch.setenv("TSTA_NUM_PROCESSES", "2")
    for pid in ("0", "1"):
        monkeypatch.setenv("TSTA_PROCESS_ID", pid)
        rc = cli_main(["msa-batch", "--inputs", str(inputs),
                       "--out-dir", str(out_dir)])
        assert rc == 0
    outs = sorted(p.name for p in out_dir.iterdir())
    assert len(outs) == 4                       # all four, no overwrite
    # single-process run for comparison: same MSA content per input
    monkeypatch.setenv("TSTA_NUM_PROCESSES", "1")
    out_dir2 = tmp_path / "out2"
    assert cli_main(["msa-batch", "--inputs", str(inputs),
                     "--out-dir", str(out_dir2)]) == 0
    single = {p.name.split(".")[0]: p.read_bytes()
              for p in out_dir2.iterdir()}
    for p in out_dir.iterdir():
        assert p.read_bytes() == single[p.name.split(".")[0]]
