"""Golden-parity tests for PSA against outputs produced by the reference
binaries (vendored under tests/golden/; see BASELINE.md)."""

import os

import pytest

from tsta_tpu.config import AlignParams
from tsta_tpu.models import psa
from tsta_tpu.ops import traceback

SMALL_CASES = ["psa_small1", "psa_small2", "psa_small3", "psa_small4",
               "psa_small5", "psa_small6", "psa_small7"]

EXAMPLE = os.path.join(os.path.dirname(__file__), "golden", "example_big")


def _params(d):
    txt = open(os.path.join(d, "params.txt")).read().split()
    kw = {}
    names = {"-M": "match", "-X": "mismatch", "-E": "gap_extend",
             "-O": "gap_open"}
    for flag, val in zip(txt[::2], txt[1::2]):
        kw[names[flag]] = int(val)
    return AlignParams(**kw)


@pytest.mark.parametrize("case", SMALL_CASES)
def test_small_golden_score_and_alignment(golden_dir, case, tmp_path):
    d = os.path.join(golden_dir, case)
    params = _params(d)
    out = psa.align_files(os.path.join(d, "a.fa"), os.path.join(d, "b.fa"),
                          params, traced=True, kernel="scan")
    ref_stdout = open(os.path.join(d, "ref.stdout")).read()
    assert "maxsorce=%d" % out.score == ref_stdout.strip()
    my = tmp_path / "my.out"
    psa.write_alignment(out, str(my))
    assert my.read_bytes() == open(os.path.join(d, "ref.out"), "rb").read()


@pytest.mark.parametrize("case", SMALL_CASES)
def test_alignment_rescores_to_corner(golden_dir, case):
    """The emitted alignment must re-score to the DP corner score."""
    d = os.path.join(golden_dir, case)
    params = _params(d)
    out = psa.align_files(os.path.join(d, "a.fa"), os.path.join(d, "b.fa"),
                          params, traced=True, kernel="scan")
    assert traceback.score_alignment(out.a_row, out.b_row, params) == out.corner


@pytest.mark.slow
def test_big_example_default(golden_dir, tmp_path):
    out = psa.align_files(os.path.join(EXAMPLE, "seqa1.fa"),
                          os.path.join(EXAMPLE, "seqb1.fa"),
                          AlignParams(), traced=True, kernel="scan")
    assert out.score == -5  # README.md:19-21
    my = tmp_path / "my.out"
    psa.write_alignment(out, str(my))
    ref = open(os.path.join(golden_dir, "example_big/psa_default.out"),
               "rb").read()
    assert my.read_bytes() == ref


@pytest.mark.slow
def test_big_example_x3(golden_dir, tmp_path):
    out = psa.align_files(os.path.join(EXAMPLE, "seqa1.fa"),
                          os.path.join(EXAMPLE, "seqb1.fa"),
                          AlignParams(mismatch=-3), traced=True, kernel="scan")
    assert out.score == -3  # example_psa.sh params
    my = tmp_path / "my.out"
    psa.write_alignment(out, str(my))
    ref = open(os.path.join(golden_dir, "example_big/psa_x3.out"), "rb").read()
    assert my.read_bytes() == ref
