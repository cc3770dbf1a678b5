"""Error-path regression tests (round-1 advisor findings).

* The compat C engine must NEVER kill the host process: its in-degree
  limit (RMAX, reference c-t-simd.c register arrays) now propagates an
  error code up through tsta_msa_run instead of calling exit(1).
* Kernel entry points must reject parameter sets their math does not
  cover instead of silently returning wrong scores.
* Graph snapshots must round-trip through paths without an '.npz'
  suffix (np.savez would silently append one, breaking resume).
"""

import os
import subprocess
import sys

import numpy as np
import pytest

from tsta_tpu.config import AlignParams
from tsta_tpu.models.poa_graph import PoaGraph, load_graph, save_graph
from tsta_tpu.ops import psa_scan
from tsta_tpu.parallel import batch as pbatch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_compat_rmax_overflow_raises_not_exits(tmp_path):
    """With the limit compiled down to 2, a tiny diverse MSA overflows it;
    the library must raise RuntimeError in-process (the reference -- and
    round-1 compat -- called exit(1), killing the interpreter)."""
    prog = r"""
import sys
import numpy as np
from tsta_tpu.models import msa as msa_model
from tsta_tpu.config import AlignParams

rng = np.random.default_rng(3)
def junk(n): return rng.choice(np.frombuffer(b"ACGT", np.uint8), n).tobytes()
seqs = [b"C"*16] + [junk(4 + i) + b"C"*16 for i in range(1, 12)]
try:
    msa_model.align_seqs(seqs, AlignParams(), engine="compat")
except RuntimeError as e:
    assert "64-predecessor" in str(e) or "in-degree" in str(e), str(e)
    print("RAISED_OK")
    sys.exit(0)
print("NO_ERROR")
sys.exit(1)
"""
    env = dict(os.environ)
    env.pop("PYTHONPATH", None)
    env["JAX_PLATFORMS"] = "cpu"
    env["TSTA_NATIVE_CFLAGS"] = "-DTSTA_RMAX=2"
    env["TSTA_NATIVE_CACHE"] = str(tmp_path / "native_cache")
    proc = subprocess.run([sys.executable, "-c", prog], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, (proc.stdout, proc.stderr)
    assert "RAISED_OK" in proc.stdout


def test_compat_builds_without_openmp(tmp_path):
    """A compiler without OpenMP (no libgomp) still builds the compat
    engine, single-threaded, with the golden round scores; the POA and
    seqio helpers never ask for OpenMP."""
    cc = tmp_path / "cc"
    cc.write_text('#!/bin/sh\nfor a in "$@"; do [ "$a" = -fopenmp ] && '
                  'exit 1; done\nexec gcc "$@"\n')
    cc.chmod(0o755)
    prog = r"""
import os
from tsta_tpu.config import AlignParams
from tsta_tpu.io import read_records
from tsta_tpu.models import msa as msa_model
from tsta_tpu.native import build
d = os.path.join("tests", "golden", "msa_small1")
seqs = [r.sequence for r in read_records(os.path.join(d, "seqs.fa"))]
out = msa_model.align_seqs(seqs, AlignParams(), engine="compat")
build.load_poa()
build.load_seqio()
print("ROWS", out.round_scores)
"""
    env = dict(os.environ)
    env.pop("PYTHONPATH", None)
    env["JAX_PLATFORMS"] = "cpu"
    env["CC"] = str(cc)
    env["TSTA_NATIVE_CACHE"] = str(tmp_path / "native_cache")
    proc = subprocess.run([sys.executable, "-c", prog], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, (proc.stdout, proc.stderr)
    from tsta_tpu.models import msa as msa_model
    ref = msa_model.align_file(
        os.path.join(REPO, "tests", "golden", "msa_small1", "seqs.fa"),
        AlignParams(), engine="compat")
    assert "ROWS %s" % ref.round_scores in proc.stdout


def test_scan_rejects_positive_gap_open():
    a = np.frombuffer(b"ACGTACGT", np.uint8)
    with pytest.raises(ValueError, match="gap_open"):
        psa_scan.psa_align(a, a, (2, -5, -2, 4))


def test_batch_rejects_pad_unsafe_params():
    """Padded batching is score-neutral only for sane signs; exotic
    (but exactly-supported) sets must route to the unpadded scan."""
    a = np.frombuffer(b"ACGTACGT", np.uint8)
    with pytest.raises(ValueError, match="batch"):
        pbatch.align_batch([(a, a)], AlignParams(mismatch=3))


def test_batch_pallas_traced_raises():
    """Asking for the hand kernel where there is no GPU raises; nothing
    falls back to an interpreter."""
    a = np.frombuffer(b"ACGTACGTACGT", np.uint8)
    with pytest.raises(ValueError, match="NVIDIA GPU"):
        pbatch.align_batch([(a, a)], AlignParams(), traced=True,
                           kernel="cuda")


def test_save_graph_without_npz_suffix(tmp_path):
    g = PoaGraph.from_sequence(b"ACGTACGT", 2)
    path = str(tmp_path / "snapshot.ckpt")  # no .npz suffix
    save_graph(path, g, extra={"round_scores": [1]})
    assert os.path.exists(path)  # exactly the path resume will probe
    g2, extra = load_graph(path)
    assert g2.bases == g.bases
    assert extra["round_scores"] == [1]
