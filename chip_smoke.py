"""Run TSTA's main paths once on an NVIDIA GPU and check every result.

    python chip_smoke.py          # one GPU: phases 1-8
    python chip_smoke.py --four   # four GPUs: only the three mesh checks

Every phase drives a public entry point (``tsta_tpu.cli.main``,
``models.psa``, ``parallel.batch``, ``ops.msa_native``) at the sizes the
repository supports, compares the result exactly with a plain reference
(integer DP has no rounding, so every tolerance is zero) and prints one
line: its result, its check and its warm wall time on the host clock.
Any failed phase raises, and the script exits non-zero.  The last line of
stdout is one JSON object naming the device.  The script refuses to run
where JAX finds no GPU.
"""

from __future__ import annotations

import argparse
import contextlib
import io
import json
import os
import subprocess
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
EXAMPLE = os.path.join(ROOT, "tests", "golden", "example_big")
MSA_ROUNDS = [-5451, -3101, -1776, -870]   # BASELINE.md, 5 x 5 kbp example


def say(phase: str, result: str, check: str, wall: float | None) -> None:
    w = "not timed" if wall is None else "%.4f s warm" % wall
    print("[%s] %s | check: %s | %s" % (phase, result, check, w),
          flush=True)


def timed(fn):
    """Run ``fn`` once to compile, then once on the clock; every call
    returns host values, so the device has finished when it returns."""
    fn()
    t0 = time.perf_counter()
    out = fn()
    return out, time.perf_counter() - t0


def run_cli(argv):
    from tsta_tpu import cli
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = cli.main(argv)
    if rc != 0:
        raise RuntimeError("tsta %s exited %d" % (" ".join(argv), rc))
    return buf.getvalue()


def require(ok: bool, what: str) -> None:
    if not ok:
        raise AssertionError(what)


def phase_device(expect: int):
    import jax
    devs = jax.devices()
    d = devs[0]
    require(d.platform == "gpu", "JAX platform is %r, not 'gpu'"
            % d.platform)
    require(len(devs) >= expect, "need %d GPUs, JAX sees %d"
            % (expect, len(devs)))
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True)
    for line in smi.stdout.strip().splitlines():
        print("nvidia-smi: %s" % line.strip(), flush=True)
    say("1 device", "%s x%d, XLA_FLAGS=%r" % (d.device_kind, len(devs),
                                             os.environ.get("XLA_FLAGS", "")),
        "platform gpu", None)
    return {"platform": d.platform, "kind": d.device_kind,
            "count": len(devs)}


def phase_traced_cli(tmp):
    out = os.path.join(tmp, "psa.out")
    argv = ["psa", "-1", os.path.join(EXAMPLE, "seqa1.fa"),
            "-2", os.path.join(EXAMPLE, "seqb1.fa"), "-o", out]
    stdout, wall = timed(lambda: run_cli(argv))
    with open(os.path.join(EXAMPLE, "psa_default.out"), "rb") as f:
        same = open(out, "rb").read() == f.read()
    with open(os.path.join(EXAMPLE, "psa_default.stdout")) as f:
        want = f.read().strip()
    require(same, "alignment file differs from psa_default.out")
    require(stdout.strip() == want, "stdout %r != %r" % (stdout, want))
    say("2 traced PSA 10 kbp (cli psa)", stdout.strip(),
        "output byte-identical to psa_default.out, stdout == %s" % want,
        wall)


def _score_pairs():
    from tsta_tpu.utils import synth
    return [synth.example_pair()] + synth.mutated_pairs(127, 10000, seed=1)


def phase_score_batch():
    from tsta_tpu.parallel import batch
    pairs = _score_pairs()
    got, wall = timed(lambda: batch.align_batch(pairs, kernel="cuda"))
    ref, wall_ref = timed(lambda: batch.align_batch(pairs, kernel="scan"))
    require(got[0].score == -5, "example pair scored %d, not -5"
            % got[0].score)
    bad = [k for k, (g, r) in enumerate(zip(got, ref))
           if (g.score, g.last) != (r.score, r.last)]
    require(not bad, "pairs %s differ from vmapped psa_scan" % bad[:8])
    cells = sum(len(a) * len(b) for a, b in pairs)
    say("3 score-only 128 x 10 kbp (align_batch)",
        "kernel %.1f GCUPS, vmapped psa_scan %.1f GCUPS (%.4f s)"
        % (cells / wall / 1e9, cells / wall_ref / 1e9, wall_ref),
        "slot 0 = -5; 128/128 scores and corners == vmapped psa_scan",
        wall)


def _write_manifest(tmp, pairs, tag):
    lines = []
    for k, (a, b) in enumerate(pairs):
        paths = []
        for side, s in (("a", a), ("b", b)):
            p = os.path.join(tmp, "%s%d%s.fa" % (tag, k, side))
            with open(p, "wb") as f:
                f.write(b">%s\n%s\n" % (side.encode(), bytes(s)))
            paths.append(p)
        lines.append("%s%d\t%s\t%s\n" % (tag, k, paths[0], paths[1]))
    manifest = os.path.join(tmp, tag + ".tsv")
    with open(manifest, "w") as f:
        f.writelines(lines)
    return manifest


def phase_traced_batch(tmp):
    import numpy as np

    from tsta_tpu.config import AlignParams
    from tsta_tpu.ops import psa_scan, traceback
    from tsta_tpu.parallel import batch
    from tsta_tpu.utils import synth
    pairs = synth.mutated_pairs(32, 10000, seed=2)
    manifest = _write_manifest(tmp, pairs, "t")
    out_dir = os.path.join(tmp, "alns")
    rows, wall = timed(lambda: batch.align_manifest(
        manifest, traced=True, out_dir=out_dir))
    params = AlignParams()
    for r in rows:
        data = open(os.path.join(out_dir, r["name"] + ".txt"), "rb").read()
        a_row = data.split(b">1\n")[1].split(b"\n>2\n")[0]
        b_row = data.split(b"\n>2\n")[1]
        require(traceback.score_alignment(a_row, b_row, params)
                == r["corner"], "%s: alignment does not rescore to its "
                "corner" % r["name"])
    for k in (0, 9, 17, 31):
        a, b = pairs[k]
        if len(b) > len(a):
            a, b = b, a
        ref = psa_scan.psa_align(a, b, params, traced=True)
        aln = traceback.decode_pair(np.asarray(ref.back),
                                    np.asarray(ref.fback),
                                    np.asarray(ref.eback), a, b)
        mine = open(os.path.join(out_dir, "t%d.txt" % k), "rb").read()
        require(mine == b">1\n" + aln.a_row + b"\n>2\n" + aln.b_row,
                "t%d: alignment differs from decode_pair on psa_scan "
                "planes" % k)
    cells = sum(r["cells"] for r in rows)
    say("4 traced 32 x 10 kbp (align_manifest)",
        "%.1f GCUPS end to end" % (cells / wall / 1e9),
        "32/32 rescore to their corner; pairs 0, 9, 17, 31 == decode_pair "
        "on psa_scan planes", wall)


def phase_msa_cli(tmp):
    out = os.path.join(tmp, "msa.out")
    argv = ["msa", "--engine", "native", "-i",
            os.path.join(EXAMPLE, "seq1.fa"), "-o", out, "--json"]
    stdout, wall = timed(lambda: run_cli(argv))
    rounds = json.loads(stdout.strip().splitlines()[-1])["rounds"]
    require(rounds == MSA_ROUNDS, "round scores %s != %s"
            % (rounds, MSA_ROUNDS))
    say("5 native MSA 5 x 5 kbp (cli msa)", "rounds %s" % rounds,
        "== %s" % MSA_ROUNDS, wall)


def phase_msa_batch(tmp):
    from tsta_tpu.utils import synth
    paths = []
    for k in range(6):
        p = os.path.join(tmp, "prob%d.fa" % k)
        with open(p, "wb") as f:
            for i, s in enumerate(synth.read_set(5, 5000, seed=100 + k)):
                f.write(b">r%d\n%s\n" % (i, s))
        paths.append(p)
    listing = os.path.join(tmp, "problems.txt")
    with open(listing, "w") as f:
        f.write("\n".join(paths) + "\n")
    out_dir = os.path.join(tmp, "fleet")
    _, wall = timed(lambda: run_cli(["msa-batch", "--inputs", listing,
                                     "--out-dir", out_dir]))
    for k, p in enumerate(paths):
        single = os.path.join(tmp, "single%d.out" % k)
        run_cli(["msa", "--engine", "native", "-i", p, "-o", single])
        fleet = os.path.join(out_dir, "prob%d.txt" % k)
        require(open(fleet, "rb").read() == open(single, "rb").read(),
                "problem %d: msa-batch output differs from tsta msa" % k)
    say("6 msa-batch 6 x (5 x 5 kbp)", "%.2f problems/s" % (6 / wall),
        "6/6 outputs byte-identical to tsta msa --engine native", wall)


def phase_msa_50k():
    import jax

    from tsta_tpu.models import psa
    from tsta_tpu.ops import msa_native
    from tsta_tpu.utils import synth
    seqs = synth.read_set(3, 50000, seed=7, sub=(0.05, 0.08))
    out, wall = timed(lambda: msa_native.align_seqs(seqs))
    pair = psa.align_pair(seqs[1], seqs[0], swap=False)
    require(out.round_scores[0] == pair.corner,
            "round 1 scored %d, pairwise Gotoh %d"
            % (out.round_scores[0], pair.corner))
    stats = jax.devices()[0].memory_stats() or {}
    peak = stats.get("peak_bytes_in_use", -1)
    say("7 native MSA 3 x 50 kbp (msa_native.align_seqs)",
        "rounds %s, peak_bytes_in_use %d" % (out.round_scores, peak),
        "round 1 == pairwise Gotoh corner %d" % pair.corner, wall)


def phase_msa_200k():
    from tsta_tpu.ops import msa_native
    from tsta_tpu.utils import synth
    seqs = synth.read_set(3, 200000, seed=13, sub=(0.05, 0.08))
    try:
        msa_native.align_seqs(seqs)
    except ValueError as e:
        require("engine='compat'" in str(e),
                "the refusal does not name engine='compat': %s" % e)
        say("8 native MSA 3 x 200 kbp", "refused: %s" % e,
            "clean ValueError before allocating", None)
        return
    raise AssertionError("3 x 200 kbp native MSA ran instead of refusing")


def four_batch(tmp):
    from tsta_tpu.parallel import batch
    from tsta_tpu.parallel import mesh as meshlib
    from tsta_tpu.utils import synth
    mesh = meshlib.make_mesh(data=4, seq=1)
    pairs = synth.mutated_pairs(32, 10000, seed=3)
    one, _ = timed(lambda: batch.align_batch(pairs))
    shd, wall = timed(lambda: batch.align_batch(pairs, mesh=mesh))
    require([tuple(r) for r in one] == [tuple(r) for r in shd],
            "4x1 score-only batch differs from one device")
    manifest = _write_manifest(tmp, pairs[:8], "m")
    t_one = batch.align_manifest(manifest, traced=True,
                                 out_dir=os.path.join(tmp, "one"))
    t_shd, wall_t = timed(lambda: batch.align_manifest(
        manifest, traced=True, mesh=mesh, out_dir=os.path.join(tmp, "shd")))
    require(t_one == t_shd, "4x1 traced manifest rows differ")
    for r in t_one:
        name = r["name"] + ".txt"
        require(open(os.path.join(tmp, "one", name), "rb").read()
                == open(os.path.join(tmp, "shd", name), "rb").read(),
                "%s: 4x1 traced alignment differs" % name)
    say("4x1 align_batch / align_manifest",
        "score-only 32 x 10 kbp %.4f s, traced 8 x 10 kbp %.4f s"
        % (wall, wall_t), "scores, corners and alignments == one device",
        wall)


def four_longseq():
    from tsta_tpu.ops import psa_scan
    from tsta_tpu.parallel import longseq
    from tsta_tpu.parallel import mesh as meshlib
    from tsta_tpu.utils import synth
    mesh = meshlib.make_mesh(data=1, seq=4)
    a, b = synth.example_pair()
    (best, corner), wall = timed(lambda: longseq.align_long(a, b,
                                                            mesh=mesh))
    ref = psa_scan.psa_align(a, b, (2, -5, -2, -4))
    require((best, corner) == (int(ref.score), int(ref.last)),
            "1x4 align_long (%d, %d) != psa_scan (%d, %d)"
            % (best, corner, int(ref.score), int(ref.last)))
    say("1x4 longseq.align_long 10 kbp", "score %d corner %d"
        % (best, corner), "== psa_scan on one device", wall)


def four_msa(tmp):
    one = os.path.join(tmp, "msa1.out")
    shd = os.path.join(tmp, "msa4.out")
    src = os.path.join(EXAMPLE, "seq1.fa")
    run_cli(["msa", "--engine", "native", "-i", src, "-o", one])
    _, wall = timed(lambda: run_cli(["msa", "--engine", "native", "--mesh",
                                     "1x4", "-i", src, "-o", shd]))
    require(open(one, "rb").read() == open(shd, "rb").read(),
            "1x4 MSA rows or consensus differ from one device")
    say("1x4 msa --engine native --mesh", "5 x 5 kbp",
        "rows and consensus == unsharded", wall)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--four", action="store_true",
                    help="run only the three mesh checks on four GPUs")
    args = ap.parse_args(argv)
    from tsta_tpu.utils.cache import enable_compile_cache
    enable_compile_cache()
    device = phase_device(4 if args.four else 1)
    with tempfile.TemporaryDirectory() as tmp:
        if args.four:
            four_batch(tmp)
            four_longseq()
            four_msa(tmp)
        else:
            phase_traced_cli(tmp)
            phase_score_batch()
            phase_traced_batch(tmp)
            phase_msa_cli(tmp)
            phase_msa_batch(tmp)
            phase_msa_50k()
            phase_msa_200k()
    print(json.dumps({"ok": True, "device": device}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
