"""TSTA benchmark on an NVIDIA GPU: kernel-vs-plain timings per cell.

    python bench.py                 # every stage
    python bench.py psa_score walk  # chosen stages

Runs in one process (one JAX process per card) and refuses to run where
JAX finds no GPU.  Every stage drives public entry points
(``parallel.batch``, ``models.psa``, ``ops.msa_native``, ``models.msa``)
warm, times each call on the host clock after it returned host values,
checks the result, and prints one JSON line; the last line gathers all
stages with the device they ran on.

Stages (10 kbp pairs are the bundled example pair plus seeded mutated
copies: 5% substitutions, 2% deletions):

* ``psa_score``  -- score-only batches of 8/32/128 x 10 kbp: the CUDA
  kernel (``kernel='cuda'``) against vmapped ``psa_scan``
  (``kernel='scan'``); scores and corners must agree.
* ``psa_traced`` -- the 10 kbp example pair and 32 x 10 kbp traced, both
  engines; alignments must agree.
* ``walk``       -- the kernel's packed plane walked on the device
  (``lax.while_loop``) against copied to the host and walked there.
* ``msa``        -- native MSA 5 x 5 kbp, 3 x 50 kbp and the 6-problem
  fleet (``align_seqs_many``), and the compat engine on the host.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time

REPEATS = 3


def runs(fn, repeats=REPEATS):
    """Compile with one call, then time ``repeats`` calls; returns the
    last result and the sorted wall times in seconds."""
    out = fn()
    walls = []
    for _ in range(repeats):
        t0 = time.perf_counter()
        out = fn()
        walls.append(time.perf_counter() - t0)
    return out, sorted(walls)


def cell(walls, cells=None):
    med = statistics.median(walls)
    rec = {"median_s": med, "runs_s": walls}
    if cells is not None:
        rec["gcups"] = cells / med / 1e9
    return rec


def score_pairs(nb):
    from tsta_tpu.utils import synth
    return [synth.example_pair()] + synth.mutated_pairs(nb - 1, 10000,
                                                        seed=1)


def stage_psa_score():
    from tsta_tpu.parallel import batch
    out = {}
    for nb in (8, 32, 128):
        pairs = score_pairs(nb)
        cells = sum(len(a) * len(b) for a, b in pairs)
        rec = {}
        res = {}
        for kernel in ("cuda", "scan"):
            res[kernel], walls = runs(
                lambda: batch.align_batch(pairs, kernel=kernel))
            rec[kernel] = cell(walls, cells)
        rec["exact"] = ([tuple(r) for r in res["cuda"]]
                        == [tuple(r) for r in res["scan"]]
                        and res["cuda"][0].score == -5)
        out["score_%d" % nb] = rec
    return out


def stage_psa_traced():
    from tsta_tpu.models import psa
    from tsta_tpu.parallel import batch
    from tsta_tpu.utils import synth
    a, b = synth.example_pair()
    out = {}
    rec = {}
    alns = {}
    for kernel in ("cuda", "scan"):
        alns[kernel], walls = runs(lambda: psa.align_pair(
            a, b, traced=True, kernel=kernel))
        rec[kernel] = cell(walls, len(a) * len(b))
    gold = open(synth.EXAMPLE_DIR + "/psa_default.out", "rb").read()
    rec["exact"] = all(b">1\n" + o.a_row + b"\n>2\n" + o.b_row == gold
                       for o in alns.values())
    out["traced_1"] = rec
    pairs = synth.mutated_pairs(32, 10000, seed=2)
    cells = sum(len(x) * len(y) for x, y in pairs)
    rec = {}
    res = {}
    for kernel in ("cuda", "scan"):
        res[kernel], walls = runs(lambda: batch.align_batch(
            pairs, traced=True, kernel=kernel), repeats=2)
        rec[kernel] = cell(walls, cells)
    rec["exact"] = res["cuda"] == res["scan"]
    out["traced_32"] = rec
    return out


def stage_walk():
    """Walk engines on the kernel's planes.  Each timed walk starts from a
    fresh device copy of the planes, so the host walk pays its copy."""
    import jax
    import jax.numpy as jnp
    import numpy as np

    from tsta_tpu.ops import psa_cuda, traceback
    from tsta_tpu.ops.psa_scan import A_PAD, B_PAD, bucket
    from tsta_tpu.parallel.batch import _pad_stack
    from tsta_tpu.utils import synth
    out = {}
    for nb in (1, 4, 8, 32):
        pairs = ([synth.example_pair()] if nb == 1
                 else synth.mutated_pairs(nb, 10000, seed=2))
        n = bucket(max(len(a) for a, _ in pairs))
        m = bucket(max(len(b) for _, b in pairs))
        lens = np.array([(len(a), len(b)) for a, b in pairs], np.int32)
        stacks = (_pad_stack([a for a, _ in pairs], n, A_PAD),
                  _pad_stack([b for _, b in pairs], m, B_PAD))
        dp = lambda: jax.block_until_ready(psa_cuda.align_stack(  # noqa
            *stacks, lens, (2, -5, -2, -4), traced=True))
        (_, _, plane), dp_walls = runs(dp)
        rec = {"kernel_dp": cell(dp_walls, int(lens.prod(1).sum()))}
        res = {}
        for engine in ("device", "host"):
            walls = []
            for rep in range(REPEATS + 1):
                fresh = jax.block_until_ready(jnp.copy(plane))
                t0 = time.perf_counter()
                res[engine] = traceback.walk_planes(fresh, lens, pairs,
                                                    engine)
                if rep:
                    walls.append(time.perf_counter() - t0)
            rec[engine] = cell(sorted(walls))
        copies = []
        for _ in range(REPEATS):
            fresh = jax.block_until_ready(jnp.copy(plane))
            t0 = time.perf_counter()
            np.asarray(fresh)
            copies.append(time.perf_counter() - t0)
        rec["host_copy_only"] = cell(sorted(copies))
        rec["exact"] = res["device"] == res["host"]
        out["walk_%d" % nb] = rec
    return out


def stage_msa():
    from tsta_tpu.models import msa
    from tsta_tpu.ops import msa_native
    from tsta_tpu.utils import synth
    out = {}
    ex = synth.EXAMPLE_DIR + "/seq1.fa"
    res, walls = runs(lambda: msa.align_file(ex, engine="native"))
    out["msa_5k"] = dict(cell(walls), exact=res.round_scores
                         == [-5451, -3101, -1776, -870])
    res, walls = runs(lambda: msa.align_file(ex, engine="compat"))
    out["msa_compat_5k"] = dict(cell(walls), exact=res.round_scores
                                == [-5451, -3101, -1776, -870])
    seqs = synth.read_set(3, 50000, seed=7, sub=(0.05, 0.08))
    res, walls = runs(lambda: msa_native.align_seqs(seqs), repeats=2)
    out["msa_50k"] = dict(cell(walls), rounds=res.round_scores)
    problems = [synth.read_set(5, 5000, seed=100 + k) for k in range(6)]
    res, walls = runs(lambda: msa_native.align_seqs_many(problems))
    out["msa_fleet"] = dict(cell(walls),
                            problems_per_s=6 / statistics.median(walls))
    return out


STAGES = {"psa_score": stage_psa_score, "psa_traced": stage_psa_traced,
          "walk": stage_walk, "msa": stage_msa}


def main(argv) -> int:
    import jax

    from tsta_tpu.utils.cache import enable_compile_cache
    enable_compile_cache()
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        print("bench.py measures the GPU; JAX runs on %r" % dev.platform,
              file=sys.stderr)
        return 2
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip()
    names = argv or list(STAGES)
    result = {"device": {"platform": dev.platform, "kind": dev.device_kind,
                         "count": len(jax.devices())},
              "nvidia_smi": smi}
    for name in names:
        t0 = time.perf_counter()
        rec = STAGES[name]()
        print(json.dumps({name: rec, "stage_s": time.perf_counter() - t0}),
              flush=True)
        result.update(rec)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
