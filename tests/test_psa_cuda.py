"""The CUDA PSA kernel: its schedule modelled on the CPU, its wrapper,
the routing that picks it, and (``-m gpu``, on the card) the compiled
kernel itself against ``psa_scan``.

The kernel has no interpreter.  Its arithmetic and thread schedule are
checked through ``psa_kernel_model.kernel_model``, which follows
``psa_dp.cu`` step for step; the code around it (stacks, padding, mesh
sharding, traced group sizes, walks) runs on the CPU with the FFI call
replaced by ``psa_kernel_model.dp_reference``.
"""

import jax
import numpy as np
import pytest

from psa_kernel_model import dp_reference, kernel_model, pack_planes
from tsta_tpu.config import AlignParams
from tsta_tpu.models import psa
from tsta_tpu.ops import psa_cuda, psa_scan, route, traceback
from tsta_tpu.parallel import batch
from tsta_tpu.parallel import mesh as meshlib

P0 = (2, -5, -2, -4)


def _pair(rng, n, m, similar):
    a = rng.integers(65, 69, n).astype(np.uint8)
    if similar:
        b = np.resize(a, m).copy()
        flip = rng.random(m) < 0.1
        b[flip] = rng.integers(65, 69, int(flip.sum()))
    else:
        b = rng.integers(65, 69, m).astype(np.uint8)
    return a, b


# (n, m, threads, params, similar): ragged shapes, one and many stripes
# (threads * 8 rows each), single rows and columns, exotic scoring
MODEL_CASES = [
    (37, 29, 1, P0, True),
    (200, 150, 4, P0, True),
    (130, 300, 2, (3, -2, -1, -6), False),
    (64, 64, 1, (1, -2, -2, 0), True),
    (1, 1, 1, P0, False),
    (1, 40, 2, P0, False),
    (45, 1, 2, P0, False),
    (50, 200, 3, (2, 1, -1, -3), False),
    (17, 33, 32, P0, True),
    (256, 64, 8, (2, -5, -2, 0), True),
    (96, 97, 3, (5, -4, -3, -10), True),
    (160, 161, 2, P0, False),
]


@pytest.mark.parametrize("traced", [False, True])
@pytest.mark.parametrize("case", range(len(MODEL_CASES)))
def test_kernel_schedule_matches_psa_scan(case, traced):
    n, m, threads, p, similar = MODEL_CASES[case]
    rng = np.random.default_rng(100 + case)
    a, b = _pair(rng, n, m, similar)
    n_pad = -(-n // 16) * 16 + 16
    ap = np.concatenate([a, np.full(n_pad - n, psa_scan.A_PAD, np.uint8)])
    bp = np.concatenate([b, np.full(3, psa_scan.B_PAD, np.uint8)])
    score, corner, plane = kernel_model(ap, bp, n, m, p, threads, traced)
    ref = psa_scan.psa_align(a, b, p, traced=True)
    assert (score, corner) == (int(ref.score), int(ref.last))
    if traced:
        assert np.array_equal(plane[:m, :n],
                              pack_planes(ref.back, ref.fback, ref.eback))


@pytest.mark.parametrize("m,threads", [(1, 32), (256, 32), (257, 64),
                                       (2048, 256), (10000, 256)])
def test_threads_cover_one_stripe_up_to_the_cap(m, threads):
    assert psa_cuda.threads_for(m) == threads


def test_align_stack_rejects_unaligned_width():
    a = np.zeros((1, 40), np.uint8)
    with pytest.raises(ValueError, match="multiple of 16"):
        psa_cuda.align_stack(a, a, np.array([[40, 40]], np.int32), P0)


def test_align_stack_rejects_positive_gap_open():
    a = np.zeros((1, 32), np.uint8)
    with pytest.raises(ValueError, match="gap_open"):
        psa_cuda.align_stack(a, a, np.array([[32, 32]], np.int32),
                             (2, -5, -2, 1))


def test_failed_kernel_build_raises(monkeypatch, tmp_path):
    """A build that fails raises with the compiler's message; nothing
    falls back."""
    monkeypatch.setattr(psa_cuda, "_nvcc", lambda: "false")
    monkeypatch.setattr(psa_cuda, "cache_dir", lambda name: str(tmp_path))
    with pytest.raises(RuntimeError, match="building the CUDA PSA kernel"):
        psa_cuda._build()
    assert not list(tmp_path.iterdir())   # no library left behind


# ------------------------------------------------------------------ routing


def test_route_cpu_picks_the_plain_engine():
    assert route.platform() == "cpu"
    assert route.psa_engine("auto") == "scan"
    assert route.psa_engine("scan") == "scan"


def test_route_kernel_without_gpu_raises():
    with pytest.raises(ValueError, match="needs an NVIDIA GPU"):
        route.psa_engine("cuda")
    a = np.frombuffer(b"ACGT", np.uint8)
    with pytest.raises(ValueError, match="needs an NVIDIA GPU"):
        psa.align_pair(a, a, kernel="cuda")
    with pytest.raises(ValueError, match="needs an NVIDIA GPU"):
        batch.align_batch([(a, a)], kernel="cuda")


def test_route_unknown_kernel_raises():
    with pytest.raises(ValueError, match="unknown PSA kernel"):
        route.psa_engine("pallas")


def test_route_gpu_picks_the_kernel(monkeypatch):
    monkeypatch.setattr(jax, "default_backend", lambda: "gpu")
    assert route.psa_engine("auto") == "cuda"
    assert route.psa_engine("cuda") == "cuda"
    assert route.psa_engine("scan") == "scan"


def test_route_other_platform_is_an_error(monkeypatch):
    monkeypatch.setattr(jax, "default_backend", lambda: "rocm")
    with pytest.raises(RuntimeError, match="unsupported JAX platform"):
        route.psa_engine("auto")


@pytest.mark.parametrize("pairs,m,n,engine", [
    (1, 10240, 10240, "host"), (5, 10240, 10240, "host"),
    (8, 10240, 10240, "device"), (32, 10240, 10240, "device"),
    (40, 1024, 1024, "host"), (1, 102400, 102400, "device")])
def test_route_walk_by_shape(pairs, m, n, engine):
    """Few or small planes are copied and walked on the host; many large
    ones are walked on the device (break-even measured, PERF.md)."""
    assert route.walk_engine(pairs, m, n) == engine


def test_route_cpu_reports_no_memory_limit():
    assert route.device_bytes_free() is None


def test_nothing_runs_interpreted():
    """No module of the package passes interpret= to a kernel call."""
    import pathlib
    import tsta_tpu
    root = pathlib.Path(tsta_tpu.__file__).parent
    for path in root.rglob("*.py"):
        assert "interpret=" not in path.read_text(), path


# ------------------------------------------- GPU path with the stand-in DP


@pytest.fixture
def fake_gpu(monkeypatch):
    """Route to the kernel and compute it with psa_scan (same layout)."""
    monkeypatch.setattr(route, "platform", lambda: "gpu")
    monkeypatch.setattr(psa_cuda, "dp", dp_reference)


def _ragged_pairs(seed, k, lo, hi):
    rng = np.random.default_rng(seed)
    return [(rng.integers(65, 69, int(rng.integers(lo, hi))).astype(np.uint8),
             rng.integers(65, 69, int(rng.integers(lo, hi))).astype(np.uint8))
            for _ in range(k)]


@pytest.mark.parametrize("seed,k,lo,hi", [
    (1, 5, 1, 40), (2, 7, 100, 300), (3, 3, 120, 140), (4, 9, 1, 600),
    (5, 4, 2040, 2060)])
def test_kernel_path_scores_match_scan(fake_gpu, seed, k, lo, hi):
    pairs = _ragged_pairs(seed, k, lo, hi)
    got = batch.align_batch(pairs)
    for (a, b), r in zip(pairs, got):
        if len(b) > len(a):
            a, b = b, a
        ref = psa_scan.psa_align(a, b, AlignParams())
        assert (r.score, r.last) == (int(ref.score), int(ref.last))


@pytest.mark.parametrize("walk", ["host", "device"])
@pytest.mark.parametrize("seed", range(2))
def test_kernel_path_traced_matches_decode_pair(fake_gpu, monkeypatch, seed,
                                                walk):
    monkeypatch.setattr(route, "walk_engine", lambda *shape: walk)
    pairs = _ragged_pairs(10 + seed, 4, 20, 260)
    got = batch.align_batch(pairs, traced=True)
    for (a, b), r in zip(pairs, got):
        if len(b) > len(a):
            a, b = b, a
        ref = psa_scan.psa_align(a, b, AlignParams(), traced=True)
        aln = traceback.decode_pair(np.asarray(ref.back),
                                    np.asarray(ref.fback),
                                    np.asarray(ref.eback), a, b)
        assert (r.score, r.last, r.aln) == (int(ref.score), int(ref.last),
                                            aln)


def test_kernel_path_traced_groups_split(fake_gpu, monkeypatch):
    """Traced groups are sized from the plane bytes; a small budget makes
    several kernel calls whose results equal one call."""
    pairs = _ragged_pairs(21, 6, 100, 120)
    whole = batch.align_batch(pairs, traced=True)
    calls = []
    orig = psa_cuda.align_stack

    def spy(*args, **kw):
        calls.append(args[0].shape[0])
        return orig(*args, **kw)
    monkeypatch.setattr(psa_cuda, "align_stack", spy)
    monkeypatch.setattr(batch, "TRACED_GROUP_BYTES", 2 * 128 * 128)
    split = batch.align_batch(pairs, traced=True)
    assert calls == [2, 2, 2]
    assert split == whole


def test_kernel_path_refuses_plane_over_device_memory(fake_gpu,
                                                      monkeypatch):
    monkeypatch.setattr(route, "device_bytes_free", lambda: 10 ** 6)
    a = np.frombuffer(b"ACGT" * 400, np.uint8)
    with pytest.raises(ValueError, match="score-only"):
        batch.align_batch([(a, a)], traced=True)
    # score-only needs no plane
    assert batch.align_batch([(a, a)])[0].score == 2 * len(a)


@pytest.mark.parametrize("traced", [False, True])
def test_kernel_path_sharded_matches_unsharded(fake_gpu, traced):
    mesh = meshlib.make_mesh(data=4, seq=1)
    pairs = _ragged_pairs(31, 6, 50, 200)    # not a multiple of 4
    assert (batch.align_batch(pairs, traced=traced, mesh=mesh)
            == batch.align_batch(pairs, traced=traced))


@pytest.mark.parametrize("walk", ["host", "device"])
def test_kernel_path_sharded_traced_walks(fake_gpu, monkeypatch, walk):
    """A traced stack padded to the data axis walks every plane of the
    stack, and only the real pairs come back."""
    monkeypatch.setattr(route, "walk_engine", lambda *shape: walk)
    mesh = meshlib.make_mesh(data=4, seq=1)
    pairs = _ragged_pairs(33, 5, 40, 120)
    got = batch.align_batch(pairs, traced=True, mesh=mesh)
    assert len(got) == 5
    assert got == batch.align_batch(pairs, traced=True, kernel="scan")


def test_kernel_path_single_pair_and_swap(fake_gpu, golden_dir):
    import os
    d = os.path.join(golden_dir, "psa_small3")
    out = psa.align_files(os.path.join(d, "a.fa"), os.path.join(d, "b.fa"),
                          traced=True)
    ref = psa.align_files(os.path.join(d, "a.fa"), os.path.join(d, "b.fa"),
                          traced=True, kernel="scan")
    assert out == ref
    short, long_ = b"ACGTTGCA", b"ACGTAAATTGCAGG"
    r1 = psa.align_pair(short, long_, traced=True)
    r2 = psa.align_pair(short, long_, traced=True, kernel="scan")
    assert r1 == r2 and r1.swapped


def test_kernel_path_takes_exotic_scoring(fake_gpu):
    """The kernel stops at real lengths, so the padded-scan sign guard
    does not apply to it."""
    p = AlignParams(match=2, mismatch=1, gap_extend=-1, gap_open=-3)
    pairs = _ragged_pairs(41, 3, 30, 90)
    got = batch.align_batch(pairs, p)
    for (a, b), r in zip(pairs, got):
        if len(b) > len(a):
            a, b = b, a
        ref = psa_scan.psa_align(a, b, p)
        assert (r.score, r.last) == (int(ref.score), int(ref.last))


# ------------------------------------------------------------- on the card


@pytest.mark.gpu
@pytest.mark.parametrize("traced", [False, True])
def test_compiled_kernel_matches_psa_scan(gpu_platform, traced):
    """The compiled kernel against vmapped psa_scan on the card: the
    bundled 10 kbp pair (five stripes), ragged short pairs (one partial
    stripe) and a 3 kbp pair with exotic scoring."""
    from tsta_tpu.utils import synth
    pairs = [synth.example_pair()] + _ragged_pairs(7, 6, 1, 700)
    got = batch.align_batch(pairs, traced=traced, kernel="cuda")
    ref = batch.align_batch(pairs, traced=traced, kernel="scan")
    assert got == ref
    assert got[0].score == -5
    p = AlignParams(match=1, mismatch=0, gap_extend=-1, gap_open=0)
    a, b = _ragged_pairs(8, 1, 3000, 3001)[0]
    k = psa.align_pair(a, b, p, traced=traced, kernel="cuda")
    s = psa.align_pair(a, b, p, traced=traced, kernel="scan")
    assert k == s
