"""Walks of the one-byte traceback plane (ops/traceback.py): the host
walk and the device ``while_loop`` walk against the reference-semantics
``decode_pair`` on psa_scan's three planes, and against the goldens."""

import os

import numpy as np
import pytest

from psa_kernel_model import pack_planes
from tsta_tpu.config import AlignParams
from tsta_tpu.ops import psa_scan, traceback

PARAMS = [AlignParams(), AlignParams(3, -2, -1, -6), AlignParams(1, -2, -2, 0),
          AlignParams(2, -5, -1, -1)]


def _case(seed):
    rng = np.random.default_rng(300 + seed)
    n = int(rng.integers(1, 260))
    a = rng.integers(65, 69, n).astype(np.uint8)
    if seed % 2:
        b = rng.integers(65, 69, int(rng.integers(1, 260))).astype(np.uint8)
    else:   # similar, with indels: long gap runs and open/extend ties
        b = np.delete(a, rng.integers(0, n, n // 8))
        b = np.insert(b, rng.integers(0, len(b) + 1, n // 10),
                      rng.integers(65, 69, n // 10).astype(np.uint8))
        if len(b) == 0:
            b = a[:1].copy()
    p = PARAMS[seed % len(PARAMS)]
    ref = psa_scan.psa_align(a, b, p, traced=True)
    want = traceback.decode_pair(np.asarray(ref.back), np.asarray(ref.fback),
                                 np.asarray(ref.eback), a, b)
    plane = pack_planes(ref.back, ref.fback, ref.eback)
    return a, b, plane, want


@pytest.mark.parametrize("seed", range(10))
def test_host_walk_matches_decode_pair(seed):
    a, b, plane, want = _case(seed)
    m, n = plane.shape
    moves = traceback.walk_moves_host(plane, m, n)
    assert traceback.emit_alignment(moves, a, b, n, m) == want


@pytest.mark.parametrize("seed", range(4))
def test_device_walk_matches_decode_pair(seed):
    a, b, plane, want = _case(seed)
    m, n = plane.shape
    moves, count = traceback._decode_moves(plane, m, n)
    moves = np.asarray(moves)[:int(count)]
    assert traceback.emit_alignment(moves, a, b, n, m) == want


@pytest.mark.parametrize("engine", ["host", "device"])
def test_walk_planes_on_a_padded_stack(engine):
    """Planes of different real sizes in one padded stack; padding
    beyond each pair's (m, n) holds junk the walk must never read."""
    cases = [_case(s) for s in (4, 5, 6)]
    m_pad = max(c[2].shape[0] for c in cases) + 3
    n_pad = max(c[2].shape[1] for c in cases) + 16
    stack = np.full((3, m_pad, n_pad), 26, np.int8)
    for k, (_, _, plane, _) in enumerate(cases):
        stack[k, :plane.shape[0], :plane.shape[1]] = plane
    lens = np.array([(c[2].shape[1], c[2].shape[0]) for c in cases])
    got = traceback.walk_planes(stack, lens, [(c[0], c[1]) for c in cases],
                                engine)
    assert got == [c[3] for c in cases]


def test_walk_planes_rejects_unknown_engine():
    a, b, plane, _ = _case(0)
    with pytest.raises(ValueError, match="walk engine"):
        traceback.walk_planes(plane[None], np.array([plane.shape[::-1]]),
                              [(a, b)], "gpu")


CASES = ["psa_small1", "psa_small2", "psa_small3", "psa_small4",
         "psa_small5", "psa_small6", "psa_small7"]


@pytest.mark.parametrize("engine", ["host", "device"])
@pytest.mark.parametrize("case", CASES)
def test_packed_walk_reproduces_golden(golden_dir, case, engine):
    """The packed plane, walked on the host or by the device while_loop,
    emits the reference binary's output file byte for byte."""
    from tsta_tpu.io import read_first_record
    d = os.path.join(golden_dir, case)
    words = open(os.path.join(d, "params.txt")).read().split()
    p = AlignParams()
    flags = dict(zip(words[::2], (int(v) for v in words[1::2])))
    p = AlignParams(match=flags.get("-M", p.match),
                    mismatch=flags.get("-X", p.mismatch),
                    gap_extend=flags.get("-E", p.gap_extend),
                    gap_open=flags.get("-O", p.gap_open))
    s1 = read_first_record(os.path.join(d, "a.fa")).sequence
    s2 = read_first_record(os.path.join(d, "b.fa")).sequence
    if len(s2) > len(s1):
        s1, s2 = s2, s1
    a = np.frombuffer(s1, np.uint8)
    b = np.frombuffer(s2, np.uint8)
    ref = psa_scan.psa_align(a, b, p, traced=True)
    plane = pack_planes(ref.back, ref.fback, ref.eback)
    m, n = plane.shape
    aln, = traceback.walk_planes(plane[None], np.array([[n, m]]), [(a, b)],
                                 engine)
    mine = b">1\n" + aln.a_row + b"\n>2\n" + aln.b_row
    assert mine == open(os.path.join(d, "ref.out"), "rb").read()
