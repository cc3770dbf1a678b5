"""Seeded synthetic inputs for the bench, the chip smoke run and tests.

Reads are mutated copies of a uniform-ACGT base: substitutions at a rate,
then deletions of a fixed share of positions -- the shape the reference
is built for (a read aligned to a close relative).  Everything is made
from a seed; nothing is downloaded.
"""

from __future__ import annotations

import os
from typing import List, Tuple

import numpy as np

BASES = np.frombuffer(b"ACGT", np.uint8)
EXAMPLE_DIR = os.path.join(os.path.dirname(os.path.dirname(
    os.path.dirname(os.path.abspath(__file__)))), "tests", "golden",
    "example_big")


def mutate(rng: np.random.Generator, seq: np.ndarray, sub: float = 0.05,
           dele: float = 0.02) -> np.ndarray:
    """Substitute a ``sub`` share of positions, then delete ``dele``."""
    out = np.array(seq, np.uint8)
    mask = rng.random(len(out)) < sub
    out[mask] = BASES[rng.integers(0, 4, int(mask.sum()))]
    return np.delete(out, rng.integers(0, len(out), int(len(out) * dele)))


def mutated_pairs(n_pairs: int, length: int, seed: int
                  ) -> List[Tuple[np.ndarray, np.ndarray]]:
    """``n_pairs`` (base, mutated copy) pairs of ``length`` bp."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n_pairs):
        a = rng.choice(BASES, length)
        out.append((a, mutate(rng, a)))
    return out


def read_set(n_reads: int, length: int, seed: int,
             sub=(0.05,)) -> List[bytes]:
    """A base read plus ``n_reads - 1`` mutated copies; copy k uses
    substitution rate ``sub[k % len(sub)]`` and 2% deletions."""
    rng = np.random.default_rng(seed)
    base = rng.choice(BASES, length)
    return [base.tobytes()] + [mutate(rng, base, sub[k % len(sub)]).tobytes()
                               for k in range(n_reads - 1)]


def example_pair() -> Tuple[np.ndarray, np.ndarray]:
    """The bundled 10 kbp example pair (scores maxsorce=-5)."""
    from tsta_tpu.io import read_first_record
    return tuple(np.frombuffer(read_first_record(
        os.path.join(EXAMPLE_DIR, name)).sequence, np.uint8)
        for name in ("seqa1.fa", "seqb1.fa"))
