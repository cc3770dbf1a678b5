"""TSTA-TPU: a sequence-alignment engine in JAX for NVIDIA GPUs.

A from-scratch reimplementation of the capabilities of the reference CPU tool
TSTA (striped-SIMD + anti-diagonal difference-method aligner):

* Global pairwise alignment (Needleman-Wunsch, affine gaps) with and without
  traceback -- exact int32 DP in JAX (``ops.psa_scan``) and a CUDA
  wavefront kernel (``ops.psa_cuda``) for GPU speed.
* Progressive partial-order-alignment (POA) multiple sequence alignment with
  heaviest-bundle consensus -- a bit-exact "compat" engine (C, ``native/``)
  reproducing the reference's int8 difference/clamp semantics, and an
  exact device engine (``ops.msa_native``).
* Batched, sharded execution over a ``jax.sharding.Mesh`` (``parallel/``).

Scoring convention (matches reference psa/psa.c:114-117): match ``M`` (+2),
mismatch ``X`` (-5), gap-extend ``E`` (-2), gap-open ``O`` (-4); a gap of
length k costs ``O + k*E``.
"""

from tsta_tpu.config import AlignParams
from tsta_tpu.version import __version__

__all__ = ["AlignParams", "__version__"]
