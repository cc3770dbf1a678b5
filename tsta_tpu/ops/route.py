"""The one place that chooses an engine for the device this process runs on.

The choice is made from what the code can observe: the JAX platform and,
where it matters, the shapes.  There are no environment knobs.

* ``gpu`` (NVIDIA, CUDA): the PSA DP runs in the hand-written CUDA kernel
  (``ops/psa_cuda.py``); traceback planes are walked where
  :func:`walk_engine` says for their shape.  The timings that decided
  both are in PERF.md.
* ``cpu``: the plain JAX engines (``ops/psa_scan.py``); the CPU exists for
  the tests.
* any other platform is an error.

Asking for the CUDA kernel where there is no GPU raises; nothing falls back
to an interpreter.
"""

from __future__ import annotations

from typing import Optional

import jax

PSA_KERNELS = ("auto", "scan", "cuda")


def platform() -> str:
    """The JAX platform of the default device: 'gpu' or 'cpu'."""
    plat = jax.default_backend()
    if plat not in ("gpu", "cpu"):
        raise RuntimeError(
            "unsupported JAX platform %r: TSTA runs on an NVIDIA GPU "
            "('gpu') or, for tests, on the CPU" % plat)
    return plat


def psa_engine(kernel: str = "auto") -> str:
    """'cuda' or 'scan' for a PSA DP call.

    ``kernel='cuda'`` insists on the CUDA kernel and raises without a GPU;
    ``'scan'`` insists on the plain engine; ``'auto'`` takes the kernel on
    a GPU, where it was measured faster than vmapped ``psa_scan`` at every
    benchmarked shape, score-only and traced (PERF.md), and the plain
    engine on the CPU.
    """
    if kernel not in PSA_KERNELS:
        raise ValueError("unknown PSA kernel %r (choose from %s)"
                         % (kernel, ", ".join(PSA_KERNELS)))
    plat = platform()
    if kernel == "cuda" and plat != "gpu":
        raise ValueError("kernel='cuda' needs an NVIDIA GPU; this process "
                         "runs JAX on %r" % plat)
    if kernel == "scan":
        return "scan"
    return "cuda" if plat == "gpu" else "scan"


# Break-even of the two traceback walks, measured on an H100 (PERF.md):
# the host walk pays ~0.43 ns per plane byte to copy the planes (pageable
# memory), the device while_loop ~12 us per step of the longest walk
# (about m + n steps).  28,000 plane bytes per walk step is where they
# meet: one to five 10 kbp pairs walk on the host, eight or more on the
# device.
HOST_WALK_BYTES_PER_STEP = 28_000


def walk_engine(pairs: int, m: int, n: int) -> str:
    """'host' or 'device': where a stack of ``pairs`` packed (m, n)
    traceback planes is walked -- copied to the host and walked there, or
    walked in lockstep on the device, whichever is cheaper for the shape.
    """
    if pairs * m * n <= HOST_WALK_BYTES_PER_STEP * (m + n):
        return "host"
    return "device"


def device_bytes_free() -> Optional[int]:
    """Bytes the default device can still allocate, or None where the
    runtime reports no limit (the CPU)."""
    stats = jax.devices()[0].memory_stats()
    if not stats or "bytes_limit" not in stats:
        return None
    return int(stats["bytes_limit"]) - int(stats.get("bytes_in_use", 0))
