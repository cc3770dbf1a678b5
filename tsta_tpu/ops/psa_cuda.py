"""The PSA DP kernel for NVIDIA Hopper: CUDA through ``jax.ffi``.

``cuda/psa_dp.cu`` holds the kernel (its header comment gives the thread
schedule).  It is compiled with ``nvcc`` for ``sm_90a`` at first use into
``.tsta_cache/cuda/`` of the checkout, keyed by a hash of the source and
the command, and registered as two XLA FFI targets: score-only and traced.
A failed build raises; there is no fallback.

Inputs are bucket-padded stacks, as ``parallel/batch.py`` builds them:
``a`` (P, n_pad) and ``b`` (P, m_pad) uint8 and ``lens`` (P, 2) int32 with
each pair's real (n, m).  The kernel works on the real lengths, so the
padding never enters a result.  Outputs: the max over all H cells and the
corner H(m-1, n-1) per pair, and when traced a (P, m_pad, n_pad) int8
plane packed as ``back*9 + f*3 + e`` (``ops/traceback.py`` walks it).
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import threading

import jax
import jax.numpy as jnp
import numpy as np

from tsta_tpu.utils.cache import cache_dir

_SRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "cuda",
                    "psa_dp.cu")
ROWS_PER_THREAD = 8      # R in psa_dp.cu
MAX_THREADS = 256        # MAX_THREADS in psa_dp.cu
COL_ALIGN = 16           # traced planes are written 16 columns at a time

_LOCK = threading.Lock()
_REGISTERED = False


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    return os.path.join(home, "bin", "nvcc")


def _build() -> str:
    """Compile the kernel library if needed; return its path."""
    cmd = [_nvcc(), "-gencode", "arch=compute_90a,code=sm_90a",
           "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
           "-I", jax.ffi.include_dir()]
    h = hashlib.sha256()
    with open(_SRC, "rb") as f:
        h.update(f.read())
    h.update(" ".join(cmd[1:]).encode())
    out = os.path.join(cache_dir("cuda"),
                       "libtsta_psa_%s.so" % h.hexdigest()[:16])
    if os.path.exists(out):
        return out
    tmp = "%s.%d.tmp" % (out, os.getpid())
    proc = subprocess.run(cmd + ["-o", tmp, _SRC], capture_output=True,
                          text=True)
    if proc.returncode != 0:
        raise RuntimeError("building the CUDA PSA kernel failed (%s):\n%s"
                           % (" ".join(cmd), proc.stderr))
    os.replace(tmp, out)
    return out


def _register() -> None:
    global _REGISTERED
    with _LOCK:
        if _REGISTERED:
            return
        lib = ctypes.CDLL(_build())
        for name, sym in (("tsta_psa_score", lib.TstaPsaScore),
                          ("tsta_psa_traced", lib.TstaPsaTraced)):
            jax.ffi.register_ffi_target(name, jax.ffi.pycapsule(sym),
                                        platform="CUDA")
        _REGISTERED = True


def threads_for(m: int) -> int:
    """Threads per block: enough R-row strips to cover ``m`` rows in one
    stripe, in whole warps, at most MAX_THREADS."""
    strips = -(-m // ROWS_PER_THREAD)
    return min(MAX_THREADS, max(32, -(-strips // 32) * 32))


def dp(a, b, lens, params, traced: bool, threads: int):
    """The FFI call (traceable: usable under ``jit`` and ``shard_map``).

    Returns (score, corner) or (score, corner, plane)."""
    _register()
    P, n_pad = a.shape
    m_pad = b.shape[1]
    out = [jax.ShapeDtypeStruct((P,), jnp.int32),
           jax.ShapeDtypeStruct((P,), jnp.int32),
           jax.ShapeDtypeStruct((P, 4 * n_pad), jnp.int32)]   # row scratch
    if traced:
        out.append(jax.ShapeDtypeStruct((P, m_pad, n_pad), jnp.int8))
    res = jax.ffi.ffi_call("tsta_psa_traced" if traced else "tsta_psa_score",
                           tuple(out))(
        a, b, lens, match=np.int32(params[0]), mismatch=np.int32(params[1]),
        gap_extend=np.int32(params[2]), gap_open=np.int32(params[3]),
        threads=np.int32(threads))
    return (res[0], res[1], res[3]) if traced else (res[0], res[1])


@functools.partial(jax.jit, static_argnames=("params", "traced", "threads",
                                             "mesh"))
def _run(a, b, lens, params, traced, threads, mesh):
    if mesh is None:
        return dp(a, b, lens, params, traced, threads)
    from jax.sharding import PartitionSpec as P
    n_out = 3 if traced else 2
    return jax.shard_map(
        functools.partial(dp, params=params, traced=traced, threads=threads),
        mesh=mesh, in_specs=(P("data"),) * 3, out_specs=(P("data"),) * n_out,
        check_vma=False)(a, b, lens)


def align_stack(a_stack: np.ndarray, b_stack: np.ndarray, lens: np.ndarray,
                params, traced: bool = False, mesh=None):
    """Run the kernel on one padded stack; a mesh shards the pairs over its
    ``data`` axis (P must be a multiple of that axis).

    Returns device arrays (score, corner) or (score, corner, plane)."""
    if params[3] > 0:
        raise ValueError("the CUDA kernel requires gap_open <= 0 (got O=%d)"
                         % params[3])
    if a_stack.shape[1] % COL_ALIGN:
        raise ValueError("a stack width %d is not a multiple of %d"
                         % (a_stack.shape[1], COL_ALIGN))
    args = [jnp.asarray(a_stack), jnp.asarray(b_stack),
            jnp.asarray(lens, dtype=jnp.int32)]
    if mesh is not None:
        from tsta_tpu.parallel.mesh import data_sharding
        args = [jax.device_put(x, data_sharding(mesh)) for x in args]
    threads = threads_for(int(np.max(lens[:, 1])))
    return _run(*args, tuple(int(v) for v in params), traced, threads, mesh)
