"""Build and compile caches, kept in one git-ignored directory of the checkout.

``.tsta_cache/`` at the checkout root holds the compiled C engines, the
CUDA kernel library and (unless ``JAX_COMPILATION_CACHE_DIR`` is set) JAX's
persistent compilation cache.  The path is fixed, so a later process finds
what an earlier one compiled.
"""

from __future__ import annotations

import os

CHECKOUT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def cache_dir(name: str) -> str:
    """``<checkout>/.tsta_cache/<name>``, created on first use."""
    path = os.path.join(CHECKOUT, ".tsta_cache", name)
    os.makedirs(path, exist_ok=True)
    return path


def enable_compile_cache() -> None:
    """Point JAX's persistent compilation cache at the checkout's cache.

    Where ``JAX_COMPILATION_CACHE_DIR`` is set, JAX already uses it and
    nothing is changed here.
    """
    if os.environ.get("JAX_COMPILATION_CACHE_DIR"):
        return
    import jax
    jax.config.update("jax_compilation_cache_dir", cache_dir("jax"))
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 1.0)
