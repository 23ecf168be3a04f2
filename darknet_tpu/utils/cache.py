"""Persistent XLA compilation cache.

Each fresh Python process compiles the full yolov4 program again; the JAX
persistent cache lets every entry point (CLI, bench, trainer) reuse
executables compiled by an earlier process.

Where the cache lives: `JAX_COMPILATION_CACHE_DIR` when it is set (JAX reads
it itself, so no other directory is set here); otherwise the fixed
`<checkout>/.jax_cache` beside the package, which `.gitignore` lists.  The
path is part of the cache key, so it must not move between runs.
"""

from __future__ import annotations

import os

CHECKOUT_CACHE = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(
        __file__)))), ".jax_cache")

_enabled = False


def enable_persistent_cache() -> str:
    """Turn the persistent cache on; returns its directory."""
    global _enabled
    import jax

    env_dir = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    cache_dir = env_dir or CHECKOUT_CACHE
    if _enabled:
        return cache_dir
    if not env_dir:
        os.makedirs(cache_dir, exist_ok=True)
        jax.config.update("jax_compilation_cache_dir", cache_dir)
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 1.0)
    _enabled = True
    return cache_dir
