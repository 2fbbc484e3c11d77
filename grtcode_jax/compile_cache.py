"""Persistent XLA compilation cache.

The step at production widths takes minutes to compile cold and seconds to
reload.  Where ``JAX_COMPILATION_CACHE_DIR`` is set, JAX keeps the cache
there and this module sets no other directory; otherwise the cache goes to
``<repo>/.jax_cache``.  The path is part of the cache key, so it is fixed.
"""
from __future__ import annotations

import os

import jax

ENV_VAR = "JAX_COMPILATION_CACHE_DIR"
DEFAULT_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))), ".jax_cache")


def enable_compile_cache() -> str:
    """Turn on the persistent cache for every compilation; returns its
    directory.  Call before the first compilation of the process."""
    cache_dir = os.environ.get(ENV_VAR) or DEFAULT_DIR
    if not os.environ.get(ENV_VAR):
        jax.config.update("jax_compilation_cache_dir", cache_dir)
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.0)
    jax.config.update("jax_persistent_cache_min_entry_size_bytes", 0)
    return cache_dir
