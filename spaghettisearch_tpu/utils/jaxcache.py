"""Persistent XLA compilation cache.

The cache is content-addressed on (HLO, compile options, platform), so
re-crawls, server restarts and repeated benchmarks reuse compiled programs
across processes. Where JAX_COMPILATION_CACHE_DIR is set, JAX itself keeps
the cache there and this module sets nothing. Otherwise the cache lives at
one fixed path inside the checkout, CACHE_DIR (listed in .gitignore): the
path is part of the cache key, so it must not move between runs.
"""

from __future__ import annotations

import os

CACHE_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
    ".jax_cache",
)


def enable_persistent_cache() -> str:
    """Turn on the persistent compile cache; returns its directory."""
    import jax

    env = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if env:
        return env
    os.makedirs(CACHE_DIR, exist_ok=True)
    jax.config.update("jax_compilation_cache_dir", CACHE_DIR)
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 1.0)
    return CACHE_DIR
