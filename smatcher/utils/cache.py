"""Persistent XLA compile cache location — one rule for every entry point
(the CLI, bench.py, chip_smoke.py).

JAX keys a cached executable by, among others, the cache directory, so a
directory that moves never hits.  When JAX_COMPILATION_CACHE_DIR is set,
JAX reads it itself and nothing else is configured here; otherwise the
cache is `.jax_cache/` at the root of the checkout (git-ignored)."""

from __future__ import annotations

import os

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
DEFAULT_DIR = os.path.join(ROOT, ".jax_cache")


def enable_compile_cache() -> str:
    """Turn on the persistent compile cache; returns its directory."""
    path = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if path:
        return path
    import jax
    jax.config.update("jax_compilation_cache_dir", DEFAULT_DIR)
    return DEFAULT_DIR
