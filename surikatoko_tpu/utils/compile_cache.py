"""Persistent XLA compile cache for the entry points (chip_smoke.py, bench.py,
the demos).

JAX reads ``JAX_COMPILATION_CACHE_DIR`` itself, so when it is set nothing is
changed here. Otherwise the cache goes to ``.jax_cache/`` at the checkout
root. The path is fixed on purpose: it is part of what a later process looks
up, so a temporary or per-process directory would never be hit again.
"""

from __future__ import annotations

import os

import jax

CACHE_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(
        __file__)))), ".jax_cache")


def enable_compile_cache() -> str:
    """Point JAX's persistent compile cache at its directory; returns it."""
    env_dir = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if env_dir:
        return env_dir
    jax.config.update("jax_compilation_cache_dir", CACHE_DIR)
    return CACHE_DIR
