"""Persistent XLA compilation cache.

The cache key includes the directory, so the directory must not move
between runs: ``$JAX_COMPILATION_CACHE_DIR`` when it is set (JAX reads it
itself), otherwise ``.jax_cache`` at the root of the checkout.
"""

from __future__ import annotations

import os
from pathlib import Path

CACHE_ENV = "JAX_COMPILATION_CACHE_DIR"
DEFAULT_DIR = Path(__file__).resolve().parents[2] / ".jax_cache"


def enable_compile_cache() -> str:
    """Point JAX's persistent compile cache at its directory; returns it.

    Call from an entry point, after argument parsing and before the first
    compilation — never at import time."""
    env = os.environ.get(CACHE_ENV)
    if env:
        return env
    import jax

    jax.config.update("jax_compilation_cache_dir", str(DEFAULT_DIR))
    return str(DEFAULT_DIR)
