"""Persistent XLA compile cache, one policy for every entry point.

If `JAX_COMPILATION_CACHE_DIR` is set, JAX reads it itself and this
module sets nothing. Otherwise the cache lives in one fixed directory
inside the checkout (`.jax_cache/`, git-ignored): a fixed path is part
of the cache key, so a directory that moved would never hit.
"""

from __future__ import annotations

import os

ENV_VAR = "JAX_COMPILATION_CACHE_DIR"
REPO_CACHE_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__)))), ".jax_cache")


def enable_compile_cache(min_compile_secs: float = 1.0) -> str:
    """Point JAX's persistent compile cache at its directory; returns
    the directory in use. Call before the first compilation."""
    env = os.environ.get(ENV_VAR)
    if env:
        return env
    import jax
    os.makedirs(REPO_CACHE_DIR, exist_ok=True)
    jax.config.update("jax_compilation_cache_dir", REPO_CACHE_DIR)
    jax.config.update("jax_persistent_cache_min_compile_time_secs",
                      min_compile_secs)
    return REPO_CACHE_DIR
