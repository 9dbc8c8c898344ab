"""The persistent compile cache, in one place.

`$JAX_COMPILATION_CACHE_DIR` when it is set; otherwise `.jax_cache` at
the root of the checkout (listed in `.gitignore`).  The path is part of
the cache key, so it is fixed rather than per run.
"""

from __future__ import annotations

import os

import jax

REPO_ROOT = os.path.dirname(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
)


def cache_dir(default_name: str = ".jax_cache") -> str:
    """The compile-cache directory (see module docstring)."""
    return os.environ.get("JAX_COMPILATION_CACHE_DIR") or os.path.join(
        REPO_ROOT, default_name
    )


def enable_compile_cache(default_name: str = ".jax_cache") -> str:
    """Point JAX's persistent compile cache at `cache_dir` and cache
    every compilation; returns the directory."""
    path = cache_dir(default_name)
    jax.config.update("jax_compilation_cache_dir", path)
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.0)
    return path
