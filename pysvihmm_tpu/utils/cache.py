"""Persistent compilation cache location, one rule for every entry point."""

from __future__ import annotations

import os

import jax

CHECKOUT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def enable_compile_cache() -> str:
    """Point JAX's persistent compilation cache at a fixed directory.

    ``JAX_COMPILATION_CACHE_DIR`` wins when it is set; otherwise the cache
    is ``<checkout>/.jax_cache`` (listed in .gitignore). Set through
    `jax.config.update`, so it holds even when jax was imported first.
    Returns the directory.
    """
    path = os.environ.get("JAX_COMPILATION_CACHE_DIR") or os.path.join(
        CHECKOUT, ".jax_cache"
    )
    jax.config.update("jax_compilation_cache_dir", path)
    return path
