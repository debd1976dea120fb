"""JAX's persistent compilation cache at one fixed place.

If ``JAX_COMPILATION_CACHE_DIR`` is set, that directory is the cache and
no other is set in code. Otherwise the cache lives at ``.jax_cache`` in
the checkout (git-ignored): a fixed path, because the path is part of the
cache key and a directory that moves never hits.
"""

from __future__ import annotations

import os
import pathlib

import jax

__all__ = ["cache_dir", "enable"]

ENV = "JAX_COMPILATION_CACHE_DIR"
DEFAULT_DIR = pathlib.Path(__file__).resolve().parents[2] / ".jax_cache"


def cache_dir() -> str:
    """The directory the cache uses: the environment's, else the default."""
    return os.environ.get(ENV) or str(DEFAULT_DIR)


def enable() -> str:
    """Point JAX's persistent cache at :func:`cache_dir` and return it.
    Call before the first compilation."""
    path = cache_dir()
    if jax.config.jax_compilation_cache_dir != path:
        jax.config.update("jax_compilation_cache_dir", path)
    return path
