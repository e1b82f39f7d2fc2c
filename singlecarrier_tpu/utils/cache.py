"""Persistent compilation cache.

JAX reads ``JAX_COMPILATION_CACHE_DIR`` itself; where it is set, that
directory is the cache and no other is set in code.  Otherwise the
cache lives at a fixed path inside the checkout, ``<repo>/.jax_cache``
(listed in .gitignore): the path is part of the cache's key, so a
directory that moved would never hit.
"""

from __future__ import annotations

import os
from pathlib import Path

import jax

REPO_CACHE_DIR = Path(__file__).resolve().parents[2] / ".jax_cache"


def compilation_cache_dir() -> str:
    """The cache directory: ``JAX_COMPILATION_CACHE_DIR`` if set, else
    ``<repo>/.jax_cache``."""
    return os.environ.get("JAX_COMPILATION_CACHE_DIR") or str(
        REPO_CACHE_DIR)


def enable_compilation_cache() -> str:
    """Turn on JAX's persistent compilation cache; returns its
    directory.  Safe to call more than once."""
    path = compilation_cache_dir()
    if not os.environ.get("JAX_COMPILATION_CACHE_DIR"):
        os.makedirs(path, exist_ok=True)
        jax.config.update("jax_compilation_cache_dir", path)
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 1.0)
    jax.config.update("jax_persistent_cache_min_entry_size_bytes", 0)
    return path
