"""Where compiled XLA programs are cached across processes.

The extractor, tracking, mapping and GBA programs take long to compile, so
every entry point (CLI, bench, smoke check) keeps them in JAX's persistent
compilation cache. One rule decides the directory:

- ``JAX_COMPILATION_CACHE_DIR`` set: JAX reads it itself; nothing else is
  set here.
- otherwise: the fixed ``<checkout>/.jax_cache`` (listed in .gitignore). The
  path is part of the cache key, so it never moves.
"""
from __future__ import annotations

import os

import jax

ENV_VAR = "JAX_COMPILATION_CACHE_DIR"
DEFAULT_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(
        __file__)))),
    ".jax_cache",
)


def cache_dir() -> str:
    """The directory the persistent cache uses (after :func:`enable`)."""
    return os.environ.get(ENV_VAR) or DEFAULT_DIR


def enable() -> str:
    """Point JAX's persistent compilation cache at :func:`cache_dir`."""
    if os.environ.get(ENV_VAR):
        return os.environ[ENV_VAR]
    jax.config.update("jax_compilation_cache_dir", DEFAULT_DIR)
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 2)
    return DEFAULT_DIR
