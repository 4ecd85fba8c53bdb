"""One place that decides where JAX keeps its persistent compilation cache.

The cache key includes the directory, so the path must be stable between
runs: `JAX_COMPILATION_CACHE_DIR` when the caller sets it (JAX reads it
itself, nothing is set in code), otherwise `<checkout>/.jax_cache`.
"""
from __future__ import annotations

import os

CHECKOUT_DIR = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
DEFAULT_CACHE_DIR = os.path.join(CHECKOUT_DIR, ".jax_cache")


def compile_cache_dir() -> str:
    """The directory the persistent compilation cache lives in."""
    return os.environ.get("JAX_COMPILATION_CACHE_DIR") or DEFAULT_CACHE_DIR


def configure_compile_cache() -> str:
    """Point JAX's persistent compilation cache at compile_cache_dir()."""
    path = compile_cache_dir()
    if not os.environ.get("JAX_COMPILATION_CACHE_DIR"):
        import jax
        jax.config.update("jax_compilation_cache_dir", path)
    return path
