"""Persistent compile cache for the entry scripts (chip_smoke.py, bench.py,
examples/python/hm_bethe.py).

The cache lives in ``$JAX_COMPILATION_CACHE_DIR`` when that is set, and
otherwise at the fixed path ``<checkout>/.jax_cache`` (listed in
.gitignore): the path is part of the cache key, so it must not move between
runs.  The CPU test suite stays uncached (tests/conftest.py)."""
from __future__ import annotations

import os

CHECKOUT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def compile_cache_dir() -> str:
    return (os.environ.get("JAX_COMPILATION_CACHE_DIR")
            or os.path.join(CHECKOUT, ".jax_cache"))


def enable_compile_cache() -> str:
    """Point JAX's persistent compilation cache at :func:`compile_cache_dir`
    and return that directory."""
    import jax
    path = compile_cache_dir()
    jax.config.update("jax_compilation_cache_dir", path)
    return path
