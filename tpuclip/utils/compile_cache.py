"""Persistent XLA compilation cache.

The SO400M towers take tens of seconds to compile cold, and every CLI
invocation is a fresh process, so without a persistent cache users pay that
on every scan/search/serve start. The cache lives where
``JAX_COMPILATION_CACHE_DIR`` says when it is set; otherwise at the fixed
``<checkout>/.jax_cache``. The path is part of the cache's key, so it must
not move between runs (a per-run ``TPUCLIP_HOME`` would never hit).
"""

from __future__ import annotations

import os
from pathlib import Path

_ENABLED = False

# The checkout root: the directory that holds the ``tpuclip`` package.
_CHECKOUT = Path(__file__).resolve().parents[2]


def cache_dir() -> str:
    """The compilation cache directory (see the module docstring)."""
    env = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if env:
        return env
    return str(_CHECKOUT / ".jax_cache")


def enable_compilation_cache() -> None:
    """Idempotently point jax at the on-disk compilation cache."""
    global _ENABLED
    if _ENABLED:
        return
    import jax

    path = cache_dir()
    try:
        Path(path).mkdir(parents=True, exist_ok=True)
        jax.config.update("jax_compilation_cache_dir", path)
        # Cache everything that took meaningful time; tiny programs stay
        # out so the cache doesn't fill with test shapes.
        jax.config.update("jax_persistent_cache_min_compile_time_secs", 1.0)
        _ENABLED = True
    except OSError:  # a read-only checkout: the cache is an optimization
        pass
