"""Framework runtime knobs — the analog of the reference's HYPRE_Init-time
configuration (memory pools, exec policy; src/main.cpp:82-156).

The one knob is the persistent XLA compilation cache: an AMG setup and
solve compiles a few dozen program shapes, and with the cache a repeat run
of the same configuration loads them instead of compiling again.
"""

from __future__ import annotations

import os

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# fixed in-checkout default: the cache key includes the directory, so a
# path that moves between runs would never hit
DEFAULT_CACHE_DIR = os.path.join(_REPO, ".jax_cache")


def enable_compile_cache(cache_dir: str | None = None) -> str | None:
    """Point JAX at a persistent compilation cache directory.

    ``JAX_COMPILATION_CACHE_DIR``, when set, wins: JAX reads it itself and
    nothing here overrides it.  Otherwise the explicit argument (the CLI's
    ``compilation_cache_dir`` key) or ``<checkout>/.jax_cache`` is used.
    Returns the directory in effect.
    """
    env = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if env:
        return env
    import jax
    cache_dir = str(cache_dir or DEFAULT_CACHE_DIR)
    jax.config.update("jax_compilation_cache_dir", cache_dir)
    return cache_dir
