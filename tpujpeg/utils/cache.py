"""Where JAX keeps its persistent compilation cache.

One rule for every entry point: when JAX_COMPILATION_CACHE_DIR is set,
JAX reads it and nothing here overrides it; otherwise the cache lives at
the fixed path <checkout>/.jax_cache (listed in .gitignore).  The path is
part of the cache's key, so it must not move between runs.
"""

from __future__ import annotations

import os

ENV = "JAX_COMPILATION_CACHE_DIR"
DEFAULT_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
    ".jax_cache",
)


def compile_cache_dir() -> str:
    """Point JAX at the compile cache and return its directory."""
    env = os.environ.get(ENV)
    if env:
        return env
    import jax

    jax.config.update("jax_compilation_cache_dir", DEFAULT_DIR)
    return DEFAULT_DIR
