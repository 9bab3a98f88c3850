"""Where JAX keeps its persistent compilation cache — decided in one place.

Every entry point (bench.py, chip_smoke.py, the CLI, the scripts, the test
configuration) calls ``enable_compile_cache`` before its first compile.
"""

from __future__ import annotations

import os

# fixed directory inside the checkout (listed in .gitignore); a fixed path
# matters because the path is part of the cache key
CACHE_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(
        __file__)))), ".jax_cache")


def enable_compile_cache() -> str:
    """If JAX_COMPILATION_CACHE_DIR is set, JAX reads it itself and nothing
    is set here; otherwise point JAX at CACHE_DIR.  Returns the directory
    in use."""
    env = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if env:
        return env
    import jax

    jax.config.update("jax_compilation_cache_dir", CACHE_DIR)
    return CACHE_DIR
