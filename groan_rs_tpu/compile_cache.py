"""Where JAX keeps its persistent compilation cache.

Entry points (`chip_smoke.py`, `bench.py`, the CLI, the test suite) call
`enable_compile_cache()` once before they compile anything; importing the
library sets no cache.  The directory is `JAX_COMPILATION_CACHE_DIR` when
that is set, and otherwise one fixed, git-ignored path inside the checkout:
the path is part of the cache key, so a directory that moves between runs
never hits.
"""

from __future__ import annotations

import os

ENV = "JAX_COMPILATION_CACHE_DIR"
DEFAULT_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))), ".jax_cache")


def enable_compile_cache() -> str:
    """Point JAX's persistent compilation cache at `JAX_COMPILATION_CACHE_DIR`
    (or `DEFAULT_DIR` when that is unset) and return the directory."""
    import jax

    path = os.environ.get(ENV) or DEFAULT_DIR
    os.makedirs(path, exist_ok=True)
    jax.config.update("jax_compilation_cache_dir", path)
    return path
