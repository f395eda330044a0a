"""Where JAX keeps its persistent compilation cache.

If `JAX_COMPILATION_CACHE_DIR` is set, JAX reads it itself and nothing is
set here. Otherwise the cache goes to a fixed directory inside the checkout
(`.jax_cache/`, listed in .gitignore): the cache key includes the path, so a
directory that moves between runs never hits.
"""

from __future__ import annotations

import os
from pathlib import Path
from typing import Optional

ENV_VAR = "JAX_COMPILATION_CACHE_DIR"
IN_TREE_DIR = Path(__file__).resolve().parents[2] / ".jax_cache"


def compile_cache_dir() -> str:
    """The directory the cache uses under the rule above."""
    return os.environ.get(ENV_VAR) or str(IN_TREE_DIR)


def enable_compile_cache(min_compile_secs: Optional[float] = None) -> str:
    """Point JAX's persistent cache at compile_cache_dir() and return it.
    `min_compile_secs` lowers JAX's threshold for what is worth caching."""
    import jax

    if not os.environ.get(ENV_VAR):
        jax.config.update("jax_compilation_cache_dir", str(IN_TREE_DIR))
    if min_compile_secs is not None:
        jax.config.update("jax_persistent_cache_min_compile_time_secs", min_compile_secs)
        jax.config.update("jax_persistent_cache_min_entry_size_bytes", 0)
    return compile_cache_dir()
