"""JAX persistent compilation cache for the scripts and examples.

Scripts call ``enable_compile_cache()`` once before their first jit; the
test suite does not. When ``JAX_COMPILATION_CACHE_DIR`` is set, JAX reads
it by itself and nothing is set here. Otherwise the cache lives at one
fixed, git-ignored path inside the checkout: a directory whose name
changes from run to run would never be hit again.
"""

from __future__ import annotations

import os
from pathlib import Path

ENV_VAR = "JAX_COMPILATION_CACHE_DIR"

#: ``<checkout>/.jax_cache`` (listed in .gitignore).
DEFAULT_DIR = Path(__file__).resolve().parents[2] / ".jax_cache"


def enable_compile_cache() -> str:
    """Turn on the persistent compilation cache; returns its directory."""
    import jax

    if os.environ.get(ENV_VAR):
        return os.environ[ENV_VAR]
    jax.config.update("jax_compilation_cache_dir", str(DEFAULT_DIR))
    return str(DEFAULT_DIR)
