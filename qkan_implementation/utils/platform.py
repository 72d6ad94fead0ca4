"""Persistent compilation cache location.

JAX reads ``JAX_COMPILATION_CACHE_DIR`` itself, so when it is set nothing
here changes JAX's configuration.  Otherwise ``enable_compile_cache()``
points the cache at one fixed directory inside the checkout
(``.jax_cache``, listed in ``.gitignore``): the path is part of the
cache's key, so it must not move between runs.
"""

from __future__ import annotations

import os
from pathlib import Path

#: The default cache directory: fixed, inside the checkout.
REPO_CACHE_DIR = Path(__file__).resolve().parents[2] / ".jax_cache"


def enable_compile_cache() -> str:
    """Turn on JAX's persistent compilation cache; returns its directory.

    Call before the first compilation.  With ``JAX_COMPILATION_CACHE_DIR``
    set this only reports it; otherwise it sets ``REPO_CACHE_DIR``.
    """
    if os.environ.get("JAX_COMPILATION_CACHE_DIR"):
        return os.environ["JAX_COMPILATION_CACHE_DIR"]
    import jax

    jax.config.update("jax_compilation_cache_dir", str(REPO_CACHE_DIR))
    return str(REPO_CACHE_DIR)
