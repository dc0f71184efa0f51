"""Where JAX keeps its persistent compilation cache.

Every entry point (``chip_smoke.py``, ``bench.py``, ``cli/launch.py`` and
the test suite) goes through :func:`enable_compile_cache`:

- if ``JAX_COMPILATION_CACHE_DIR`` is set, JAX already reads it; nothing is
  set in code;
- otherwise the cache lives at a fixed directory inside the checkout
  (``<repo>/.jax_cache``, git-ignored), so repeated runs find it again.
"""

from __future__ import annotations

import os
from pathlib import Path

ENV_VAR = "JAX_COMPILATION_CACHE_DIR"
CHECKOUT_CACHE = Path(__file__).resolve().parents[2] / ".jax_cache"


def compile_cache_dir(subdir: str = "") -> str:
    """The cache directory: ``$JAX_COMPILATION_CACHE_DIR`` if set, else
    ``<repo>/.jax_cache[/subdir]``."""
    env = os.environ.get(ENV_VAR)
    if env:
        return env
    return str(CHECKOUT_CACHE / subdir if subdir else CHECKOUT_CACHE)


def enable_compile_cache(subdir: str = "",
                         min_compile_time_secs: float | None = None) -> str:
    """Point JAX's persistent compilation cache at :func:`compile_cache_dir`
    and return the directory. With ``JAX_COMPILATION_CACHE_DIR`` set this
    changes no setting at all."""
    path = compile_cache_dir(subdir)
    if os.environ.get(ENV_VAR):
        return path
    import jax
    jax.config.update("jax_compilation_cache_dir", path)
    if min_compile_time_secs is not None:
        jax.config.update("jax_persistent_cache_min_compile_time_secs",
                          min_compile_time_secs)
    return path
