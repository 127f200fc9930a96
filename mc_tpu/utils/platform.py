"""Start-up helper shared by the CLI, bench.py, chip_smoke.py and the tests.

Two settings, applied before the first computation:

* the JAX platform, when the caller pins one (``"gpu"`` or ``"cpu"``);
* the persistent compile cache: ``$JAX_COMPILATION_CACHE_DIR`` when it is
  set (JAX reads it itself, and nothing here overrides it), otherwise
  ``<checkout>/.jax_cache``, a fixed path so a later process finds what an
  earlier one compiled.
"""

from __future__ import annotations

import os
from typing import Optional

import jax

__all__ = ["compile_cache_dir", "start"]

CHECKOUT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def compile_cache_dir() -> str:
    """The compile-cache directory: the environment's, else the checkout's."""
    return (os.environ.get("JAX_COMPILATION_CACHE_DIR")
            or os.path.join(CHECKOUT, ".jax_cache"))


def start(platform: Optional[str] = None) -> str:
    """Pin ``platform`` (if given), set the compile cache, return the
    backend name JAX then reports."""
    if platform is not None:
        if platform not in ("gpu", "cpu"):
            raise ValueError(f"unknown platform {platform!r}; use 'gpu' "
                             "or 'cpu'")
        jax.config.update("jax_platforms",
                          "cuda" if platform == "gpu" else "cpu")
    if not os.environ.get("JAX_COMPILATION_CACHE_DIR"):
        jax.config.update("jax_compilation_cache_dir", compile_cache_dir())
    return jax.default_backend()
