"""Process-level JAX setup for CLI tools.

Every `ngstpu` CLI invocation is a fresh process; without a persistent
compilation cache each run would pay full XLA compile latency. The cache is
JAX_COMPILATION_CACHE_DIR where that is set, and otherwise the fixed
`<checkout>/.cache/jax` (a fixed path, because the path is part of the
cache's key).
"""

from __future__ import annotations

import os
import pathlib

DEFAULT_CACHE_DIR = (pathlib.Path(__file__).resolve().parents[2]
                     / ".cache" / "jax")

_done = False


def compile_cache_dir() -> str:
    """JAX_COMPILATION_CACHE_DIR if set, else `<checkout>/.cache/jax`."""
    return (os.environ.get("JAX_COMPILATION_CACHE_DIR")
            or str(DEFAULT_CACHE_DIR))


def setup_jax_cache() -> None:
    global _done
    if _done:
        return
    _done = True
    cache = compile_cache_dir()
    pathlib.Path(cache).mkdir(parents=True, exist_ok=True)
    import sys

    if "jax" not in sys.modules:
        # do NOT import jax just to configure it: host-placement CLI runs
        # never load it. jax reads these env vars at import time, so a
        # later lazy import still lands in the persistent cache.
        os.environ["JAX_COMPILATION_CACHE_DIR"] = cache
        os.environ.setdefault(
            "JAX_PERSISTENT_CACHE_MIN_COMPILE_TIME_SECS", "0.5")
        return
    import jax

    jax.config.update("jax_compilation_cache_dir", cache)
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.5)
