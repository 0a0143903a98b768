"""Global configuration for the JAX runtime: the persistent compilation
cache, so repeated runs of the CLI skip recompiling the detection
programs."""

from __future__ import annotations

import os
import pathlib
import sys

# One fixed directory inside the checkout: JAX keys its cache entries by
# program, and a cache that moves between runs is never found again.
DEFAULT_CACHE_DIR = pathlib.Path(__file__).resolve().parents[1] / ".jax_cache"


def init_compilation_cache():
    """Enable JAX's persistent compilation cache.

    Where ``JAX_COMPILATION_CACHE_DIR`` is set, JAX reads it itself and no
    directory is set here.  Otherwise accelerator programs are cached in
    :data:`DEFAULT_CACHE_DIR`.  CPU programs are not cached: XLA:CPU
    executables are tuned to the compiling host's machine features, and
    loading one on another host can abort mid-run, while CPU compiles
    are cheap.  A cache directory that cannot be created is reported on
    stderr and the run goes on without a cache.
    """
    import jax

    jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.5)
    if os.environ.get("JAX_COMPILATION_CACHE_DIR"):
        return
    if jax.default_backend() == "cpu":
        return
    try:
        DEFAULT_CACHE_DIR.mkdir(exist_ok=True)
    except OSError as exc:
        sys.stderr.write(
            f"chromosight-tpu: no compilation cache ({DEFAULT_CACHE_DIR}: "
            f"{exc})\n"
        )
        return
    jax.config.update("jax_compilation_cache_dir", str(DEFAULT_CACHE_DIR))
