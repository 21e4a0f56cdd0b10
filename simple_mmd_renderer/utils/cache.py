"""Persistent XLA compilation cache.

The full pipeline takes minutes to compile at the flagship size; the on-disk
cache makes repeat processes (benchmarks, CLI runs) start in seconds.
"""

import os

# fixed path: the cache key includes nothing of the process, so a later run
# from the same checkout finds what an earlier one wrote
DEFAULT_DIR = os.path.join(os.path.dirname(os.path.dirname(
    os.path.dirname(os.path.abspath(__file__)))), ".jax_cache")


def enable_compilation_cache() -> str:
    """Turn on the persistent cache when the default backend is the GPU
    and return its directory: the one JAX already reads from
    JAX_COMPILATION_CACHE_DIR when that is set, else <repo>/.jax_cache. On
    the CPU (the tests) nothing is turned on: CPU AOT entries are
    machine-feature-specific and can SIGILL when loaded on another host."""
    import jax
    path = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if jax.default_backend() != "gpu":
        return path or ""
    if not path:
        path = DEFAULT_DIR
        jax.config.update("jax_compilation_cache_dir", path)
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 1.0)
    return path
