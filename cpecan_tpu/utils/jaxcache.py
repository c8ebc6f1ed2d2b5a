"""Persistent XLA compilation cache.

The engines compile one executable per (bucketed) shape; caching them on
disk makes repeated CLI invocations start fast. The cache directory is
JAX_COMPILATION_CACHE_DIR when that is set (JAX reads it itself, and
nothing here overrides it); otherwise the fixed directory `.jax_cache`
at the root of the checkout. The path is part of the cache key, so it is
never built from a temporary name, a pid or the time.

CPU processes (the test suite) keep the cache off unless the variable is
set: jaxlib 0.9.0's CPU backend aborts while serializing or
deserializing some large Pallas-interpret executables.
"""

import os

REPO_CACHE_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__)))), ".jax_cache")


def cache_dir() -> str:
    """Where compiled executables are cached."""
    return os.environ.get("JAX_COMPILATION_CACHE_DIR") or REPO_CACHE_DIR


def _configured_platform() -> str:
    """First configured JAX platform, read WITHOUT initializing a backend
    (this runs before jax.distributed.initialize in the CLIs)."""
    import jax

    platforms = jax.config.jax_platforms or os.environ.get(
        "JAX_PLATFORMS", "")
    return platforms.split(",")[0].strip().lower()


def enable_compilation_cache() -> str | None:
    """Turn the persistent cache on; returns its directory, or None when
    it stays off (CPU without JAX_COMPILATION_CACHE_DIR)."""
    if os.environ.get("JAX_COMPILATION_CACHE_DIR"):
        return cache_dir()
    if _configured_platform() == "cpu":
        return None
    import jax

    os.makedirs(REPO_CACHE_DIR, exist_ok=True)
    jax.config.update("jax_compilation_cache_dir", REPO_CACHE_DIR)
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.5)
    return REPO_CACHE_DIR
