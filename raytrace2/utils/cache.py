"""Persistent XLA compilation cache.

Compiling the integrator and the megakernel for a GPU takes tens of
seconds; the persistent cache lets every later process with the same
programs start without recompiling. Where ``JAX_COMPILATION_CACHE_DIR`` is
set, that directory is the cache and no other is set; otherwise the cache
is the checkout's fixed ``.jax_cache/`` (listed in .gitignore). The path is
part of the cache key's context, so it never depends on a temporary name,
a process id or the time. Safe to call multiple times.
"""

from __future__ import annotations

import os

ENV_VAR = "JAX_COMPILATION_CACHE_DIR"
DEFAULT_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
    ".jax_cache",
)


def cache_dir() -> str:
    """The directory the program compiles into."""
    return os.environ.get(ENV_VAR) or DEFAULT_DIR


def enable_compilation_cache() -> str | None:
    """Turn the persistent cache on for an accelerator backend; returns the
    directory, or None on the CPU (CPU compiles are fast, and CPU cache
    entries embed host CPU feature lists that mismatch across hosts)."""
    import jax

    if jax.default_backend() == "cpu":
        return None
    path = cache_dir()
    os.makedirs(path, exist_ok=True)
    jax.config.update("jax_compilation_cache_dir", path)
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.0)
    return path
