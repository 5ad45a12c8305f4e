"""Utility helpers (runtime configuration, profiling)."""

from raytrace2.utils.cache import enable_compilation_cache  # noqa: F401
