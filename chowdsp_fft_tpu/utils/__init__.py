"""Utilities: native planner bindings, roofline math, profiling helpers,
the compile-cache location."""

from . import compile_cache, native, profiling, roofline  # noqa: F401
