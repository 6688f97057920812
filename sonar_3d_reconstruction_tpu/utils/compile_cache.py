"""Persistent XLA compilation cache setup.

Entry points (bench, CLI, chip_smoke, the graft entry) call ``enable()``
explicitly — importing the library does NOT set global config.

- ``JAX_COMPILATION_CACHE_DIR`` set: JAX reads it itself, and ``enable()``
  sets no directory of its own.
- Otherwise an accelerator process caches under the fixed
  ``<checkout>/.jax_cache``.  The path is part of nothing but the checkout,
  so every process of one checkout finds what an earlier one compiled.
- A CPU process keeps no persistent cache: XLA:CPU executables bake in the
  compiling host's CPU features, and loading one written on another host
  can crash.
"""

from __future__ import annotations

import os

DEFAULT_CACHE_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
    ".jax_cache",
)


def cache_dir_for(platform: str) -> str | None:
    """The directory ``enable()`` uses for a process on ``platform``:
    the environment's choice, else the fixed checkout directory for an
    accelerator, else None (CPU: no persistent cache)."""
    env = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if env:
        return env
    if platform == "cpu":
        return None
    return DEFAULT_CACHE_DIR


def enable() -> str | None:
    """Enable the persistent compilation cache; returns the directory in
    use, or None.  Initializes the default JAX backend, so apply any
    platform override before calling it."""
    import jax

    cache_dir = cache_dir_for(jax.default_backend())
    if cache_dir is not None and not os.environ.get("JAX_COMPILATION_CACHE_DIR"):
        jax.config.update("jax_compilation_cache_dir", cache_dir)
    return cache_dir
