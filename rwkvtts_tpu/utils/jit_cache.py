"""Persistent XLA compilation cache setup.

Compiling the full-size decode and train programs takes tens of seconds;
the persistent cache makes later runs of the same programs start at once.
Call `enable()` early, before the first jit.

Where the cache lives: `JAX_COMPILATION_CACHE_DIR` when it is set (JAX reads
that variable itself, so no other directory is set in code), otherwise
`<checkout>/.jax_cache`. The path is part of what makes a cache hit, so it
is fixed: never temporary, never per process.
"""
from __future__ import annotations

import os
from typing import Optional

ENV_VAR = "JAX_COMPILATION_CACHE_DIR"
DEFAULT_DIR = os.path.abspath(
    os.path.join(os.path.dirname(__file__), "..", "..", ".jax_cache")
)


def cache_dir() -> str:
    """The directory the persistent cache uses on an accelerator."""
    return os.environ.get(ENV_VAR) or DEFAULT_DIR


def enable() -> Optional[str]:
    """Turn the persistent cache on for an accelerator backend and return
    its directory; on the CPU backend turn it off and return None (XLA:CPU
    executables reloaded from the cache are not portable across hosts)."""
    import jax

    if jax.default_backend() == "cpu":
        jax.config.update("jax_enable_compilation_cache", False)
        return None
    path = cache_dir()
    if not os.environ.get(ENV_VAR):
        os.makedirs(path, exist_ok=True)
        jax.config.update("jax_compilation_cache_dir", path)
    return path
