"""Persistent XLA compilation cache location.

The fused search program takes tens of seconds to compile, so every entry
point keeps compiled programs on disk. Where JAX_COMPILATION_CACHE_DIR is
set, JAX reads it itself and this module sets nothing. Otherwise the cache
is `<checkout>/tmp/jax_cache`, resolved from this package's own path, so
the same directory (and thus the same cache key) is used whatever the
working directory.
"""
from __future__ import annotations

import os
import sys
from pathlib import Path

ENV_VAR = "JAX_COMPILATION_CACHE_DIR"


def default_cache_dir() -> Path:
    """`<checkout>/tmp/jax_cache` of the checkout holding this package."""
    return Path(__file__).resolve().parents[2] / "tmp" / "jax_cache"


def enable_compile_cache() -> Path | None:
    """Point JAX's persistent compilation cache at the checkout's cache
    directory unless the environment already names one. Returns the
    directory set, or None when the environment's choice stands or the
    directory cannot be created (reported on stderr)."""
    if os.environ.get(ENV_VAR):
        return None
    import jax
    d = default_cache_dir()
    try:
        d.mkdir(parents=True, exist_ok=True)
    except OSError as e:
        print(f"warning: compilation cache disabled: cannot create {d}: {e}",
              file=sys.stderr)
        return None
    jax.config.update("jax_compilation_cache_dir", str(d))
    return d
