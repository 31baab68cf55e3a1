"""Global configuration for the arrow_tpu engine.

This module MUST be imported before any other arrow_tpu module touches JAX:
Arrow semantics require true 64-bit integer / float types (Int64, UInt64,
Float64, Timestamp are first-class in the reference type system,
arrow-schema/src/datatype.rs:99-441), so we enable the x64 flag at import
time.
"""

from __future__ import annotations

import os

import jax

jax.config.update("jax_enable_x64", True)

_REPO_CACHE_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))), ".jax_cache")


def enable_compile_cache() -> str:
    """Turn on JAX's persistent compilation cache and return its directory.

    `JAX_COMPILATION_CACHE_DIR`, when set, is JAX's own setting and is left
    alone.  Otherwise the cache lives at the fixed path `<repo>/.jax_cache`:
    the directory is part of the cache key, so it must not move between
    runs.  Entry points (bench.py, chip_smoke.py, __graft_entry__.py) call
    this; library code never sets the cache.
    """
    if not os.environ.get("JAX_COMPILATION_CACHE_DIR"):
        jax.config.update("jax_compilation_cache_dir", _REPO_CACHE_DIR)
    jax.config.update("jax_persistent_cache_min_entry_size_bytes", -1)
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.0)
    return jax.config.jax_compilation_cache_dir
