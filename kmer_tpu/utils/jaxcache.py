"""Persistent XLA compilation cache (the wide sort graphs take seconds
to compile cold; cached recompiles are much cheaper).

Where JAX_COMPILATION_CACHE_DIR is set, JAX keeps its cache there and
this module sets no other path.  Otherwise the cache lives at the fixed
`<checkout>/.jax_cache`: the path is part of what makes a later run
find the entries again, so it must not move between runs.
"""

from __future__ import annotations

import os

_DEFAULT_DIR = os.path.join(os.path.dirname(os.path.dirname(
    os.path.dirname(os.path.abspath(__file__)))), ".jax_cache")


def enable_compilation_cache() -> None:
    import jax

    if not os.environ.get("JAX_COMPILATION_CACHE_DIR"):
        os.makedirs(_DEFAULT_DIR, exist_ok=True)
        jax.config.update("jax_compilation_cache_dir", _DEFAULT_DIR)
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 1.0)
    jax.config.update("jax_persistent_cache_min_entry_size_bytes", 0)
