"""Where JAX's persistent compile cache lives, for every entry point.

The closed-loop graphs (the unrolled condensation, 500-tick whole-body
scans) take long to compile, so scripts, examples and the tests keep
compiled programs between runs. JAX reads `JAX_COMPILATION_CACHE_DIR`
itself; when it is set, `enable` leaves it alone. Otherwise the cache
goes to `<checkout>/.jax_cache`: a fixed path (it is part of the cache
key), inside the checkout, listed in .gitignore.
"""

from __future__ import annotations

import os

import jax

DEFAULT_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__)))), ".jax_cache")


def enable(min_compile_secs: float = 1.0) -> str:
    """Turn on the persistent compile cache; returns its directory.

    Programs that compile faster than `min_compile_secs` are not cached.
    """
    jax.config.update("jax_persistent_cache_min_compile_time_secs",
                      min_compile_secs)
    env_dir = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if env_dir:
        return env_dir
    jax.config.update("jax_compilation_cache_dir", DEFAULT_DIR)
    return DEFAULT_DIR
