"""Persistent XLA compilation cache.

The engine's jitted programs (vmapped stabilization steps, the 4K chains)
take tens of seconds to compile in a cold process.  JAX's persistent
compilation cache, keyed on the optimized HLO and the backend, lets every
later process load them from disk instead.

Placement: `JAX_COMPILATION_CACHE_DIR`, when set, is JAX's own setting and
wins; otherwise `<repo>/.cache/jax` (git-ignored), whether or not the
checkout is a git repository.  The path is part of the cache key, so it
must not move between runs.  Not enabled at import: entry points opt in.
"""

from __future__ import annotations

import os

_REPO = os.path.dirname(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
)
ENV_VAR = "JAX_COMPILATION_CACHE_DIR"


def cache_dir(environ=os.environ, repo: str = _REPO) -> tuple[str, bool]:
    """(directory, set_by_environment) the cache lives in."""
    env = environ.get(ENV_VAR)
    if env:
        return env, True
    return os.path.join(repo, ".cache", "jax"), False


def enable_default() -> str:
    """Turn the persistent cache on; returns its directory.

    With `JAX_COMPILATION_CACHE_DIR` set, JAX already reads it and no other
    directory is set here.  `min_compile_time_secs` is zeroed so even small
    programs cache: the win is process-restart latency, not disk economy.
    """
    import jax

    path, from_env = cache_dir()
    if not from_env:
        os.makedirs(path, exist_ok=True)
        jax.config.update("jax_compilation_cache_dir", path)
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.0)
    return path
