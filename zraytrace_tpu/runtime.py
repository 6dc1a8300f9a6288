"""Runtime/platform helpers (no reference analogue — the reference is a
single static binary)."""

from __future__ import annotations

import os
from pathlib import Path

# The checkout that holds this package: <checkout>/zraytrace_tpu/runtime.py.
CHECKOUT = Path(__file__).resolve().parent.parent


def compilation_cache_dir() -> str | None:
    """Where compiled programs persist: ``None`` when
    ``JAX_COMPILATION_CACHE_DIR`` is set (JAX reads it itself), else the
    fixed ``<checkout>/.jax_cache``. A fixed path matters: the directory
    is part of the cache key, so a moving one never hits."""
    if os.environ.get("JAX_COMPILATION_CACHE_DIR"):
        return None
    return str(CHECKOUT / ".jax_cache")


def enable_compilation_cache() -> None:
    """Persist XLA compilations across processes (see
    ``compilation_cache_dir``)."""
    import jax

    cache_dir = compilation_cache_dir()
    if cache_dir is None:
        return
    os.makedirs(cache_dir, exist_ok=True)
    jax.config.update("jax_compilation_cache_dir", cache_dir)


def enable_debug_nans() -> None:
    """Opt-in NaN trapping (SURVEY.md §5: replaces the reference's Zig
    safe-build UB checks). Also honored via ZRAYTRACE_DEBUG_NANS=1."""
    import jax

    jax.config.update("jax_debug_nans", True)


def force_cpu() -> None:
    """Run on the host CPU instead of the accelerator: an explicit opt-in
    (the CLI's ``--cpu``), for small renders and debugging."""
    import jax

    jax.config.update("jax_platforms", "cpu")


def require_gpu(what: str) -> None:
    """Fail with a message unless JAX's default backend is a GPU: entry
    points that measure or render at full size never fall back to the
    CPU silently."""
    import jax

    backend = jax.default_backend()
    if backend != "gpu":
        raise SystemExit(
            f"{what}: no GPU found (JAX backend is {backend!r}); "
            "pass --cpu to render on the host CPU")
