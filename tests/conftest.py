"""Test configuration: run on CPU with 8 virtual devices so multi-device
sharding tests work without accelerator hardware (SURVEY.md §4)."""

import os

# Must be set before jax is imported anywhere.
os.environ.setdefault("JAX_PLATFORMS", "cpu")
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8"
    ).strip()

import jax

# Tests run on the host CPU with 8 virtual devices even where a GPU is
# present; set before any backend is initialized.
jax.config.update("jax_platforms", "cpu")

import numpy as np
import pytest


@pytest.fixture(autouse=True, scope="module")
def _clear_jax_caches_per_module():
    """Release compiled executables between test modules.

    The full suite compiles hundreds of CPU programs in one process;
    past a cumulative threshold the XLA CPU JIT has segfaulted inside
    backend_compile_and_load (the same tests pass in any smaller
    grouping). Dropping the jit caches per module keeps the resident
    compiled-code footprint bounded; cross-module program reuse is
    minimal (each file renders its own shapes), so the recompile cost is
    small.
    """
    yield
    jax.clear_caches()
    # the cached sharded closures hold their own jit objects — empty
    # the closure cache too so their executables can be released
    from zraytrace_tpu.parallel import mesh as _mesh

    _mesh._sharded_wavefront.cache_clear()


@pytest.fixture(autouse=True)
def _no_persistent_compile_cache(monkeypatch, tmp_path):
    """Entry points (CLI, chip_smoke) enable the persistent compile cache
    in the checkout; tests keep it off. JAX read its own settings at
    import, so this only turns runtime.enable_compilation_cache into a
    no-op (and points child processes at a temporary cache)."""
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path / "jax_cache"))


@pytest.fixture(scope="session")
def three_balls_scene():
    from zraytrace_tpu.scenes import three_balls

    return three_balls()


@pytest.fixture(scope="session")
def rng():
    return np.random.default_rng(1234)
