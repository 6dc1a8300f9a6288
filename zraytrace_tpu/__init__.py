"""zraytrace_tpu — a differentiable Monte Carlo path tracer in JAX.

A from-scratch re-design of the feature set of jsyrjala/zraytrace (a
single-threaded CPU Zig ray tracer) as a batched, differentiable, sharded
JAX/XLA framework:

- flat SoA scene arrays instead of tagged-union object graphs
- a wavefront bounce loop (``lax.while_loop`` with ray regeneration)
  instead of per-pixel recursion (reference: raytrace.zig:62-100)
- stateless counter-based RNG (PCG4D) instead of a shared mutable PRNG
  threaded through materials (reference: material.zig:64,101)
- host-built flattened BVH + stackless traversal instead of recursive
  pointer trees (reference: bvh.zig:32-206)
- pixel/sample sharding over a ``jax.sharding.Mesh`` with psum reductions
  (the reference has no parallelism at all, README.md:11)
- reverse-mode differentiable render path with gradient flow to sphere
  centers/radii, triangle vertices, material/texture parameters.
"""

__version__ = "0.1.0"

# XLA may run f32 matmuls at reduced precision by default (TF32 tensor
# cores on NVIDIA GPUs: 10-bit mantissa). The intersection math
# decomposes dot products into matmuls whose operands cancel
# catastrophically (e.g. |oc|^2 - r^2 for the r=100 ground sphere), and
# one-hot table lookups are matmuls too; reduced precision there
# produces phantom hits and wrong material ids. Full f32 precision is a
# correctness requirement for this framework, not a tuning choice. Opt
# out (at your own risk) with ZRAYTRACE_FAST_MATMUL=1.
import os as _os

if _os.environ.get("ZRAYTRACE_FAST_MATMUL", "0") != "1":
    import jax as _jax

    _jax.config.update("jax_default_matmul_precision", "highest")

from zraytrace_tpu.config import RenderParams
from zraytrace_tpu.scene import Scene, Camera

__all__ = ["RenderParams", "Scene", "Camera", "__version__"]
