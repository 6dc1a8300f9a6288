"""Render configuration.

Mirrors the reference ``RenderParams`` (raytrace.zig:102-108) plus the
few knobs the reference has no analogue for.
"""

from __future__ import annotations

import dataclasses

# Global dtype policy: f32 compute everywhere, matching the reference's
# ``BaseFloat = f32`` (base.zig:2). The path tracer is elementwise and
# bandwidth bound, so bf16 buys little and costs precision in the
# quadratic solves.
import jax.numpy as jnp

FLOAT = jnp.float32

# t-interval for valid intersections (raytrace.zig:71-72).
T_MIN = 1e-3
T_MAX = jnp.inf


@dataclasses.dataclass(frozen=True)
class RenderParams:
    """Parameters of one render (raytrace.zig:102-108).

    ``bvh`` mirrors ``bounded_volume_hierarchy``; like the reference
    (raytrace.zig:127) it is auto-disabled for small scenes.
    """

    width: int = 400
    height: int = 400
    samples_per_pixel: int = 100
    max_depth: int = 30
    bvh: bool = True
    # --- knobs with no reference analogue ---
    # Random seed for the stateless RNG streams.
    seed: int = 42
    # Maximum number of rays resident in one wavefront. Images with more
    # pixels than this give each lane several pixels (slots).
    max_wavefront: int = 1 << 20
    # The BVH traversal replaces the brute-force triangle scan above this
    # many triangles (render.maybe_build_bvh) — the reference's own
    # threshold of 10 surfaces (raytrace.zig:127). On an H100 (700 W
    # limit) the BVH rendered the teapot (6,320 triangles, 700x700,
    # 64 spp, depth 20) at 9.06M rays/s against brute force's 2.06M
    # (PERF.md).
    bvh_min_triangles: int = 10

    def __post_init__(self):
        if self.width <= 0 or self.height <= 0:
            raise ValueError("image dimensions must be positive")
        if self.samples_per_pixel <= 0:
            raise ValueError("samples_per_pixel must be positive")
        if self.max_depth <= 0:
            raise ValueError("max_depth must be positive")
