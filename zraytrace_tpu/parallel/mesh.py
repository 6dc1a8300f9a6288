"""Device-mesh parallelism.

The reference is strictly single-threaded (README.md:11; the pixel loop at
raytrace.zig:162-187 is sequential), so everything here is new design per
SURVEY.md §2:

- mesh axes ``('data', 'sample')``: pixel tiles shard over ``data``
  (the per-pixel loop, raytrace.zig:163-168), sample batches shard over
  ``sample`` (the spp loop, raytrace.zig:172-179). The sample mean
  (raytrace.zig:182) is associative, so partial pixel sums ``psum`` over
  the ``sample`` axis.
- scene/BVH arrays are replicated; gradient reductions (inverse.py) psum
  over both axes.
- collectives are XLA's (NVLink within a host) — expressed with
  ``shard_map`` — never hand-rolled transport.

Multi-host: the same SPMD program runs on every host after
``jax.distributed.initialize()``; nothing here is host-count-specific.
"""

from __future__ import annotations

import functools
import math

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from zraytrace_tpu import camera as cam
from zraytrace_tpu.config import RenderParams
from zraytrace_tpu.render import RenderStats, wavefront_trace
from zraytrace_tpu.scene import Scene

DATA_AXIS = "data"
SAMPLE_AXIS = "sample"


def make_mesh(n_data: int | None = None, n_sample: int = 1, devices=None) -> Mesh:
    """Mesh over ``('data', 'sample')``. Defaults to all devices on data."""
    devices = np.asarray(devices if devices is not None else jax.devices())
    if n_data is None:
        n_data = devices.size // n_sample
    assert n_data * n_sample == devices.size, (
        f"{devices.size} devices cannot form a {n_data}x{n_sample} mesh"
    )
    return Mesh(devices.reshape(n_data, n_sample), (DATA_AXIS, SAMPLE_AXIS))


def replicate(tree, mesh: Mesh):
    """Place every leaf replicated on the mesh (scene/BVH arrays)."""
    sharding = NamedSharding(mesh, P())
    return jax.device_put(tree, sharding)


def shard_lanes(lanes: jnp.ndarray, mesh: Mesh):
    """Shard a flat lane array over the data axis."""
    return jax.device_put(lanes, NamedSharding(mesh, P(DATA_AXIS)))


@functools.lru_cache(maxsize=32)
def _sharded_wavefront(mesh: Mesh, n_slots: int):
    """shard_map'd wavefront: each shard traces its lane slice (with
    strided multi-pixel slots, exactly like the single-device engine) for
    its sample slice; pixel sums psum over the sample axis.

    lru_cached on the static config: a fresh jitted closure per
    ``render_sharded`` call would re-trace and re-compile every render."""

    def fn(scene, camera, pixel_ids, seed, width, height, spp_local,
           max_depth, sample_starts, stride, n_pixels, tri_bvh):
        # pixel_ids: (N/d,) local; sample_starts: (1,) local slice start.
        slot_sums, counters = wavefront_trace(
            scene, camera, pixel_ids, seed, width, height,
            spp_local, max_depth, sample_start=sample_starts[0],
            tri_bvh=tri_bvh, pixel_stride=stride, n_pixels=n_pixels,
            n_slots=n_slots,
        )
        sums = jax.lax.psum(slot_sums, SAMPLE_AXIS)
        return sums, counters[None]

    return jax.jit(
        jax.shard_map(
            fn,
            mesh=mesh,
            in_specs=(
                P(),  # scene (replicated)
                P(),  # camera
                P(DATA_AXIS),  # pixel lanes
                P(),  # seed
                P(),  # width
                P(),  # height
                P(),  # spp per sample-shard
                P(),  # max depth
                P(SAMPLE_AXIS),  # per-shard sample offsets
                P(),  # lane stride (global)
                P(),  # n_pixels
                P(),  # tri_bvh (replicated or None)
            ),
            out_specs=(P(None, DATA_AXIS), P((DATA_AXIS, SAMPLE_AXIS))),
            check_vma=False,
        )
    )


def render_sharded(
    scene: Scene, camera: cam.Camera, params: RenderParams, mesh: Mesh,
    sample_start: int = 0,
):
    """Distributed forward render. Returns ``(image (H,W,3), RenderStats)``.

    Pixels shard over ``data`` (padding lanes idle), spp splits over
    ``sample`` (must divide evenly). The per-shard engine is the one
    ``render()`` runs: strided multi-pixel slots and the same BVH or
    brute-force triangle choice (render.maybe_build_bvh).

    ``sample_start`` offsets the global sample range (streams are keyed
    by absolute sample index) — checkpoint.render_sharded_checkpointed
    chunks long distributed renders with it; the offset rides in the
    traced per-shard start array, so chunking costs no recompiles.
    """
    import time

    from zraytrace_tpu.render import maybe_build_bvh

    n_data = mesh.shape[DATA_AXIS]
    n_sample = mesh.shape[SAMPLE_AXIS]
    w, h, spp = params.width, params.height, params.samples_per_pixel
    if spp % n_sample:
        raise ValueError(f"spp={spp} must divide over sample axis {n_sample}")
    spp_local = spp // n_sample
    n_pixels = w * h

    t0 = time.perf_counter()
    tri_bvh = maybe_build_bvh(scene, params)
    n_lanes = math.ceil(min(n_pixels, params.max_wavefront) / n_data) * n_data
    n_slots = math.ceil(n_pixels / n_lanes)
    ids = np.arange(n_lanes, dtype=np.int32)
    # Padding lanes get an id >= n_pixels: lane_alive() is false from the
    # start, so they stay idle and contribute nothing to image or counters
    # (re-tracing pixel 0 would over-report RenderStats).
    ids[n_pixels:] = n_pixels
    sample_starts = (jnp.int32(sample_start)
                     + jnp.arange(n_sample, dtype=jnp.int32) * spp_local)

    scene_r = replicate(scene, mesh)
    camera_r = replicate(camera, mesh)
    tri_bvh_r = replicate(tri_bvh, mesh) if tri_bvh is not None else None
    ids_s = shard_lanes(jnp.asarray(ids), mesh)
    fn = _sharded_wavefront(mesh, n_slots)
    t1 = time.perf_counter()
    sums, counters = jax.block_until_ready(fn(
        scene_r, camera_r, ids_s, params.seed, w, h, spp_local,
        params.max_depth, sample_starts, n_lanes, n_pixels, tri_bvh_r,
    ))
    t_dev = time.perf_counter()
    if jax.process_count() > 1:
        # Multi-controller: outputs are global arrays whose shards live on
        # other hosts; gather them so every host returns the full image.
        from jax.experimental import multihost_utils

        sums = multihost_utils.process_allgather(sums, tiled=True)
        counters = multihost_utils.process_allgather(counters, tiled=True)
    c = np.asarray(counters).astype(np.uint64)
    # pixel p lives at (slot p // n_lanes, lane p % n_lanes)
    sums = np.asarray(sums).reshape(n_slots * n_lanes, 3)[:n_pixels]
    # (grid, 6, 2) two-limb uint32 -> per-shard ints -> totals (carries
    # cannot be summed limb-wise).
    totals = (c[..., 0] * (1 << 32) + c[..., 1]).sum(axis=0)
    t2 = time.perf_counter()

    image = (sums / spp).reshape(h, w, 3)
    rays, refl, bg, rec, samples, iters = (int(x) for x in totals)
    stats = RenderStats(
        rays=rays, reflections=refl, background_hits=bg,
        recursion_depth_hits=rec, samples=samples, pixels=n_pixels,
        wavefront_iterations=iters,
        preprocess_seconds=t1 - t0, render_seconds=t_dev - t1,
        transfer_seconds=t2 - t_dev,
    )
    return image, stats
