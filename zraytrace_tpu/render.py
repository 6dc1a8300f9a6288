"""Wavefront path-tracing engine.

The reference renders one pixel at a time with a recursive ``rayColor``
(raytrace.zig:62-100, 163-187). Here the whole image is a *wavefront*: one
lane per pixel, every lane tracing its own sample stream. A single
``lax.while_loop`` advances all lanes one bounce per iteration; when a
lane's path terminates (background / absorb / depth exhausted) the lane
immediately regenerates the next camera sample for its pixel — occupancy
stays near 100% with zero scatter/compaction, because accumulation is
lane-local.

Radiance identity (there are no emitters; the sky gradient is the only
light, raytrace.zig:53-58): a path's contribution is
``prod(attenuations) * background(last_dir)`` if it escapes, else black
(absorb, raytrace.zig:91-94, or depth exhaustion, raytrace.zig:64-67).

The reference's progress counters (raytrace.zig:20-34) are reproduced as
on-device two-limb uint32 accumulators (totals exceed int32 range at the
published workloads, README.md:58).
"""

from __future__ import annotations

import dataclasses
import math

import jax
import jax.numpy as jnp
import numpy as np

from zraytrace_tpu import camera as cam
from zraytrace_tpu import materials as mat
from zraytrace_tpu import rng as zrng
from zraytrace_tpu import vecmath as vm
from zraytrace_tpu.config import RenderParams, T_MIN
from zraytrace_tpu.geometry.sphere import intersect_spheres, sphere_surface
from zraytrace_tpu.geometry.triangle import intersect_triangles, triangle_surface
from zraytrace_tpu.scene import Scene

_BIG = np.float32(3.4e38)  # numpy scalar: no backend init at import

# Counter slots, mirroring Progress (raytrace.zig:20-34), plus wavefront
# iteration telemetry (lockstep steps executed; the ratio iterations *
# lanes / rays is the occupancy waste factor).
N_COUNTERS = 6
C_RAYS, C_REFLECTIONS, C_BACKGROUND, C_RECURSION, C_SAMPLES, C_ITERS = range(
    N_COUNTERS
)


@dataclasses.dataclass
class RenderStats:
    """Totals as published by the reference (raytrace.zig:188-201)."""

    rays: int = 0
    reflections: int = 0
    background_hits: int = 0
    recursion_depth_hits: int = 0
    samples: int = 0
    pixels: int = 0
    wavefront_iterations: int = 0
    preprocess_seconds: float = 0.0
    render_seconds: float = 0.0
    # Device -> host image readback, timed apart from render_seconds so
    # that rays_per_second reports device throughput alone.
    transfer_seconds: float = 0.0

    @property
    def rays_per_second(self) -> float:
        return self.rays / self.render_seconds if self.render_seconds else 0.0

    @property
    def pixels_per_second(self) -> float:
        return self.pixels / self.render_seconds if self.render_seconds else 0.0


def background_color(d: jnp.ndarray) -> jnp.ndarray:
    """Sky gradient for escaping rays (raytrace.zig:53-58). ``d`` unit."""
    t = 0.5 * (d[..., 1] + 1.0)
    white = jnp.array([1.0, 1.0, 1.0], jnp.float32)
    blue = jnp.array([0.5, 0.7, 1.0], jnp.float32)
    return (1.0 - t)[..., None] * white + t[..., None] * blue


def trace_closest(scene: Scene, o, d, t_min=T_MIN, t_max=_BIG, tri_bvh=None):
    """Closest-hit query over all primitives.

    The reference's linear surface scan with t_max tightening
    (raytrace.zig:75-81) becomes two typed batch intersections merged by
    min-t; spheres win exact ties because every reference scene inserts
    spheres before mesh triangles.

    ``tri_bvh``: optional flattened BVH (geometry/bvh.py). When given,
    triangles are found by stackless traversal instead of the brute-force
    scan — like the reference, the BVH is only built for larger scenes
    (raytrace.zig:124-133).

    Returns dict with: hit (N,), t, point (N,3), normal (N,3) flipped
    against the ray, front_face (N,), uv (N,2), mat_id (N,).
    """
    n = o.shape[0]

    # Sphere-only scenes (the 7-spheres showcase class) take a fully
    # fused path: an unrolled running-winner loop with zero gathers,
    # matmuls or argmins — everything one elementwise chain.
    if scene.n_triangles == 0 and 0 < scene.n_spheres <= 32:
        from zraytrace_tpu.geometry.sphere import (
            intersect_spheres_fused,
            sphere_attributes,
        )

        fs = intersect_spheres_fused(
            o, d, scene.sph_center, scene.sph_radius, scene.sph_mat,
            t_min, t_max,
        )
        hit = fs["hit"]
        t_attr = jnp.where(hit, fs["t"], 1.0)
        point, outward, uv = sphere_attributes(
            o, d, t_attr, fs["center"], fs["radius"]
        )
        front_face = vm.dot(d, outward) <= 0.0
        normal = jnp.where(front_face[:, None], outward, -outward)
        return dict(
            hit=hit, t=fs["t"], point=point, normal=normal,
            front_face=front_face, uv=uv, mat_id=fs["mat_id"],
        )
    if scene.n_spheres > 0:
        ts, si, _ = intersect_spheres(
            o, d, scene.sph_center, scene.sph_radius, t_min, t_max
        )
    else:
        ts = jnp.full((n,), _BIG)
        si = jnp.zeros((n,), jnp.int32)
    if tri_bvh is not None and scene.n_triangles > 0:
        from zraytrace_tpu.geometry.bvh import bvh_closest_triangle

        tt, ti, _, uv_t = bvh_closest_triangle(
            tri_bvh, scene.tri_a, scene.tri_b, scene.tri_c, o, d, t_min, t_max
        )
    else:
        tt, ti, _, uv_t = intersect_triangles(
            o, d, scene.tri_a, scene.tri_b, scene.tri_c, t_min, t_max
        )

    use_tri = tt < ts
    t = jnp.where(use_tri, tt, ts)
    hit = t < _BIG
    # Miss lanes carry t = _BIG; computing attributes at that distance
    # overflows to inf and NaN-poisons reverse-mode gradients through the
    # masked selects below. Attributes are evaluated at a safe t instead
    # (their values are ignored for miss lanes).
    t_attr = jnp.where(hit, t, 1.0)

    if scene.n_spheres > 0:
        p_s, n_s, uv_s = sphere_surface(o, d, t_attr, si, scene.sph_center, scene.sph_radius)
        from zraytrace_tpu.geometry.sphere import onehot_rows

        mat_s = jnp.round(onehot_rows(si, scene.sph_mat)).astype(jnp.int32)
    else:
        p_s = n_s = jnp.zeros_like(o)
        uv_s = jnp.zeros((n, 2), jnp.float32)
        mat_s = jnp.zeros((n,), jnp.int32)
    if scene.n_triangles > 0:
        p_t, n_t = triangle_surface(
            o, d, t_attr, ti, scene.tri_a, scene.tri_b, scene.tri_c)
        mat_t = scene.tri_mat[ti]
    else:
        p_t = n_t = jnp.zeros_like(o)
        mat_t = jnp.zeros((n,), jnp.int32)

    use_tri3 = use_tri[:, None]
    point = jnp.where(use_tri3, p_t, p_s)
    outward = jnp.where(use_tri3, n_t, n_s)
    uv = jnp.where(use_tri[:, None], uv_t, uv_s)
    mat_id = jnp.where(use_tri, mat_t, mat_s)

    # Front-face flip (hit_record.zig:28-41).
    front_face = vm.dot(d, outward) <= 0.0
    normal = jnp.where(front_face[:, None], outward, -outward)
    return dict(
        hit=hit, t=t, point=point, normal=normal,
        front_face=front_face, uv=uv, mat_id=mat_id,
    )


def _u64_add(acc, delta):
    """Two-limb uint32 add: acc (..., 2) [hi, lo] += delta (uint32)."""
    lo = acc[..., 1] + delta
    carry = (lo < delta).astype(jnp.uint32)
    return jnp.stack([acc[..., 0] + carry, lo], axis=-1)


def _count(mask) -> jnp.ndarray:
    return jnp.sum(mask, dtype=jnp.uint32)


def wavefront_trace(
    scene: Scene,
    camera: cam.Camera,
    pixel_base: jnp.ndarray,  # (N,) int32 first pixel id per lane
    seed,
    width,
    height,
    spp,
    max_depth,
    sample_start=0,
    tri_bvh=None,
    pixel_stride=None,
    n_pixels=None,
    n_slots: int = 1,
):
    """Trace samples ``[sample_start, sample_start + spp)`` for a set of
    pixels per lane. Returns (slot_sums (n_slots, N, 3), counters (6,2)).

    Lane ``i`` processes pixels ``pixel_base[i] + k * pixel_stride`` for
    ``k in [0, n_slots)`` (skipping ids >= n_pixels), one sample stream
    after another. Multi-pixel lanes average out per-pixel path-length
    variance, cutting the lockstep tail waste (heavy glass pixels no
    longer pin a whole lane for the entire render), and shrink resident
    state. ``n_slots`` is static (it shapes the output); everything else
    is traced, so one compiled program serves every resolution/spp/depth
    at a given lane count.

    ``sample_start`` offsets the per-lane sample stream — the 'sample'
    mesh axis shards this range and psums the pixel sums (the sample mean
    at raytrace.zig:182 is associative).
    """
    n = pixel_base.shape[0]
    width = jnp.asarray(width, jnp.int32)
    height = jnp.asarray(height, jnp.int32)
    spp = jnp.asarray(spp, jnp.int32)
    max_depth = jnp.asarray(max_depth, jnp.int32)
    sample_start = jnp.asarray(sample_start, jnp.int32)
    sample_end = sample_start + spp
    pixel_stride = jnp.asarray(
        n if pixel_stride is None else pixel_stride, jnp.int32
    )
    n_pixels = (
        width * height if n_pixels is None else jnp.asarray(n_pixels, jnp.int32)
    )
    fw = width.astype(jnp.float32)
    fh = height.astype(jnp.float32)

    def camera_rays(pixel_ids, sample_idx):
        j = zrng.uniform4(seed, pixel_ids, sample_idx, 0, zrng.STREAM_CAMERA)
        px = (pixel_ids % width).astype(jnp.float32)
        py = (pixel_ids // width).astype(jnp.float32)
        u, v = cam.pixel_uv(px, py, j[:, 0], j[:, 1], fw, fh)
        return cam.get_rays(camera, u, v)

    def lane_pixel(slot):
        return pixel_base + slot * pixel_stride

    o0, d0 = camera_rays(pixel_base, jnp.full((n,), sample_start, jnp.int32))
    state = dict(
        o=o0,
        d=d0,
        throughput=jnp.ones((n, 3), jnp.float32),
        acc=jnp.zeros((n, 3), jnp.float32),  # current pixel's sample sum
        path_depth=jnp.zeros((n,), jnp.int32),
        sample_idx=jnp.full((n,), sample_start, jnp.int32),
        slot=jnp.zeros((n,), jnp.int32),
        slot_sums=jnp.zeros((n_slots, n, 3), jnp.float32),
        counters=jnp.zeros((N_COUNTERS, 2), jnp.uint32),
    )

    def lane_alive(slot):
        return (slot < n_slots) & (lane_pixel(slot) < n_pixels)

    def cond(s):
        return jnp.any(lane_alive(s["slot"]))

    def body(s):
        pixel_ids = lane_pixel(s["slot"])
        active = lane_alive(s["slot"]) & (s["sample_idx"] < sample_end)
        # Depth check happens before tracing, exactly like the recursion
        # guard at raytrace.zig:64-67.
        exhausted = active & (s["path_depth"] >= max_depth)
        processing = active & ~exhausted

        h = trace_closest(scene, s["o"], s["d"], tri_bvh=tri_bvh)
        rnd = zrng.uniform4(
            seed, pixel_ids, s["sample_idx"], s["path_depth"], zrng.STREAM_SCATTER
        )
        new_dir, atten, absorbed = mat.scatter(
            scene, s["d"], h["normal"], h["front_face"], h["uv"], h["mat_id"], rnd
        )

        miss = processing & ~h["hit"]
        absorb_end = processing & h["hit"] & absorbed
        scattered = processing & h["hit"] & ~absorbed
        path_done = miss | absorb_end | exhausted

        # Radiance: only escaping paths contribute (sky is the only light).
        radiance = jnp.where(
            miss[:, None], s["throughput"] * background_color(s["d"]), 0.0
        )
        acc = s["acc"] + radiance

        counters = s["counters"]
        for c, mask in ((C_RAYS, processing), (C_REFLECTIONS, scattered),
                        (C_BACKGROUND, miss), (C_RECURSION, exhausted),
                        (C_SAMPLES, path_done)):
            counters = counters.at[c].set(_u64_add(counters[c], _count(mask)))
        counters = counters.at[C_ITERS].set(
            _u64_add(counters[C_ITERS], jnp.uint32(1))
        )

        # Continue scattered paths.
        sc3 = scattered[:, None]
        throughput = jnp.where(sc3, s["throughput"] * atten, s["throughput"])
        o = jnp.where(sc3, h["point"], s["o"])
        d = jnp.where(sc3, new_dir, s["d"])
        path_depth = jnp.where(scattered, s["path_depth"] + 1, s["path_depth"])

        # Sample bookkeeping: advance the sample; when the pixel's spp is
        # complete, commit its sum into the slot output and move the lane
        # to its next pixel.
        sample_idx = s["sample_idx"] + path_done.astype(jnp.int32)
        pixel_finished = path_done & (sample_idx >= sample_end)
        slot_sums = s["slot_sums"]
        for k in range(n_slots):
            commit_k = (pixel_finished & (s["slot"] == k))[:, None]
            slot_sums = slot_sums.at[k].set(
                slot_sums[k] + jnp.where(commit_k, acc, 0.0)
            )
        acc = jnp.where(pixel_finished[:, None], 0.0, acc)
        slot = s["slot"] + pixel_finished.astype(jnp.int32)
        sample_idx = jnp.where(pixel_finished, sample_start, sample_idx)

        # Regenerate the next camera sample on lanes whose path just
        # ended.
        o_new, d_new = camera_rays(lane_pixel(slot), sample_idx)
        pd3 = path_done[:, None]
        o = jnp.where(pd3, o_new, o)
        d = jnp.where(pd3, d_new, d)
        throughput = jnp.where(pd3, 1.0, throughput)
        path_depth = jnp.where(path_done, 0, path_depth)

        return dict(
            o=o, d=d, throughput=throughput, acc=acc, path_depth=path_depth,
            sample_idx=sample_idx, slot=slot, slot_sums=slot_sums,
            counters=counters,
        )

    final = jax.lax.while_loop(cond, body, state)
    return final["slot_sums"], final["counters"]


_wavefront_jit = jax.jit(wavefront_trace, static_argnames=("n_slots",))


def _counters_to_ints(counters: np.ndarray) -> list[int]:
    return [int(hi) * (1 << 32) + int(lo) for hi, lo in counters]


def maybe_build_bvh(scene: Scene, params: RenderParams):
    """Triangle engine choice: the BVH traversal above
    ``params.bvh_min_triangles`` triangles, the brute-force scan below.
    The reference builds its BVH above 10 surfaces (raytrace.zig:124-133);
    here the threshold is set from a measured brute-vs-BVH comparison
    (config.py)."""
    if params.bvh and scene.n_triangles > params.bvh_min_triangles:
        from zraytrace_tpu.geometry.bvh import build_tri_bvh

        return build_tri_bvh(scene.tri_a, scene.tri_b, scene.tri_c)
    return None


def wavefront_args(scene: Scene, camera: cam.Camera, params: RenderParams,
                   tri_bvh=None, spp=None, sample_start=0) -> tuple:
    """Positional arguments of ``_wavefront_jit`` for a full-image render
    of samples ``[sample_start, sample_start + spp)`` (default: all of
    ``params.samples_per_pixel``). Images with more pixels than
    ``params.max_wavefront`` give each lane several strided pixels
    (slots); pixel ids stay global so RNG streams are layout-invariant."""
    n_pixels = params.width * params.height
    n_lanes = min(n_pixels, params.max_wavefront)
    n_slots = math.ceil(n_pixels / n_lanes)
    return (scene, camera, jnp.arange(n_lanes, dtype=jnp.int32),
            params.seed, params.width, params.height,
            params.samples_per_pixel if spp is None else spp,
            params.max_depth, sample_start, tri_bvh, n_lanes, n_pixels,
            n_slots)


def render(scene: Scene, camera: cam.Camera, params: RenderParams):
    """Render a full image. Returns ``(image (H, W, 3) f32, RenderStats)``.

    Row 0 of the returned array is the image *bottom* (the reference's
    pixel buffer convention; the PNG writer flips, png_image.zig:136).
    Lane layout: ``wavefront_args``.
    """
    import time

    t0 = time.perf_counter()
    w, h, spp = params.width, params.height, params.samples_per_pixel
    n_pixels = w * h
    stats = RenderStats(pixels=n_pixels)
    args = wavefront_args(scene, camera, params,
                          maybe_build_bvh(scene, params))
    n_lanes, n_slots = args[-3], args[-1]

    t1 = time.perf_counter()
    sums, counters = jax.block_until_ready(_wavefront_jit(*args))
    t_dev = time.perf_counter()
    totals = np.asarray(counters, np.uint64)
    # pixel p lives at (slot p // n_lanes, lane p % n_lanes)
    sums = np.asarray(sums).reshape(n_slots * n_lanes, 3)[:n_pixels]
    image_np = (sums / spp).reshape(h, w, 3)
    t2 = time.perf_counter()

    rays, refl, bg, rec, samples, iters = _counters_to_ints(totals)
    stats.rays = rays
    stats.reflections = refl
    stats.background_hits = bg
    stats.recursion_depth_hits = rec
    stats.samples = samples
    stats.wavefront_iterations = iters
    stats.preprocess_seconds = t1 - t0
    stats.render_seconds = t_dev - t1
    stats.transfer_seconds = t2 - t_dev
    return image_np, stats
