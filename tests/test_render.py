"""Renderer tests.

The strongest check is an independent scalar numpy re-implementation of the
reference's recursive ``rayColor`` (raytrace.zig:62-100) driven by the SAME
stateless RNG streams — the wavefront while-loop must reproduce it exactly,
pixel for pixel.
"""

import numpy as np
import jax.numpy as jnp
import pytest

from zraytrace_tpu import rng as zrng
from zraytrace_tpu import scene as sc
from zraytrace_tpu.camera import make_camera
from zraytrace_tpu.config import RenderParams
from zraytrace_tpu.render import background_color, render, trace_closest
from zraytrace_tpu.scene import SceneBuilder


def _mini_scene():
    """Three spheres + glass, reminiscent of the reference's render test
    (raytrace.zig:214-239) with a dielectric added for coverage."""
    b = SceneBuilder()
    gold = b.add_metal_color(sc.COLOR_GOLD)
    purple = b.add_lambertian_color((0.5, 0.0, 0.5))
    green = b.add_lambertian_color(sc.COLOR_GREEN)
    glass = b.add_dielectric(1.52)
    b.add_sphere((0.0, 0.0, 6.0), 2.0, gold)
    b.add_sphere((3.0, 1.0, 4.0), 1.0, purple)
    b.add_sphere((1.0, 102.5, 4.0), 100.0, green)
    b.add_sphere((-1.0, -0.5, 3.0), 0.7, glass)
    camera = make_camera((0.0, 0.0, -7.0), (0.0, 0.0, 1.0), (0.0, 1.0, 0.0), 45.0, 1.0)
    return b.build(), camera


# ---------------------------------------------------------------------------
# Independent scalar oracle (pure numpy, recursive like raytrace.zig:62-100)
# ---------------------------------------------------------------------------


def _oracle_trace(scene, o, d):
    """Scalar closest-hit over spheres (sphere.zig:31-69)."""
    t_min, t_max = 1e-3, np.inf
    best = None
    for i in range(scene.sph_center.shape[0]):
        c = np.asarray(scene.sph_center[i], np.float64)
        r = float(scene.sph_radius[i])
        oc = o - c
        half_b = oc @ d
        cc = oc @ oc - r * r
        disc = half_b * half_b - cc
        if disc < 0:
            continue
        root = np.sqrt(disc)
        for t in (-half_b - root, -half_b + root):
            if t_min < t < t_max:
                t_max = t
                p = o + t * d
                n = (p - c) / r
                best = (t, p, n, int(scene.sph_mat[i]), i)
                break
    return best


def _oracle_ray_color(scene, o, d, depth, pixel, sample, max_depth, seed):
    if depth <= 0:
        return np.zeros(3)
    hit = _oracle_trace(scene, o, d)
    if hit is None:
        t = 0.5 * (d[1] + 1.0)
        return (1 - t) * np.ones(3) + t * np.array([0.5, 0.7, 1.0])
    _, p, outward, mat_id, _ = hit
    front = d @ outward <= 0
    n = outward if front else -outward

    path_depth = max_depth - depth
    rnd = np.asarray(
        zrng.uniform4(seed, jnp.uint32(pixel), jnp.uint32(sample),
                      jnp.uint32(path_depth), zrng.STREAM_SCATTER)
    ).astype(np.float64)

    mt = int(scene.mat_type[mat_id])
    if mt == sc.LAMBERTIAN:
        ruv = np.asarray(
            zrng.random_unit_vector(jnp.float32(rnd[0]), jnp.float32(rnd[1]))
        ).astype(np.float64)
        new_d = n + ruv
        atten = np.asarray(scene.tex_color[int(scene.mat_tex[mat_id])], np.float64)
    elif mt == sc.METAL:
        new_d = d - 2 * (d @ n) * n
        if new_d @ n <= 0:
            return np.zeros(3)
        atten = np.asarray(scene.tex_color[int(scene.mat_tex[mat_id])], np.float64)
    else:  # dielectric (material.zig:109-123)
        ior = float(scene.mat_ior[mat_id])
        ratio = 1.0 / ior if front else ior
        cos_t = min(-(d @ n), 1.0)
        sin_t = np.sqrt(max(0.0, 1 - cos_t * cos_t))
        r0 = (1 - ratio) / (1 + ratio)
        schlick = r0 + (1 - r0) * (1 - cos_t) ** 5
        if ratio * sin_t > 1.0 or schlick > rnd[2]:
            new_d = d - 2 * (d @ n) * n
        else:
            perp = ratio * (d + cos_t * n)
            par = -np.sqrt(abs(1.0 - perp @ perp)) * n
            new_d = perp + par
        atten = np.ones(3)
    new_d = new_d / np.linalg.norm(new_d)
    return atten * _oracle_ray_color(
        scene, p, new_d, depth - 1, pixel, sample, max_depth, seed
    )


def _oracle_render(scene, camera, params):
    w, h, spp = params.width, params.height, params.samples_per_pixel
    img = np.zeros((h, w, 3))
    origin = np.asarray(camera.origin, np.float64)
    ll = np.asarray(camera.lower_left, np.float64)
    horiz = np.asarray(camera.horizontal, np.float64)
    vert = np.asarray(camera.vertical, np.float64)
    for y in range(h):
        for x in range(w):
            pixel = y * w + x
            acc = np.zeros(3)
            for s in range(spp):
                j = np.asarray(
                    zrng.uniform4(params.seed, jnp.uint32(pixel), jnp.uint32(s),
                                  jnp.uint32(0), zrng.STREAM_CAMERA)
                ).astype(np.float64)
                u = (x + j[0] - 0.5) / w
                v = (y + j[1] - 0.5) / h
                d = ll + u * horiz + v * vert - origin
                d = d / np.linalg.norm(d)
                acc += _oracle_ray_color(
                    scene, origin, d, params.max_depth, pixel, s,
                    params.max_depth, params.seed,
                )
            img[y, x] = acc / spp
    return img


def test_wavefront_matches_scalar_oracle():
    scene, camera = _mini_scene()
    params = RenderParams(width=8, height=8, samples_per_pixel=3, max_depth=5)
    img, stats = render(scene, camera, params)
    oracle = _oracle_render(scene, camera, params)
    np.testing.assert_allclose(img, oracle, atol=2e-4)
    assert stats.samples == 8 * 8 * 3
    assert stats.pixels == 64


def test_background_only_scene():
    b = SceneBuilder()
    b.add_lambertian_color(sc.COLOR_GREEN)
    b.add_sphere((0.0, 0.0, 1e6), 1.0, 0)  # effectively invisible
    camera = make_camera((0, 0, -7.0), (0, 0, 1.0), (0, 1.0, 0), 45.0, 1.0)
    scene = b.build()
    params = RenderParams(width=6, height=6, samples_per_pixel=2, max_depth=3)
    img, stats = render(scene, camera, params)
    # every ray escapes on the first bounce
    assert stats.background_hits == stats.samples
    assert stats.rays == stats.samples
    assert stats.reflections == 0
    # sky gradient: brighter blue toward the top (raytrace.zig:53-58)
    assert img[-1].mean(axis=(0,))[2] >= img[0].mean(axis=(0,))[2]
    assert img.min() >= 0.0 and img.max() <= 1.0 + 1e-6


def test_determinism_and_seed_sensitivity():
    scene, camera = _mini_scene()
    params = RenderParams(width=8, height=8, samples_per_pixel=2, max_depth=4)
    img1, _ = render(scene, camera, params)
    img2, _ = render(scene, camera, params)
    np.testing.assert_array_equal(img1, img2)
    img3, _ = render(scene, camera, RenderParams(
        width=8, height=8, samples_per_pixel=2, max_depth=4, seed=7))
    assert not np.array_equal(img1, img3)


def test_tiling_invariant():
    scene, camera = _mini_scene()
    base = dict(width=8, height=8, samples_per_pixel=2, max_depth=4)
    img1, _ = render(scene, camera, RenderParams(**base))
    img2, _ = render(scene, camera, RenderParams(**base, max_wavefront=16))
    np.testing.assert_allclose(img1, img2, atol=1e-6)


def test_counter_semantics():
    scene, camera = _mini_scene()
    params = RenderParams(width=8, height=8, samples_per_pixel=4, max_depth=6)
    _, stats = render(scene, camera, params)
    assert stats.samples == 8 * 8 * 4
    # every processed ray either scatters, misses, or is absorbed
    assert stats.rays >= stats.samples
    assert stats.rays <= stats.samples * params.max_depth
    # Every processed ray scatters, misses, or is absorbed; every sample
    # ends by miss, absorb, or depth exhaustion, so:
    # rays = reflections + misses + absorbs
    #      = reflections + samples - recursion_depth_hits.
    assert stats.rays == stats.reflections + stats.samples - stats.recursion_depth_hits
    assert stats.background_hits <= stats.samples
    assert stats.recursion_depth_hits <= stats.samples


def test_depth_one_is_direct_background_or_black():
    scene, camera = _mini_scene()
    params = RenderParams(width=8, height=8, samples_per_pixel=2, max_depth=1)
    img, stats = render(scene, camera, params)
    # with depth 1: any hit leads to a scatter whose continuation is depth 0
    # -> black (raytrace.zig:64-67); misses give background.
    assert stats.rays == stats.samples
    assert img.min() >= 0.0


def test_multi_slot_lanes_match_full_wavefront():
    """Lanes that walk several strided pixels (slots) must reproduce the
    one-lane-per-pixel result exactly (same stateless sample streams)."""
    scene, camera = _mini_scene()
    base = dict(width=8, height=8, samples_per_pixel=3, max_depth=4)
    img_full, stats_full = render(scene, camera, RenderParams(**base))
    for wavefront in (16, 24, 40):  # 4, 3, 2 slots (incl. ragged tails)
        img_s, stats_s = render(
            scene, camera, RenderParams(**base, max_wavefront=wavefront)
        )
        np.testing.assert_allclose(img_full, img_s, atol=1e-6)
        assert stats_s.samples == stats_full.samples
        assert stats_s.rays == stats_full.rays


def test_max_wavefront_padding_tail():
    scene, camera = _mini_scene()
    # 3 rows per tile with 8 rows -> last tile is padded
    img1, _ = render(scene, camera, RenderParams(
        width=8, height=8, samples_per_pixel=2, max_depth=3, max_wavefront=24))
    img2, _ = render(scene, camera, RenderParams(
        width=8, height=8, samples_per_pixel=2, max_depth=3))
    np.testing.assert_allclose(img1, img2, atol=1e-6)


@pytest.mark.parametrize("w,h,spp,depth,max_wavefront", [
    (7, 5, 2, 4, None),   # non-square, odd
    (5, 9, 2, 4, None),   # portrait
    (12, 4, 2, 3, 16),    # 3 slots per lane
    (9, 7, 2, 5, 20),     # 4 slots, ragged last slot
    (6, 6, 3, 3, 7),      # lane count that divides nothing
])
def test_wavefront_matches_oracle_shapes(w, h, spp, depth, max_wavefront):
    """The XLA wavefront reproduces the scalar oracle at any image shape
    and lane layout (one lane per pixel or several strided slots)."""
    scene, camera = _mini_scene()
    extra = {} if max_wavefront is None else dict(max_wavefront=max_wavefront)
    params = RenderParams(width=w, height=h, samples_per_pixel=spp,
                          max_depth=depth, **extra)
    img, stats = render(scene, camera, params)
    np.testing.assert_allclose(img, _oracle_render(scene, camera, params),
                               atol=2e-4)
    assert stats.samples == w * h * spp
    assert (stats.rays
            == stats.reflections + stats.samples - stats.recursion_depth_hits)


@pytest.mark.parametrize("chunks", [((0, 3),), ((0, 1), (1, 2)),
                                    ((0, 2), (2, 1))])
def test_sample_start_chunks_match_oracle(chunks):
    """Rendering the sample range in chunks (``sample_start``) sums to the
    oracle's full-range image: streams are keyed by absolute sample."""
    from zraytrace_tpu.render import _wavefront_jit

    scene, camera = _mini_scene()
    w, h, depth = 6, 5, 4
    params = RenderParams(width=w, height=h, samples_per_pixel=3,
                          max_depth=depth)
    total = np.zeros((w * h, 3))
    ids = jnp.arange(w * h, dtype=jnp.int32)
    for start, n in chunks:
        sums, _ = _wavefront_jit(scene, camera, ids, params.seed, w, h, n,
                                 depth, start, None, w * h, w * h, 1)
        total += np.asarray(sums[0], np.float64)
    img = (total / 3).reshape(h, w, 3)
    np.testing.assert_allclose(img, _oracle_render(scene, camera, params),
                               atol=2e-4)


@pytest.mark.parametrize("index", [0, 1, 2, 3, 4])
def test_reference_scene_wavefront_matches_scan(index):
    """Every reference scene (meshes, image textures, glass) renders the
    same through the wavefront as through the differentiable scan path,
    which draws the same RNG streams: two independent integrators."""
    from zraytrace_tpu.render_diff import render_diff
    from zraytrace_tpu.scenes import build_scene

    built = build_scene(index)
    w, h, spp, depth = 12, 8, 2, 3
    img, stats = render(built.scene, built.camera, RenderParams(
        width=w, height=h, samples_per_pixel=spp, max_depth=depth))
    ref = np.asarray(render_diff(built.scene, built.camera, w, h, spp, depth,
                                 branch_grad=False, bilinear_textures=False))
    assert stats.samples == w * h * spp
    diff = np.abs(img - ref)
    # the mesh recompute (diff_trace) rounds differently from the brute
    # scan, so a borderline hit may flip on a rare pixel
    assert np.median(diff) < 1e-5
    assert (diff > 1e-3).mean() < 0.02
