"""Mesh-scale differentiable rendering (diff_trace.py).

The winner-recompute split must (a) reproduce the brute differentiable
path's forward image exactly (same discrete winners, same f32-level
math), (b) produce the SAME gradients at fixed topology — non-winning
triangles sit behind ``where`` selects in the brute path, so both
compute the same local function — and (c) agree with finite
differences.

Reference mesh scenes: scenes.zig:102-232; gradient plan SURVEY.md §7.7.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from zraytrace_tpu import scene as sc
from zraytrace_tpu.camera import make_camera
from zraytrace_tpu.config import RenderParams
from zraytrace_tpu.inverse import merge_scene, split_scene
from zraytrace_tpu.render import render
from zraytrace_tpu.render_diff import render_diff
from zraytrace_tpu.scene import SceneBuilder


def _mesh_scene(k=6):
    """Ground+glass spheres and a k x k grid quad (2*k^2 triangles,
    >= 64 at k=6 so mesh_fast auto-engages), front faces toward the
    camera (one-sided det test, triangle.zig:62)."""
    b = SceneBuilder()
    red = b.add_lambertian_color((0.8, 0.2, 0.1))
    green = b.add_lambertian_color(sc.COLOR_GREEN)
    metal = b.add_metal_color(sc.COLOR_SILVER)
    glass = b.add_dielectric(1.52)
    b.add_sphere((1.4, -52.0, 4.0), 50.0, green)
    b.add_sphere((-1.2, 0.3, 2.0), 0.6, glass)
    b.add_sphere((1.3, 0.9, 2.6), 0.5, red)

    xs = np.linspace(-1.5, 1.5, k + 1)
    ys = np.linspace(-1.2, 1.6, k + 1)
    rng = np.random.default_rng(7)
    z = 4.0 + 0.15 * rng.standard_normal((k + 1, k + 1))
    for i in range(k):
        for j in range(k):
            p00 = (xs[i], ys[j], z[i, j])
            p10 = (xs[i + 1], ys[j], z[i + 1, j])
            p01 = (xs[i], ys[j + 1], z[i, j + 1])
            p11 = (xs[i + 1], ys[j + 1], z[i + 1, j + 1])
            # camera looks +z from z=-5; fn_z < 0 makes det > 0
            b.add_triangle(p00, p01, p10, metal)
            b.add_triangle(p10, p01, p11, metal)
    cam = make_camera((0, 0, -5.0), (0, 0, 1.0), (0, 1.0, 0), 45.0, 1.0)
    return b.build(), cam


def test_forward_fast_matches_brute():
    scene, camera = _mesh_scene()
    assert scene.n_triangles >= 64
    img_brute = np.asarray(render_diff(scene, camera, 12, 12, 3, 4,
                                       mesh_fast=False))
    img_fast = np.asarray(render_diff(scene, camera, 12, 12, 3, 4,
                                      mesh_fast=True))
    np.testing.assert_allclose(img_brute, img_fast, atol=2e-5)


def test_forward_matches_wavefront():
    """The auto (mesh_fast) diff renderer still reproduces the fast
    wavefront engine: same RNG streams, same winners."""
    scene, camera = _mesh_scene()
    params = RenderParams(width=12, height=12, samples_per_pixel=3,
                          max_depth=4)
    img_fast, _ = render(scene, camera, params)
    img_diff = np.asarray(
        render_diff(scene, camera, 12, 12, 3, 4, seed=params.seed,
                    bilinear_textures=False))
    np.testing.assert_allclose(img_fast, img_diff, atol=2e-5)


def _loss_grads(scene, camera, mesh_fast, w=10, h=10, spp=4, depth=3):
    params, static = split_scene(scene)

    def loss(p):
        img = render_diff(merge_scene(p, static), camera, w, h, spp, depth,
                          mesh_fast=mesh_fast)
        return jnp.mean((img - 0.25) ** 2)

    return jax.grad(loss)(params)


def test_grads_match_brute_path():
    """At fixed topology the winner-recompute gradients equal the brute
    path's for every parameter class (triangle verts, sphere params,
    materials)."""
    scene, camera = _mesh_scene()
    g_brute = _loss_grads(scene, camera, mesh_fast=False)
    g_fast = _loss_grads(scene, camera, mesh_fast=True)
    for field in ("tri_a", "tri_b", "tri_c", "sph_center", "sph_radius",
                  "tex_color", "mat_ior"):
        gb, gf = np.asarray(g_brute[field]), np.asarray(g_fast[field])
        assert np.all(np.isfinite(gf)), field
        scale = max(np.abs(gb).max(), 1e-12)
        np.testing.assert_allclose(gf, gb, atol=5e-4 * scale,
                                   rtol=2e-3, err_msg=field)


def test_grad_vs_finite_difference_vertex():
    scene, camera = _mesh_scene()
    params, static = split_scene(scene)
    w = h = 10

    def loss(p):
        img = render_diff(merge_scene(p, static), camera, w, h, 6, 3,
                          mesh_fast=True)
        return jnp.mean((img - 0.25) ** 2)

    # pick a triangle that actually covers screen area: the grid center
    t_idx = scene.n_triangles // 2
    g = jax.grad(loss)(params)["tri_a"][t_idx, 0]
    eps = 2e-3
    pp = {k: v for k, v in params.items()}
    pp["tri_a"] = params["tri_a"].at[t_idx, 0].add(eps)
    pm = {k: v for k, v in params.items()}
    pm["tri_a"] = params["tri_a"].at[t_idx, 0].add(-eps)
    fd = (loss(pp) - loss(pm)) / (2 * eps)
    assert np.isfinite(float(g))
    np.testing.assert_allclose(float(g), float(fd), rtol=0.15,
                               atol=1e-7)
