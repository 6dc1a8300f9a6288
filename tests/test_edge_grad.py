"""Edge-aware (silhouette) gradient tests — the analytic replacement for
the round-1 finite-difference hybrid (edge_grad.py).

The decisive check: for a matte sphere against the sky, the loss
derivative w.r.t. radius/center is almost entirely a COVERAGE term.
Plain analytic gradients miss it by orders of magnitude; the edge-aware
factor must match correlated finite differences closely."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from zraytrace_tpu import scene as sc
from zraytrace_tpu.camera import make_camera
from zraytrace_tpu.inverse import make_loss_fn, split_scene


def _sphere_scene():
    b = sc.SceneBuilder()
    red = b.add_lambertian_color((0.8, 0.1, 0.1))
    b.add_sphere((0.0, 0.0, 5.0), 1.0, red)
    camera = make_camera((0.0, 0.0, -2.0), (0.0, 0.0, 1.0),
                         (0.0, 1.0, 0.0), 45.0, 1.0)
    return b.build(), camera


def _fd(loss_jit, params, field, i, h):
    p = np.asarray(params[field]).copy().ravel()
    vals = []
    for s in (+1, -1):
        q = p.copy()
        q[i] += s * h
        vals.append(float(loss_jit(
            {**params, field: jnp.asarray(q.reshape(params[field].shape))})))
    return (vals[0] - vals[1]) / (2 * h)


def test_sphere_silhouette_gradient_matches_fd():
    scene, camera = _sphere_scene()
    params, static = split_scene(scene)
    w = h = 64
    spp, depth = 128, 3
    target = jnp.zeros((h, w, 3), jnp.float32)

    loss_plain = make_loss_fn(static, camera, target, w, h, spp, depth)
    loss_edge = make_loss_fn(static, camera, target, w, h, spp, depth,
                             edge_eps=0.01)

    # forward values identical: the edge factor is exactly 1.0
    np.testing.assert_allclose(float(jax.jit(loss_plain)(params)),
                               float(jax.jit(loss_edge)(params)), rtol=1e-6)

    # two-bandwidth averaging now lives in the library (tuple eps ->
    # geometric-mean factor -> mean of gradients)
    g_edge = jax.grad(make_loss_fn(static, camera, target, w, h, spp,
                                   depth, edge_eps=(0.01, 0.02)))(params)
    g_plain = jax.grad(loss_plain)(params)
    loss_jit = jax.jit(loss_plain)
    fd_r = np.mean([_fd(loss_jit, params, "sph_radius", 0, hh)
                    for hh in (0.01, 0.02)])
    fd_z = np.mean([_fd(loss_jit, params, "sph_center", 2, hh)
                    for hh in (0.01, 0.02)])

    er = float(g_edge["sph_radius"][0])
    ez = float(g_edge["sph_center"][0, 2])
    # plain analytic misses the coverage term by orders of magnitude
    assert abs(float(g_plain["sph_radius"][0])) < 0.05 * abs(fd_r)
    # edge-aware matches correlated FD
    assert abs(er - fd_r) <= 0.05 * abs(fd_r), (er, fd_r)
    assert abs(ez - fd_z) <= 0.15 * abs(fd_z), (ez, fd_z)


def test_triangle_vertex_silhouette_signal():
    """Vertex-level silhouette gradients exist without FD: moving a
    triangle vertex must change the loss gradient through coverage."""
    b = sc.SceneBuilder()
    red = b.add_lambertian_color((0.8, 0.1, 0.1))
    # winding chosen front-facing for the one-sided test
    # (triangle.zig:62): apex is vertex b
    tris = np.asarray(
        [[[-1.0, -0.8, 5.0], [0.0, 1.2, 5.0], [1.0, -0.8, 5.0]]], np.float32)
    b.add_triangles(tris[:, 0], tris[:, 1], tris[:, 2], red)
    scene = b.build()
    camera = make_camera((0.0, 0.0, -2.0), (0.0, 0.0, 1.0),
                         (0.0, 1.0, 0.0), 45.0, 1.0)
    params, static = split_scene(scene)
    w = h = 48
    target = jnp.zeros((h, w, 3), jnp.float32)

    # barycentric margins want ~half the sphere bandwidth (their bias
    # grows superlinearly past 0.01; edge_grad.py module docstring)
    loss_edge = make_loss_fn(static, camera, target, w, h, 16, 2,
                             edge_eps=(0.005, 0.01))
    loss_plain = make_loss_fn(static, camera, target, w, h, 16, 2)
    g_edge = jax.grad(loss_edge)(params)
    g_plain = jax.grad(loss_plain)(params)
    # growing the triangle replaces BRIGHT sky pixels with the darker red
    # surface, so d loss / d (apex y) is negative — and entirely a
    # coverage term, absent without edge_eps
    apex_dy = float(g_edge["tri_b"][0, 1])

    # FD cross-check on the apex-y derivative (two step sizes: a single
    # step's own O(h) bias is at the tolerance scale)
    loss_jit = jax.jit(loss_plain)
    fd = np.mean([_fd(loss_jit, params, "tri_b", 1, hh)
                  for hh in (0.02, 0.03)])
    assert fd < 0 and apex_dy < 0, (apex_dy, fd)
    assert abs(apex_dy - fd) <= 0.10 * abs(fd), (apex_dy, fd)
    assert abs(float(g_plain["tri_b"][0, 1])) < 0.1 * abs(apex_dy)


def test_edge_factor_no_nans():
    """The factor must stay finite through the backward pass even for
    rays that near-miss nothing (margin clamp)."""
    from tests.test_render import _mini_scene
    from zraytrace_tpu.render_diff import render_diff

    scene, camera = _mini_scene()

    def f(radii):
        img = render_diff(scene._replace(sph_radius=radii), camera,
                          16, 16, 2, 3, edge_eps=0.01)
        return jnp.sum(img)

    g = jax.grad(f)(scene.sph_radius)
    assert np.isfinite(np.asarray(g)).all()


def test_occlusion_boundary_gradient_matches_fd():
    """t-crossing boundaries (round 3): two overlapping lambertian
    spheres meet along a crossing circle — a visibility boundary that
    is NOT a silhouette (both sides are hits). The occlusion term of
    edge_factor must close most of the gap between the
    silhouette-only gradient and correlated FD."""
    import zraytrace_tpu.edge_grad as eg

    b = sc.SceneBuilder()
    dark = b.add_lambertian_color((0.05, 0.05, 0.05))
    bright = b.add_lambertian_color((0.9, 0.9, 0.9))
    b.add_sphere((-0.45, 0.0, 5.0), 1.0, dark)
    b.add_sphere((0.45, 0.0, 5.0), 1.0, bright)
    scene = b.build()
    camera = make_camera((0.0, 0.0, -2.0), (0.0, 0.0, 1.0),
                         (0.0, 1.0, 0.0), 45.0, 1.0)
    params, static = split_scene(scene)
    w = h = 64
    spp, depth = 256, 2
    target = jnp.zeros((h, w, 3), jnp.float32)

    loss_plain = jax.jit(make_loss_fn(static, camera, target, w, h, spp,
                                      depth))
    fd = np.mean([_fd(loss_plain, params, "sph_center", 0, hh)
                  for hh in (0.01, 0.02)])

    g_on = jax.grad(make_loss_fn(static, camera, target, w, h, spp,
                                 depth, edge_eps=(0.01, 0.02)))(params)
    gx_on = float(g_on["sph_center"][0, 0])

    # silhouette-only for comparison (occlusion disabled)
    real = eg.edge_factor

    def no_occ(scene_, o, d, hh, eps=eg.DEFAULT_EDGE_EPS, t_min=1e-3,
               occlusion=True, **kw):
        kw.pop("occ_weight", None)
        return real(scene_, o, d, hh, eps, t_min, occlusion=False, **kw)

    try:
        eg.edge_factor = no_occ
        g_off = jax.grad(make_loss_fn(static, camera, target, w, h, spp,
                                      depth, edge_eps=(0.01, 0.02)))(params)
    finally:
        eg.edge_factor = real
    gx_off = float(g_off["sph_center"][0, 0])

    assert abs(gx_on - fd) <= 0.15 * abs(fd), (gx_on, fd)
    assert abs(gx_on - fd) < 0.5 * abs(gx_off - fd), (gx_on, gx_off, fd)


def test_screen_margin_gradient_matches_fd():
    """Screen-space (angular) margins — edge_grad `screen` mode
    (round 5): margins divide by their sweep speed, so the bandwidth is
    uniform in screen space and the mid-range pose bias disappears
    (hardware: teapot cos vs FD 0.61 -> 0.92+, PERF.md round 5). Here:
    on the canonical sphere-coverage probe the screen-mode gradient
    must match correlated FD like the relative mode does. The angular
    eps pairing with an FD step h is h/t (sphere at t ~ 5-7:
    h=0.01 -> eps ~ 0.0015-0.002)."""
    scene, camera = _sphere_scene()
    params, static = split_scene(scene)
    w = h = 64
    spp, depth = 128, 3
    target = jnp.zeros((h, w, 3), jnp.float32)

    loss_plain = make_loss_fn(static, camera, target, w, h, spp, depth)
    loss_scr = make_loss_fn(static, camera, target, w, h, spp, depth,
                            edge_eps=(0.0015, 0.003), edge_screen=True)
    # forward identical: the factor is exactly 1.0
    np.testing.assert_allclose(float(jax.jit(loss_plain)(params)),
                               float(jax.jit(loss_scr)(params)),
                               rtol=1e-6)
    g = jax.grad(loss_scr)(params)
    loss_jit = jax.jit(loss_plain)
    fd_r = np.mean([_fd(loss_jit, params, "sph_radius", 0, hh)
                    for hh in (0.01, 0.02)])
    er = float(g["sph_radius"][0])
    assert abs(er - fd_r) <= 0.12 * abs(fd_r), (er, fd_r)


def _teapot_margin_probe():
    """Teapot + ground scene and two ray sets: primary rays, and rays
    leaving random points on the mesh surface in random directions."""
    from zraytrace_tpu.camera import get_rays
    from zraytrace_tpu.io.obj import read_obj
    from zraytrace_tpu.scenes import assets_dir

    model = read_obj(assets_dir() / "teapot/teapot.obj")
    a0, b0, c0 = (np.asarray(x) for x in model.tri_vertices)
    b = sc.SceneBuilder()
    green = b.add_lambertian_color(sc.COLOR_GREEN)
    b.add_sphere((0.0, -102.33, 7.0), 100.0, green)
    red = b.add_lambertian_color((0.7, 0.15, 0.1))
    b.add_triangles(a0, b0, c0, red)
    scene = b.build()

    n = 128
    rng = np.random.default_rng(7)
    camera = make_camera((0.0, 3.0, -9.0), (0.0, 1.0, 5.0),
                         (0.0, 1.0, 0.0), 50.0, 1.0)
    u = jnp.asarray(rng.random(n) * 0.8 + 0.1, jnp.float32)
    v = jnp.asarray(rng.random(n) * 0.8 + 0.1, jnp.float32)
    primary = get_rays(camera, u, v)
    ti = rng.integers(0, a0.shape[0], n)
    w1 = rng.random((n, 1))
    w2 = rng.random((n, 1)) * (1 - w1)
    o2 = jnp.asarray(a0[ti] * (1 - w1 - w2) + b0[ti] * w1 + c0[ti] * w2,
                     jnp.float32)
    d2 = rng.normal(size=(n, 3))
    d2 = jnp.asarray(d2 / np.linalg.norm(d2, axis=1, keepdims=True),
                     jnp.float32)
    return scene, {"primary": primary, "surface": (o2, d2)}


@pytest.mark.parametrize("rays", ["primary", "surface"])
@pytest.mark.parametrize("screen", [False, True])
def test_margin_selection_matches_dense_scan(monkeypatch, screen, rays):
    """The stop-gradient selection + per-ray recompute (meshes of at
    least SELECT_MIN_TRIANGLES) gives the same margins as
    differentiating the dense scan, in relative and screen mode."""
    import zraytrace_tpu.edge_grad as eg
    from zraytrace_tpu.render import trace_closest

    scene, ray_sets = _teapot_margin_probe()
    o, d = ray_sets[rays]
    h = trace_closest(scene, o, d)
    monkeypatch.setattr(eg, "SELECT_MIN_TRIANGLES", 1)
    sel = eg.silhouette_margin(scene, o, d, h, screen=screen)
    monkeypatch.setattr(eg, "SELECT_MIN_TRIANGLES", 1 << 30)
    dense = eg.silhouette_margin(scene, o, d, h, screen=screen)
    # same formulas; the recompute sums row-wise where the scan
    # multiplies matrices, so values agree to f32 rounding, and where two
    # candidates' margins tie to within that rounding either may be
    # selected (a rare ray, off by the width of the tie)
    for name, a, b_ in zip(("margin", "occ", "near"), sel, dense):
        a, b_ = np.asarray(a), np.asarray(b_)
        close = np.isclose(a, b_, rtol=1e-4, atol=1e-5)
        assert close.mean() >= 0.98, (name, close.mean())
        np.testing.assert_allclose(a, b_, rtol=1e-3, atol=1e-5,
                                   err_msg=name)


@pytest.mark.parametrize("screen", [False, True])
def test_margin_selection_grads_match_dense_scan(monkeypatch, screen):
    """Gradients through the selection path equal those of the dense
    scan: max/min subgradients flow through the selected element only.
    Checked on the mesh's pose (a translation of every vertex), where a
    near-tie between adjacent candidates cannot move the result."""
    import zraytrace_tpu.edge_grad as eg
    from zraytrace_tpu.render import trace_closest

    scene, ray_sets = _teapot_margin_probe()
    o, d = ray_sets["primary"]
    h = jax.lax.stop_gradient(trace_closest(scene, o, d))

    def total(off, select_min):
        monkeypatch.setattr(eg, "SELECT_MIN_TRIANGLES", select_min)
        moved = scene._replace(tri_a=scene.tri_a + off,
                               tri_b=scene.tri_b + off,
                               tri_c=scene.tri_c + off)
        m, occ, near = eg.silhouette_margin(moved, o, d, h, screen=screen)
        return (jnp.sum(jnp.tanh(m)) + jnp.sum(jnp.tanh(occ))
                + jnp.sum(jnp.tanh(near)))

    off = jnp.zeros((3,), jnp.float32)
    g_sel = np.asarray(jax.grad(total)(off, 1))
    g_dense = np.asarray(jax.grad(total)(off, 1 << 30))
    assert np.abs(g_dense).sum() > 0
    np.testing.assert_allclose(g_sel, g_dense, rtol=1e-3,
                               atol=1e-3 * np.abs(g_dense).max())
