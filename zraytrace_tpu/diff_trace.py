"""Mesh-scale differentiable closest-hit (winner-recompute).

``render_diff`` differentiates ``trace_closest``; for meshes the brute
O(N*T) intersection is slow forward and catastrophic backward — the
transpose scatter-adds every (ray, candidate-triangle) product into the
vertex arrays even though all non-winning contributions are zero at
fixed topology (they sit behind ``where`` selects). This module splits
the query the way SURVEY.md §7.7 prescribes for discrete choices:

1. WINNER PASS (stop-gradient): the brute chunked scan finds the
   winning triangle index per ray. All inputs are stop-gradded, so
   reverse mode never touches this subgraph (argmin winners are
   piecewise-constant anyway).
2. RECOMPUTE (differentiable): the winner's vertices are gathered and
   the Möller-Trumbore determinant form (triangle.zig:48-71, identical
   math to geometry/triangle.py) is recomputed per ray on just that
   triangle — O(N) work, and the backward pass scatter-adds into
   exactly one triangle per ray.

At fixed topology the gradients are identical to differentiating the
brute scan (tests/test_diff_mesh.py checks this directly); the forward
values match to f32 rounding (dot-products here vs. the (N,3)@(3,T)
matmul decomposition there).

Sphere handling is unchanged from trace_closest — reference scenes have
<= 7 spheres, so the differentiable full scan is cheap.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from zraytrace_tpu import vecmath as vm
from zraytrace_tpu.config import T_MIN
from zraytrace_tpu.geometry.sphere import (
    intersect_spheres,
    onehot_rows,
    sphere_surface,
)
from zraytrace_tpu.geometry.triangle import DET_EPS, intersect_triangles
from zraytrace_tpu.scene import Scene

_BIG = np.float32(3.4e38)


def _tri_winner_ids(scene, o, d, ts, t_min, t_max):
    """Stop-gradient winner pass: (use_tri (N,) bool, idx (N,) i32).

    ``ts``: per-ray closest sphere t (decides the strict tri-beats-sphere
    merge, render.py trace_closest)."""
    sg = jax.lax.stop_gradient
    tt, idx, _, _ = intersect_triangles(
        sg(o), sg(d), sg(scene.tri_a), sg(scene.tri_b), sg(scene.tri_c),
        t_min, t_max)
    return tt < sg(ts), idx


def _tri_recompute(o, d, av, bv, cv, t_min):
    """Differentiable Möller-Trumbore on one gathered triangle per ray.

    Same determinant form as geometry/triangle.py _intersect_chunk
    (triangle.zig:48-71). Returns (t, u, v, unit_normal); values are
    only meaningful on lanes whose winner pass said the triangle won —
    the 1/det guard keeps inactive lanes NaN-free either way."""
    e1 = bv - av
    e2 = cv - av
    fn = vm.cross(e1, e2)
    det = -vm.dot(d, fn)
    safe = jnp.abs(det) > 1e-12
    inv_det = 1.0 / jnp.where(safe, det, 1.0)
    oxd = vm.cross(o, d)
    u = (vm.dot(oxd, e2) - vm.dot(d, vm.cross(e2, av))) * inv_det
    v = -(vm.dot(oxd, e1) - vm.dot(d, vm.cross(e1, av))) * inv_det
    t = (vm.dot(o, fn) - vm.dot(av, fn)) * inv_det
    return t, u, v, vm.normalize_safe(fn)


def trace_closest_diff(scene: Scene, o, d, t_min=T_MIN, t_max=_BIG):
    """Drop-in for render.trace_closest with mesh-scale gradients.

    Returns the same hit dict; differentiable w.r.t. every scene float
    leaf and (o, d). The discrete winner (which primitive, hit-or-miss)
    is fixed by the stop-gradient pass; continuous attributes
    (t, point, normal, uv) are recomputed differentiably from the
    winner's parameters."""
    n = o.shape[0]
    if scene.n_triangles == 0:
        from zraytrace_tpu.render import trace_closest

        return trace_closest(scene, o, d, t_min, t_max)

    # --- differentiable sphere scan (<= a handful in every scene) ---
    if scene.n_spheres > 0:
        ts, si, _ = intersect_spheres(
            o, d, scene.sph_center, scene.sph_radius, t_min, t_max)
    else:
        ts = jnp.full((n,), _BIG)
        si = jnp.zeros((n,), jnp.int32)

    # --- triangle winner (stop-grad) + differentiable recompute ---
    use_tri, ti = _tri_winner_ids(scene, o, d, ts, t_min, t_max)
    av, bv, cv = scene.tri_a[ti], scene.tri_b[ti], scene.tri_c[ti]
    t_rec, u_rec, v_rec, n_t = _tri_recompute(o, d, av, bv, cv, t_min)
    # Double-where: recomputed t/u/v on non-winner lanes can be wild
    # (behind-origin, parallel); clamp before they enter any select so
    # the backward pass stays NaN-free.
    uv_t = jnp.stack([jnp.where(use_tri, u_rec, 0.0),
                      jnp.where(use_tri, v_rec, 0.0)], axis=-1)

    t = jnp.where(use_tri, jnp.where(use_tri, t_rec, 1.0), ts)
    hit = jax.lax.stop_gradient(t) < _BIG
    t_attr = jnp.where(hit, t, 1.0)

    if scene.n_spheres > 0:
        p_s, n_s, uv_s = sphere_surface(
            o, d, t_attr, si, scene.sph_center, scene.sph_radius)
        mat_s = jnp.round(onehot_rows(si, scene.sph_mat)).astype(jnp.int32)
    else:
        p_s = n_s = jnp.zeros_like(o)
        uv_s = jnp.zeros((n, 2), jnp.float32)
        mat_s = jnp.zeros((n,), jnp.int32)

    p_t = vm.ray_at(o, d, t_attr)
    mat_t = scene.tri_mat[ti]

    use_tri3 = use_tri[:, None]
    point = jnp.where(use_tri3, p_t, p_s)
    outward = jnp.where(use_tri3, n_t, n_s)
    uv = jnp.where(use_tri[:, None], uv_t, uv_s)
    mat_id = jnp.where(use_tri, mat_t, mat_s)

    front_face = vm.dot(d, outward) <= 0.0
    normal = jnp.where(front_face[:, None], outward, -outward)
    return dict(
        hit=hit, t=t, point=point, normal=normal,
        front_face=front_face, uv=uv, mat_id=mat_id,
    )
