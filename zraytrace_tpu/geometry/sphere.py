"""Batched ray-sphere intersection.

Reference semantics: sphere.zig:31-69 — half-b quadratic, near root
preferred, far root only if the near one is out of range (ray origin inside
the sphere), spherical UV from acos/atan2, and signed radius giving inward
normals for the hollow-glass trick (sphere.zig:45, scenes.zig:96).

Design notes:
- the quadratic coefficients for ALL rays x ALL spheres are assembled from
  two ``(N,3) @ (3,S)`` matmuls — no ``(N,S,3)`` intermediate:
      half_b[n,s] = (o.d)[n] - (d @ centers^T)[n,s]
      c[n,s]     = |o|^2[n] - 2 (o @ centers^T)[n,s] + (|center|^2 - r^2)[s]
- NO gathers on the hot path: the winning sphere's attributes are fetched
  with a one-hot ``(N,S) @ (S,K)`` matmul or a where-chain, which fuse
  with the surrounding elementwise math.
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np

from zraytrace_tpu import vecmath as vm

_BIG = np.float32(3.4e38)  # sentinel "no hit" t, well below f32 inf (numpy: import-safe)

# Above this sphere count a one-hot matmul stops being cheaper than a
# gather; every reference scene has <= 7 spheres.
ONEHOT_MAX = 1024


def intersect_spheres(o, d, centers, radii, t_min, t_max):
    """Closest valid sphere hit per ray.

    Args:
      o, d: ray origins/unit directions ``(N, 3)``.
      centers: ``(S, 3)``; radii: ``(S,)`` signed.
      t_min, t_max: scalars or ``(N,)``.

    Returns:
      t: ``(N,)`` hit distance (_BIG where no hit)
      idx: ``(N,)`` int32 index of the hit sphere (0 where no hit)
      hit: ``(N,)`` bool
    First sphere in the table wins exact ties, matching the reference's
    strict-``<`` list scan (raytrace.zig:75-81).
    """
    ct = centers.T  # (3, S)
    d_dot_c = d @ ct  # (N, S)
    o_dot_c = o @ ct  # (N, S)
    o_dot_d = vm.dot(o, d)[:, None]  # (N, 1)
    o_sq = vm.length_squared(o)[:, None]  # (N, 1)
    c_sq = vm.length_squared(centers) - radii * radii  # (S,)

    half_b = o_dot_d - d_dot_c  # oc.d with oc = o - center
    c = o_sq - 2.0 * o_dot_c + c_sq[None, :]
    disc = half_b * half_b - c
    # Double-where sqrt guard: non-hit lanes must not emit d(sqrt(0))=inf
    # into the backward pass (their zero cotangent times inf is NaN).
    pos = disc > 0.0
    root = jnp.where(pos, jnp.sqrt(jnp.where(pos, disc, 1.0)), 0.0)

    t_min = jnp.asarray(t_min)[..., None] if jnp.ndim(t_min) else t_min
    t_max = jnp.asarray(t_max)[..., None] if jnp.ndim(t_max) else t_max

    t1 = -half_b - root
    t2 = -half_b + root
    ok1 = (t1 > t_min) & (t1 < t_max)
    ok2 = (t2 > t_min) & (t2 < t_max)
    t = jnp.where(ok1, t1, t2)
    valid = (disc >= 0.0) & (ok1 | ok2)

    t = jnp.where(valid, t, _BIG)
    idx = jnp.argmin(t, axis=-1).astype(jnp.int32)  # first index wins ties
    t_best = jnp.min(t, axis=-1)  # reduce, not gather
    return t_best, idx, t_best < _BIG


def intersect_spheres_fused(o, d, centers, radii, mat_ids, t_min, t_max):
    """Closest sphere hit with attributes, as ONE fused elementwise chain.

    Unrolls the sphere loop (python-level, S is static and small) carrying
    the running winner — for the reference's scene sizes (<= 7 spheres):
    no (N,S) matrices, no argmin, no one-hot contractions, everything
    fuses into one elementwise chain. Strict ``<`` keeps the
    first sphere on ties, matching the reference scan (raytrace.zig:75-81).

    Returns dict(t, hit, center (N,3), radius (N,), mat_id (N,)).
    """
    n = o.shape[0]
    o_dot_d = vm.dot(o, d)
    o_sq = vm.length_squared(o)
    t_best = jnp.full((n,), _BIG)
    c_sel = jnp.zeros((n, 3), jnp.float32)
    r_sel = jnp.ones((n,), jnp.float32)
    m_sel = jnp.zeros((n,), jnp.int32)
    for s in range(centers.shape[0]):
        c = centers[s]
        r = radii[s]
        # half-b quadratic (sphere.zig:32-40) via the o-decomposition
        half_b = o_dot_d - d @ c
        cc = o_sq - 2.0 * (o @ c) + (c @ c - r * r)
        disc = half_b * half_b - cc
        pos = disc > 0.0
        root = jnp.where(pos, jnp.sqrt(jnp.where(pos, disc, 1.0)), 0.0)
        t1 = -half_b - root
        t2 = -half_b + root
        ok1 = (t1 > t_min) & (t1 < t_max)
        ok2 = (t2 > t_min) & (t2 < t_max)
        t = jnp.where(ok1, t1, t2)
        valid = (disc >= 0.0) & (ok1 | ok2)
        better = valid & (t < t_best)
        t_best = jnp.where(better, t, t_best)
        b3 = better[:, None]
        c_sel = jnp.where(b3, c, c_sel)
        r_sel = jnp.where(better, r, r_sel)
        m_sel = jnp.where(better, mat_ids[s], m_sel)
    return dict(
        t=t_best, hit=t_best < _BIG, center=c_sel, radius=r_sel, mat_id=m_sel
    )


def _safe_radius(radius):
    """Keep 1/radius finite when an optimizer drives a radius through
    zero mid-descent (sign preserved so inward normals stay inward)."""
    return jnp.where(
        jnp.abs(radius) > 1e-8, radius, jnp.where(radius < 0, -1e-8, 1e-8)
    )


def sphere_attributes(o, d, t, center, radius):
    """point/outward-normal/uv from the carried winner attributes
    (no index needed). Same math as sphere_surface."""
    point = vm.ray_at(o, d, t)
    normal = (point - center) / _safe_radius(radius)[:, None]
    ny = jnp.clip(normal[:, 1], -1.0 + 1e-7, 1.0 - 1e-7)
    theta = jnp.arccos(-ny)
    # atan2's gradient is NaN at exactly (0, 0) (sphere poles); nudge the
    # x argument there — forward shift is below one texel.
    nx = normal[:, 0]
    nz = normal[:, 2]
    pole = (jnp.abs(nx) + jnp.abs(nz)) < 1e-12
    nx = jnp.where(pole, 1e-12, nx)
    phi = jnp.arctan2(-nz, -nx) + jnp.pi
    uv = jnp.stack([phi / (2.0 * jnp.pi), theta / jnp.pi], axis=-1)
    return point, normal, uv


def onehot_rows(idx, table, unroll_max: int = 16):
    """Gather-free ``table[idx]``.

    Small tables (the common case: materials, textures, reference scenes)
    unroll into a where-select chain that fuses with the surrounding
    elementwise math; larger ones use a one-hot ``(N,S) @ (S,K)``
    contraction. Either way: no gather.
    ``table``: (S,) or (S, K); result is f32.
    """
    S = table.shape[0]
    t2 = table.astype(jnp.float32)
    if S <= unroll_max:
        if t2.ndim == 1:
            out = jnp.zeros(idx.shape, jnp.float32)
            for s in range(S):
                out = jnp.where(idx == s, t2[s], out)
            return out
        out = jnp.zeros(idx.shape + (t2.shape[1],), jnp.float32)
        for s in range(S):
            out = jnp.where((idx == s)[..., None], t2[s], out)
        return out
    oh = (idx[:, None] == jnp.arange(S, dtype=idx.dtype)[None, :]).astype(
        jnp.float32
    )
    return oh @ t2


def sphere_surface(o, d, t, idx, centers, radii):
    """Hit attributes for the chosen sphere per ray (sphere.zig:43-52).

    Returns ``(point, outward_normal, uv)``; the normal is the *outward*
    normal before the front-face flip (hit_record.zig:28-41), scaled by the
    signed radius so negative radii give inward normals.
    """
    if centers.shape[0] <= ONEHOT_MAX:
        center = onehot_rows(idx, centers)  # (N, 3)
        radius = onehot_rows(idx, radii)  # (N,)
    else:
        center = centers[idx]
        radius = radii[idx]
    point = vm.ray_at(o, d, t)
    normal = (point - center) / _safe_radius(radius)[:, None]
    # Spherical texture coords (sphere.zig:47-51). The clip stays a hair
    # inside [-1, 1]: d(arccos) is infinite at the poles and would NaN
    # reverse-mode gradients; the forward shift is < 1e-3 rad at the exact
    # pole only (sub-texel).
    ny = jnp.clip(normal[:, 1], -1.0 + 1e-7, 1.0 - 1e-7)
    theta = jnp.arccos(-ny)
    # atan2's gradient is NaN at exactly (0, 0) (sphere poles); nudge the
    # x argument there — forward shift is below one texel.
    nx = normal[:, 0]
    nz = normal[:, 2]
    pole = (jnp.abs(nx) + jnp.abs(nz)) < 1e-12
    nx = jnp.where(pole, 1e-12, nx)
    phi = jnp.arctan2(-nz, -nx) + jnp.pi
    uv = jnp.stack([phi / (2.0 * jnp.pi), theta / jnp.pi], axis=-1)
    return point, normal, uv
