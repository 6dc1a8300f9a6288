"""Batched ray-triangle intersection.

Reference semantics: triangle.zig:48-71 — determinant form of
Möller-Trumbore using the *unnormalized* face normal ``fn = e1 x e2``,
barycentric ``(u, v)`` reused directly as texture coordinates
(triangle.zig:66), and one-sided culling via ``det >= 1e-6``
(triangle.zig:62; backfaces never hit).

Design: with the scalar-triple-product identity
``e2 . ((o - a) x d) = (o x d) . e2 - d . (e2 x a)`` every per-(ray,
triangle) quantity factors into ``(N,3) @ (3,T)`` matmuls over per-triangle
precomputed vectors — no ``(N,T,3)`` intermediates:

    det[n,t] = -(d @ fn^T)
    u_num    =  (oxd) @ e2^T - d @ (e2 x a)^T
    v_num    = -((oxd) @ e1^T - d @ (e1 x a)^T)
    t_num    =  o @ fn^T - (a . fn)

Triangles are streamed in chunks through a ``fori_loop`` so memory stays
bounded for large meshes (brute-force path; the BVH traversal replaces it
for big scenes).
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from zraytrace_tpu import vecmath as vm

_BIG = np.float32(3.4e38)  # numpy scalar: no backend init at import
DET_EPS = 1e-6  # one-sidedness threshold (triangle.zig:62)

# Chunk of triangles processed per loop step; bounds the (N, CHUNK)
# intermediates. 512 keeps the six matmul outputs ~128 MB at N=2^16.
TRI_CHUNK = 512


class TrianglePack(NamedTuple):
    """Per-triangle precomputation, derived from vertices at trace time so
    gradients flow back to ``a, b, c`` (the reference precomputes these at
    build time, triangle.zig:32-46)."""

    e1: jnp.ndarray  # (T, 3) b - a
    e2: jnp.ndarray  # (T, 3) c - a
    fn: jnp.ndarray  # (T, 3) e1 x e2 (unnormalized face normal)
    e2xa: jnp.ndarray  # (T, 3)
    e1xa: jnp.ndarray  # (T, 3)
    a_dot_fn: jnp.ndarray  # (T,)


def pack_triangles(a, b, c) -> TrianglePack:
    e1 = b - a
    e2 = c - a
    fn = vm.cross(e1, e2)
    return TrianglePack(
        e1=e1,
        e2=e2,
        fn=fn,
        e2xa=vm.cross(e2, a),
        e1xa=vm.cross(e1, a),
        a_dot_fn=vm.dot(a, fn),
    )


def _intersect_chunk(o, d, oxd, pack: TrianglePack, t_min, t_max):
    """Hit test of all rays against one chunk of triangles.

    Returns per-ray best (t, local_idx, u, v) within the chunk.
    """
    det = -(d @ pack.fn.T)  # (N, C)
    # Guard 1/det for degenerate/parallel pairs: they can never satisfy
    # det >= DET_EPS, but an unguarded inf here would NaN-poison reverse-
    # mode gradients through the (masked-out) t/u/v products.
    safe = jnp.abs(det) > 1e-12
    inv_det = 1.0 / jnp.where(safe, det, 1.0)
    u = (oxd @ pack.e2.T - d @ pack.e2xa.T) * inv_det
    v = -(oxd @ pack.e1.T - d @ pack.e1xa.T) * inv_det
    t = (o @ pack.fn.T - pack.a_dot_fn[None, :]) * inv_det

    is_hit = (
        (det >= DET_EPS)
        & (t > t_min)
        & (t < t_max)
        & (u >= 0.0)
        & (v >= 0.0)
        & (u + v <= 1.0)
    )
    t = jnp.where(is_hit, t, _BIG)
    idx = jnp.argmin(t, axis=-1).astype(jnp.int32)
    t_best = jnp.min(t, axis=-1)
    # Winner u/v via a masked reduction instead of take_along_axis: the
    # masked sums fuse with the intersection math above.
    oh = idx[:, None] == jnp.arange(t.shape[-1], dtype=jnp.int32)[None, :]
    pick = lambda arr: jnp.sum(jnp.where(oh, arr, 0.0), axis=-1)
    return t_best, idx, pick(u), pick(v)


def intersect_triangles(o, d, a, b, c, t_min, t_max, chunk: int = TRI_CHUNK):
    """Closest valid triangle hit per ray (brute force, chunked).

    Args:
      o, d: ``(N, 3)`` ray origins / unit directions.
      a, b, c: ``(T, 3)`` triangle vertices.

    Returns:
      t: ``(N,)`` (_BIG where none), idx ``(N,)`` int32, hit ``(N,)`` bool,
      uv ``(N, 2)`` barycentric texture coords (triangle.zig:66).
    Earlier triangles win exact ties (list-order tie-break,
    raytrace.zig:75-81).
    """
    T = a.shape[0]
    if T == 0:
        n = o.shape[0]
        return (
            jnp.full((n,), _BIG),
            jnp.zeros((n,), jnp.int32),
            jnp.zeros((n,), bool),
            jnp.zeros((n, 2), jnp.float32),
        )

    oxd = vm.cross(o, d)
    t_min = jnp.asarray(t_min)[..., None] if jnp.ndim(t_min) else t_min
    t_max = jnp.asarray(t_max)[..., None] if jnp.ndim(t_max) else t_max

    if T <= chunk:
        pack = pack_triangles(a, b, c)
        t, idx, u, v = _intersect_chunk(o, d, oxd, pack, t_min, t_max)
        return t, idx, t < _BIG, jnp.stack([u, v], axis=-1)

    # Pad to a multiple of chunk with degenerate triangles (fn = 0 =>
    # det = 0 < DET_EPS => never hit), then stream chunks through a loop.
    n_chunks = -(-T // chunk)
    pad = n_chunks * chunk - T
    pad3 = lambda x: jnp.concatenate([x, jnp.zeros((pad, 3), x.dtype)], axis=0)
    pack = pack_triangles(pad3(a), pad3(b), pad3(c))
    pack_r = jax.tree_util.tree_map(
        lambda x: x.reshape((n_chunks, chunk) + x.shape[1:]), pack
    )

    n = o.shape[0]
    init = (
        jnp.full((n,), _BIG),
        jnp.zeros((n,), jnp.int32),
        jnp.zeros((n,), jnp.float32),
        jnp.zeros((n,), jnp.float32),
    )

    def body(i, carry):
        bt, bidx, bu, bv = carry
        chunk_pack = jax.tree_util.tree_map(lambda x: x[i], pack_r)
        ct, cidx, cu, cv = _intersect_chunk(o, d, oxd, chunk_pack, t_min, t_max)
        better = ct < bt  # strict <: earlier chunk wins ties
        return (
            jnp.where(better, ct, bt),
            jnp.where(better, cidx + i * chunk, bidx),
            jnp.where(better, cu, bu),
            jnp.where(better, cv, bv),
        )

    t, idx, u, v = jax.lax.fori_loop(0, n_chunks, body, init)
    return t, idx, t < _BIG, jnp.stack([u, v], axis=-1)


def triangle_surface(o, d, t, idx, a, b, c):
    """Hit attributes for the chosen triangle per ray.

    Returns ``(point, outward_normal)`` where the normal is the unit face
    normal before the front-face flip (triangle.zig:44-46,67-69)."""
    av, bv, cv = a[idx], b[idx], c[idx]
    fn = vm.cross(bv - av, cv - av)
    # normalize_safe: when no triangle was hit, idx defaults to 0 which may
    # be degenerate; a plain normalize would emit NaNs that poison reverse-
    # mode gradients through the (masked) select in trace_closest.
    normal = vm.normalize_safe(fn)
    point = vm.ray_at(o, d, t)
    return point, normal
