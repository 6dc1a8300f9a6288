"""Batched 3D vector math over ``(..., 3)`` arrays.

Batched replacement for the reference's scalar ``Vec3`` struct
(vector.zig:22-162): every op is elementwise/batched jnp so XLA fuses the
whole shading chain. No classes — rays are SoA arrays.
"""

from __future__ import annotations

import jax.numpy as jnp


def dot(a: jnp.ndarray, b: jnp.ndarray) -> jnp.ndarray:
    """Batched dot product (vector.zig:65). Returns shape ``(...,)``."""
    return jnp.sum(a * b, axis=-1)


def cross(a: jnp.ndarray, b: jnp.ndarray) -> jnp.ndarray:
    """Batched cross product (vector.zig:70)."""
    return jnp.cross(a, b)


def length_squared(v: jnp.ndarray) -> jnp.ndarray:
    return jnp.sum(v * v, axis=-1)


def length(v: jnp.ndarray) -> jnp.ndarray:
    return jnp.sqrt(length_squared(v))


def normalize(v: jnp.ndarray) -> jnp.ndarray:
    """Unit vector (vector.zig:88). Zero input yields NaNs, like the
    reference's divide-by-zero-length behaviour."""
    return v / length(v)[..., None]


def normalize_safe(v: jnp.ndarray, eps: float = 1e-20) -> jnp.ndarray:
    """Unit vector that returns 0 for (near-)zero input instead of NaN.

    Used where the reference would propagate NaNs from degenerate
    scatter directions; also keeps reverse-mode gradients finite.
    """
    n2 = length_squared(v)
    ok = n2 > eps
    # double-where: keep d(rsqrt)/dx finite on the masked lanes so the
    # backward pass stays NaN-free.
    inv = jnp.where(ok, jax_rsqrt(jnp.where(ok, n2, 1.0)), 0.0)
    return v * inv[..., None]


def jax_rsqrt(x: jnp.ndarray) -> jnp.ndarray:
    import jax.lax as lax

    return lax.rsqrt(x)


def reflect(v: jnp.ndarray, n: jnp.ndarray) -> jnp.ndarray:
    """Mirror reflection (vector.zig:129): ``v - 2 (v.n) n``."""
    return v - 2.0 * dot(v, n)[..., None] * n


def refract(v: jnp.ndarray, n: jnp.ndarray, ratio: jnp.ndarray) -> jnp.ndarray:
    """Snell refraction (vector.zig:134-139).

    ``v`` must be unit length; ``ratio`` = n1/n2, broadcastable to ``(...,)``.
    Matches the reference exactly, including the ``abs`` guard under the
    square root.
    """
    ratio = jnp.asarray(ratio)[..., None]
    cos_theta = jnp.minimum(dot(-v, n), 1.0)[..., None]
    r_out_perp = ratio * (v + cos_theta * n)
    # |1 - |perp|^2| rounds to exactly 0 for grazing rays in f32; the
    # double-where keeps d(sqrt)/dx finite there so unselected dielectric
    # branches cannot NaN-poison reverse-mode gradients.
    k = jnp.abs(1.0 - length_squared(r_out_perp))
    pos = k > 0.0
    root = jnp.where(pos, jnp.sqrt(jnp.where(pos, k, 1.0)), 0.0)
    r_out_parallel = -root[..., None] * n
    return r_out_perp + r_out_parallel


def ray_at(origin: jnp.ndarray, direction: jnp.ndarray, t: jnp.ndarray) -> jnp.ndarray:
    """P(t) = O + t D (ray.zig:14)."""
    return origin + t[..., None] * direction
