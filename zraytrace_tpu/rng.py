"""Stateless, counter-based RNG for Monte Carlo sampling.

The reference threads one shared mutable xoroshiro PRNG through materials
(material.zig:64,101; sample.zig) — sequential by construction. Here every
random number is a pure hash of ``(seed, pixel, sample, bounce)``, so:

- the fast while-loop renderer and the differentiable scan renderer draw
  bitwise-identical sample streams regardless of scheduling,
- no key state is carried through ``lax.while_loop``,
- the hash is ~40 int32 VPU ops, far cheaper than threefry.

Hash is PCG4D (Jarzynski & Olano, "Hash Functions for GPU Rendering",
JCGT 2020) — public-domain construction, well validated for rendering.

Seeded-golden-value tests in the reference (sample.zig:70-118) are tied to
Zig's xoroshiro stream and are deliberately NOT chased; tests assert
distribution properties instead (SURVEY.md §4).
"""

from __future__ import annotations

import jax.numpy as jnp

from zraytrace_tpu import vecmath as vm

_U32 = jnp.uint32

# Stream ids keep independent uses of the per-bounce uniforms decorrelated.
STREAM_CAMERA = 0x9E3779B9  # pixel jitter (raytrace.zig:174-175)
STREAM_SCATTER = 0x85EBCA6B  # material scatter decisions
STREAM_GENERIC = 0xC2B2AE35


def pcg4d(v: jnp.ndarray) -> jnp.ndarray:
    """PCG4D mix of a ``(..., 4)`` uint32 counter -> ``(..., 4)`` uint32."""
    v = v.astype(_U32)
    v = v * _U32(1664525) + _U32(1013904223)
    x, y, z, w = v[..., 0], v[..., 1], v[..., 2], v[..., 3]
    x = x + y * w
    y = y + z * x
    z = z + x * y
    w = w + y * z
    x = x ^ (x >> 16)
    y = y ^ (y >> 16)
    z = z ^ (z >> 16)
    w = w ^ (w >> 16)
    x = x + y * w
    y = y + z * x
    z = z + x * y
    w = w + y * z
    return jnp.stack([x, y, z, w], axis=-1)


def _to_unit_float(bits: jnp.ndarray) -> jnp.ndarray:
    """uint32 -> float32 uniform in [0, 1) using the top 24 bits.

    The intermediate int32 cast is value-preserving (top-24-bit values
    < 2^24).
    """
    return (bits >> 8).astype(jnp.int32).astype(jnp.float32) * jnp.float32(
        1.0 / 16777216.0
    )


def uniform4(seed, pixel, sample, bounce, stream=STREAM_GENERIC) -> jnp.ndarray:
    """Four independent U[0,1) floats per lane, shape ``(..., 4)``.

    All index arguments broadcast; any may be traced int32 arrays.
    """
    pixel = jnp.asarray(pixel, _U32)
    sample = jnp.asarray(sample, _U32)
    bounce = jnp.asarray(bounce, _U32)
    seed_c = jnp.asarray(seed, _U32) ^ _U32(stream)
    shape = jnp.broadcast_shapes(pixel.shape, sample.shape, bounce.shape)
    ctr = jnp.stack(
        [
            jnp.broadcast_to(pixel, shape),
            jnp.broadcast_to(sample, shape),
            jnp.broadcast_to(bounce, shape),
            jnp.broadcast_to(seed_c, shape),
        ],
        axis=-1,
    )
    return _to_unit_float(pcg4d(ctr))


def random_unit_vector(u1: jnp.ndarray, u2: jnp.ndarray) -> jnp.ndarray:
    """Uniform random unit vector from two U[0,1) inputs.

    Distribution-equivalent to the reference's hemisphere-plus-sign-flip
    scheme (sample.zig:47-62): z uniform in [-1,1), azimuth uniform — an
    analytic construction with no rejection loop (a data-dependent loop
    would stall every lane of the wavefront).
    """
    z = u1 * 2.0 - 1.0
    phi = (2.0 * jnp.pi) * u2
    r = jnp.sqrt(jnp.maximum(0.0, 1.0 - z * z))
    return jnp.stack([r * jnp.cos(phi), r * jnp.sin(phi), z], axis=-1)


def random_in_unit_sphere(u1, u2, u3) -> jnp.ndarray:
    """Uniform point inside the unit ball, analytic (no rejection loop).

    Reference analogue: sample.zig:22-32 (rejection sampling).
    radius = cbrt(u3) gives the correct volumetric density.
    """
    d = random_unit_vector(u1, u2)
    r = jnp.cbrt(u3)
    return d * r[..., None]
