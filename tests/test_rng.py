"""RNG property tests.

The reference pins golden values of Zig's xoroshiro stream
(sample.zig:70-118); per SURVEY.md §4 we assert distribution properties
instead: determinism, decorrelation, uniformity, unit length, full-sphere
coverage."""

import numpy as np
import jax.numpy as jnp

from zraytrace_tpu import rng as zrng


def _u(seed=1, n=20000, stream=zrng.STREAM_GENERIC):
    pix = jnp.arange(n, dtype=jnp.uint32)
    return np.asarray(zrng.uniform4(seed, pix, 0, 0, stream))


def test_deterministic():
    a = _u()
    b = _u()
    np.testing.assert_array_equal(a, b)


def test_range_and_mean():
    u = _u()
    assert u.min() >= 0.0 and u.max() < 1.0
    np.testing.assert_allclose(u.mean(), 0.5, atol=0.01)
    np.testing.assert_allclose(u.var(), 1.0 / 12.0, atol=0.005)


def test_streams_decorrelated():
    a = _u(stream=zrng.STREAM_CAMERA)[:, 0]
    b = _u(stream=zrng.STREAM_SCATTER)[:, 0]
    assert abs(np.corrcoef(a, b)[0, 1]) < 0.02


def test_seed_changes_stream():
    a = _u(seed=1)
    b = _u(seed=2)
    assert not np.array_equal(a, b)


def test_counter_axes_change_stream():
    pix = jnp.arange(128, dtype=jnp.uint32)
    base = np.asarray(zrng.uniform4(1, pix, 0, 0))
    by_sample = np.asarray(zrng.uniform4(1, pix, 1, 0))
    by_bounce = np.asarray(zrng.uniform4(1, pix, 0, 1))
    assert not np.array_equal(base, by_sample)
    assert not np.array_equal(base, by_bounce)
    assert not np.array_equal(by_sample, by_bounce)


def test_random_unit_vector_properties():
    u = _u(n=50000)
    v = np.asarray(zrng.random_unit_vector(jnp.asarray(u[:, 0]), jnp.asarray(u[:, 1])))
    lengths = np.linalg.norm(v, axis=-1)
    np.testing.assert_allclose(lengths, 1.0, atol=1e-5)
    # Uniform on the sphere: each component has mean 0, var 1/3.
    np.testing.assert_allclose(v.mean(axis=0), 0.0, atol=0.02)
    np.testing.assert_allclose(v.var(axis=0), 1.0 / 3.0, atol=0.01)
    # Both hemispheres covered (the reference's sign-flip, sample.zig:55-62).
    assert (v[:, 2] > 0).mean() > 0.45 and (v[:, 2] > 0).mean() < 0.55


def test_random_in_unit_sphere_properties():
    u = _u(n=50000)
    p = np.asarray(
        zrng.random_in_unit_sphere(
            jnp.asarray(u[:, 0]), jnp.asarray(u[:, 1]), jnp.asarray(u[:, 2])
        )
    )
    r = np.linalg.norm(p, axis=-1)
    assert r.max() <= 1.0
    # Uniform in the ball: E[r] = 3/4.
    np.testing.assert_allclose(r.mean(), 0.75, atol=0.01)
