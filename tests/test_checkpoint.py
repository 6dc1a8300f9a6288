"""Checkpoint/resume tests (SURVEY.md §5: tile-checkpoint restart)."""

import numpy as np
import pytest

from zraytrace_tpu.checkpoint import (
    RenderCheckpoint,
    load_checkpoint,
    render_checkpointed,
    save_checkpoint,
)
from zraytrace_tpu.config import RenderParams


def _scene():
    from tests.test_render import _mini_scene

    return _mini_scene()


def test_save_load_roundtrip(tmp_path):
    ck = RenderCheckpoint(
        pixel_sum=np.random.default_rng(0).random((16, 3)),
        counters=np.arange(12, dtype=np.uint64).reshape(6, 2),
        samples_done=7, width=4, height=4, seed=42, max_depth=5,
    )
    p = tmp_path / "ck.npz"
    save_checkpoint(p, ck)
    back = load_checkpoint(p)
    np.testing.assert_array_equal(back.pixel_sum, ck.pixel_sum)
    np.testing.assert_array_equal(back.counters, ck.counters)
    assert back.samples_done == 7 and back.seed == 42


def test_resume_bit_identical(tmp_path):
    scene, camera = _scene()
    params = RenderParams(width=8, height=8, samples_per_pixel=6, max_depth=4)

    # Uninterrupted checkpointed render.
    p1 = tmp_path / "full.npz"
    img_full, stats_full = render_checkpointed(scene, camera, params, p1, chunk_spp=2)

    # Interrupted: run only the first chunk (spp=2), then resume to 6.
    p2 = tmp_path / "resume.npz"
    partial = RenderParams(width=8, height=8, samples_per_pixel=2, max_depth=4)
    render_checkpointed(scene, camera, partial, p2, chunk_spp=2)
    assert load_checkpoint(p2).samples_done == 2
    img_res, stats_res = render_checkpointed(scene, camera, params, p2, chunk_spp=2)

    np.testing.assert_array_equal(img_full, img_res)
    assert stats_full.rays == stats_res.rays
    assert stats_res.samples == 8 * 8 * 6


def test_mismatched_config_rejected(tmp_path):
    scene, camera = _scene()
    p = tmp_path / "ck.npz"
    render_checkpointed(
        scene, camera,
        RenderParams(width=8, height=8, samples_per_pixel=2, max_depth=4),
        p, chunk_spp=2,
    )
    import pytest

    with pytest.raises(ValueError):
        render_checkpointed(
            scene, camera,
            RenderParams(width=8, height=8, samples_per_pixel=4, max_depth=3),
            p,
        )


def test_fit_checkpoint_resume_bitexact(tmp_path):
    """Interrupted + resumed optimization == uninterrupted optimization,
    bit for bit (deterministic loss, saved optimizer state)."""
    import jax.numpy as jnp

    from tests.test_render import _mini_scene
    from zraytrace_tpu.inverse import fit, split_scene
    from zraytrace_tpu.render_diff import render_diff

    scene, camera = _mini_scene()
    w = h = 8
    target = np.asarray(
        render_diff(scene, camera, w, h, spp=2, max_depth=2, seed=7))
    # perturb the start so there is something to optimize
    params, static = split_scene(scene)
    from zraytrace_tpu.inverse import merge_scene

    start = merge_scene(
        {**params, "sph_radius": params["sph_radius"] * 1.05}, static)

    kwargs = dict(width=w, height=h, spp=2, max_depth=2, steps=4,
                  learning_rate=1e-2, optimize_fields=("sph_radius",))
    ck = str(tmp_path / "fit.npz")

    # uninterrupted run
    res_full = fit(start, camera, target, **kwargs)
    # interrupted at step 2, then resumed
    fit(start, camera, target, checkpoint_path=ck, checkpoint_every=2,
        **{**kwargs, "steps": 2})
    res_resumed = fit(start, camera, target, checkpoint_path=ck,
                      checkpoint_every=2, **kwargs)

    np.testing.assert_array_equal(
        np.asarray(res_full.scene.sph_radius),
        np.asarray(res_resumed.scene.sph_radius))
    np.testing.assert_array_equal(
        np.asarray(res_full.losses), np.asarray(res_resumed.losses))


def test_fit_checkpoint_rejects_config_change(tmp_path):
    from tests.test_render import _mini_scene
    from zraytrace_tpu.inverse import fit

    scene, camera = _mini_scene()
    w = h = 8
    target = np.zeros((h, w, 3), np.float32)
    ck = str(tmp_path / "fit.npz")
    fit(scene, camera, target, width=w, height=h, spp=2, max_depth=2,
        steps=1, optimize_fields=("sph_radius",), checkpoint_path=ck,
        checkpoint_every=1)
    with pytest.raises(ValueError):
        fit(scene, camera, target, width=w, height=h, spp=2, max_depth=2,
            steps=2, optimize_fields=("sph_radius",), seed=99,
            checkpoint_path=ck, checkpoint_every=1)


def _mixed_scene():
    from zraytrace_tpu import camera as cam
    from zraytrace_tpu.scene import SceneBuilder

    b = SceneBuilder()
    b.add_sphere((0.0, -100.5, -1.0), 100.0,
                 b.add_lambertian_color((0.5, 0.5, 0.5)))
    b.add_sphere((-1.2, 0.0, -1.0), 0.5,
                 b.add_metal_color((0.8, 0.6, 0.2)))
    tri = np.asarray([[[1.0, -0.4, -1.0]], [[1.6, -0.4, -1.0]],
                      [[1.3, 0.5, -1.0]]], np.float32)
    b.add_triangles(tri[0], tri[1], tri[2],
                    b.add_metal_color((0.9, 0.9, 0.9)))
    camera = cam.make_camera((0, 0.5, 2.0), (0.3, 0, -1), (0, 1, 0),
                             60.0, 1.0)
    return b.build(), camera


@pytest.mark.parametrize("scene_kind", ["spheres", "mesh"])
def test_checkpointed_resume_bitexact_scene(tmp_path, scene_kind):
    """Stop after one chunk and resume: the image is bit-identical to an
    uninterrupted checkpointed run, and the counters equal an unchunked
    render() (streams keyed by absolute sample index)."""
    from zraytrace_tpu.render import render
    from zraytrace_tpu.scenes import three_balls

    if scene_kind == "spheres":
        built = three_balls()
        scene, camera = built.scene, built.camera
    else:
        scene, camera = _mixed_scene()
    params = RenderParams(width=16, height=12, samples_per_pixel=6,
                          max_depth=3)
    p1, p2 = tmp_path / "a.npz", tmp_path / "b.npz"
    img_full, st_full = render_checkpointed(scene, camera, params, p1,
                                            chunk_spp=2)
    partial = RenderParams(width=16, height=12, samples_per_pixel=2,
                           max_depth=3)
    render_checkpointed(scene, camera, partial, p2, chunk_spp=2)
    assert load_checkpoint(p2).samples_done == 2
    img_res, st_res = render_checkpointed(scene, camera, params, p2,
                                          chunk_spp=2)
    np.testing.assert_array_equal(img_full, img_res)
    assert st_full.rays == st_res.rays

    img_r, st_r = render(scene, camera, params)
    assert st_r.rays == st_full.rays
    assert st_r.samples == st_full.samples
    np.testing.assert_allclose(img_r, img_full, rtol=1e-5, atol=1e-6)


def test_sharded_checkpointed_resume_bitexact(tmp_path):
    """Distributed checkpoint/restart (SURVEY §5): chunked
    render_sharded over a ('data','sample') mesh resumes bit-identically
    and matches the unchunked sharded render's counters (streams keyed
    by absolute sample index)."""
    import jax

    from zraytrace_tpu.checkpoint import render_sharded_checkpointed
    from zraytrace_tpu.parallel.mesh import make_mesh, render_sharded
    from zraytrace_tpu.scenes import three_balls

    built = three_balls()
    mesh = make_mesh(n_data=2, n_sample=2, devices=jax.devices()[:4])
    params = RenderParams(width=16, height=16, samples_per_pixel=8,
                          max_depth=3)
    p1, p2 = tmp_path / "a.npz", tmp_path / "b.npz"
    img_full, st_full = render_sharded_checkpointed(
        built.scene, built.camera, params, mesh, p1, chunk_spp=4)

    partial = RenderParams(width=16, height=16, samples_per_pixel=4,
                           max_depth=3)
    render_sharded_checkpointed(built.scene, built.camera, partial,
                                mesh, p2, chunk_spp=4)
    img_res, st_res = render_sharded_checkpointed(
        built.scene, built.camera, params, mesh, p2, chunk_spp=4)
    np.testing.assert_array_equal(img_full, img_res)
    assert st_full.rays == st_res.rays

    img_u, st_u = render_sharded(built.scene, built.camera, params, mesh)
    assert st_u.rays == st_full.rays
    assert st_u.samples == st_full.samples
    np.testing.assert_allclose(img_u, img_full, rtol=2e-5, atol=2e-6)

    # wrong mesh shape must be refused
    import pytest

    mesh2 = make_mesh(n_data=4, n_sample=1, devices=jax.devices()[:4])
    with pytest.raises(ValueError, match="different scene"):
        render_sharded_checkpointed(built.scene, built.camera, params,
                                    mesh2, p2, chunk_spp=4)


def test_checkpoint_rejects_engine_switch(tmp_path):
    """The fingerprint covers the RESOLVED triangle engine: a checkpoint
    written with the BVH traversal must refuse to resume on the brute
    scan (their borderline-comparison events can differ — blending them
    would corrupt the accumulation silently)."""
    scene, camera = _mixed_scene()
    p = tmp_path / "ck.npz"
    render_checkpointed(
        scene, camera,
        RenderParams(width=16, height=16, samples_per_pixel=2,
                     max_depth=3, bvh_min_triangles=0), p, chunk_spp=2)
    with pytest.raises(ValueError, match="different scene"):
        render_checkpointed(
            scene, camera,
            RenderParams(width=16, height=16, samples_per_pixel=4,
                         max_depth=3, bvh=False), p, chunk_spp=2)
