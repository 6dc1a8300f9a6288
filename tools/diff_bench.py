#!/usr/bin/env python
"""Differentiable-path benchmark: train-step time + effective ray rate.

Times one jitted Adam value-and-grad step on two workloads, so that
BASELINE config 5 ("recover sphere positions + albedo from target") has
a cost, and writes the report as JSON (default DIFF_BENCH.json):

- ``sphere_albedo_fit``: the full 7-spheres showcase scene
  (scenes.zig:54-100) with gradients into every Scene leaf (centers,
  radii, IORs, texture colors, atlas texels) + camera-facing edge
  terms — the BASELINE config-5 workload.
- ``teapot_pose_fit``: the 6,320-triangle teapot (scenes.zig:206-232)
  through the winner-recompute mesh split (diff_trace.py) with
  silhouette edge terms — the mesh-scale fit of examples/mesh_fit.py.

Ray accounting is exact at the step-0 scene parameters: the RNG is a
stateless hash of (pixel, sample, bounce), so the differentiable scan
path traces bit-identical paths to the wavefront engine (tests compare
their images); ``render()`` at the identical (seed, W, H, spp, depth)
and the optimizer's INITIAL parameters yields step 0's true forward
ray count from the on-device counters. Later steps mutate the scene,
so their forward counts drift slightly — ``eff_rays_per_s`` (= the
step-0 count / mean step wall) is anchored to the initial config.

    python tools/diff_bench.py [--cpu] [--steps 10] [--out DIFF_BENCH.json]

Without ``--cpu`` it requires a GPU.
"""

import argparse
import json
import sys
import time

sys.path.insert(0, ".")

import numpy as np


def _time_steps(step, init_args, n_steps):
    """Jitted-step timing: compile+first step separately, then the mean
    of ``n_steps`` warm steps."""
    import jax

    t0 = time.time()
    state = jax.block_until_ready(step(*init_args))
    compile_s = time.time() - t0
    t0 = time.time()
    for _i in range(n_steps):
        state = step(*state[:-1])
    jax.block_until_ready(state)
    return compile_s, (time.time() - t0) / n_steps


def bench_sphere_albedo(size, spp, depth, steps, seed=42):
    import jax
    import jax.numpy as jnp
    import optax

    from zraytrace_tpu.config import RenderParams
    from zraytrace_tpu.inverse import (image_loss, merge_scene,
                                       split_scene)
    from zraytrace_tpu.render import render
    from zraytrace_tpu.render_diff import render_diff
    from zraytrace_tpu.scenes import build_scene

    built = build_scene(1)  # threeBalls — the 7-spheres showcase
    scene, camera = built.scene, built.camera
    params, static = split_scene(scene)

    # exact forward ray count at this config (identical streams)
    _, stats = render(scene, camera, RenderParams(
        width=size, height=size, samples_per_pixel=spp, max_depth=depth,
        seed=seed))
    rays = stats.rays

    target = jnp.zeros((size, size, 3), jnp.float32)

    def make_step(live_fields):
        """Adam step differentiating exactly ``live_fields`` — frozen
        leaves close over the loss as constants (the fit() policy)."""
        live = {f: params[f] for f in live_fields}
        rest = {**static, **{f: v for f, v in params.items()
                             if f not in live_fields}}

        def loss_fn(p):
            img = render_diff(merge_scene(p, rest), camera, size, size,
                              spp, depth, seed=seed,
                              edge_eps=(0.01, 0.02))
            return image_loss(img, target)

        opt = optax.adam(1e-2)

        @jax.jit
        def step(p, o):
            val, g = jax.value_and_grad(loss_fn)(p)
            upd, o = opt.update(g, o)
            return optax.apply_updates(p, upd), o, val

        return step, (live, opt.init(live))

    # the BASELINE configs[4] workload: recover sphere positions +
    # albedo (centers, radii, texture table colors)
    step, init = make_step(("sph_center", "sph_radius", "tex_color"))
    compile_s, step_s = _time_steps(step, init, steps)
    # the maximal differentiation surface (every leaf incl. the
    # (A,H,W,3) atlas texels) — kept measured beside it
    step_all, init_all = make_step(tuple(params))
    compile_all, step_all_s = _time_steps(step_all, init_all, steps)
    return dict(
        config=dict(scene="threeBalls(1)", width=size, height=size,
                    spp=spp, depth=depth, seed=seed,
                    edge_eps=[0.01, 0.02],
                    grads="sph_center + sph_radius + tex_color (the "
                          "BASELINE configs[4] recovery workload); "
                          "_all_leaves adds IORs, vertices and atlas "
                          "texels"),
        rays_forward=rays,
        step_seconds=round(step_s, 4),
        compile_seconds=round(compile_s, 1),
        eff_rays_per_s=round(rays / step_s),
        pixel_samples_per_s=round(size * size * spp / step_s),
        step_seconds_all_leaves=round(step_all_s, 4),
        eff_rays_per_s_all_leaves=round(rays / step_all_s),
    )


def bench_teapot_pose(size, spp, depth, steps, seed=42):
    import jax
    import jax.numpy as jnp
    import optax

    from zraytrace_tpu import scene as sc
    from zraytrace_tpu.camera import make_camera
    from zraytrace_tpu.config import RenderParams
    from zraytrace_tpu.io.obj import read_obj
    from zraytrace_tpu.render import render
    from zraytrace_tpu.render_diff import render_diff
    from zraytrace_tpu.scene import SceneBuilder
    from zraytrace_tpu.scenes import assets_dir

    model = read_obj(assets_dir() / "teapot/teapot.obj")
    a0, b0, c0 = (np.asarray(x) for x in model.tri_vertices)
    bld = SceneBuilder()
    green = bld.add_lambertian_color(sc.COLOR_GREEN)
    bld.add_sphere((0.0, -102.33, 7.0), 100.0, green)
    red = bld.add_lambertian_color((0.7, 0.15, 0.1))
    bld.add_triangles(a0, b0, c0, red)
    base = bld.build()
    camera = make_camera((0.0, 3.0, -9.0), (0.0, 1.0, 5.0),
                         (0.0, 1.0, 0.0), 50.0, 1.0)

    # forward ray count at the optimizer's INITIAL pose (off0 below),
    # not the target pose — the docstring's step-0 anchoring
    off0_np = np.asarray([0.25, -0.18, 0.22], np.float32)
    scene0 = base._replace(tri_a=base.tri_a + off0_np,
                           tri_b=base.tri_b + off0_np,
                           tri_c=base.tri_c + off0_np)
    _, stats = render(scene0, camera, RenderParams(
        width=size, height=size, samples_per_pixel=spp, max_depth=depth,
        seed=seed))
    rays = stats.rays

    def image_at(off):
        scene = base._replace(tri_a=base.tri_a + off,
                              tri_b=base.tri_b + off,
                              tri_c=base.tri_c + off)
        return render_diff(scene, camera, size, size, spp, depth,
                           seed=seed, mesh_fast=True,
                           edge_eps=(0.015, 0.03),
                           edge_occlusion=False)

    target = jax.lax.stop_gradient(
        image_at(jnp.zeros((3,), jnp.float32)))

    def loss_fn(off):
        return jnp.mean((image_at(off) - target) ** 2)

    opt = optax.adam(2e-2)

    @jax.jit
    def step(off, o):
        val, g = jax.value_and_grad(loss_fn)(off)
        upd, o = opt.update(g, o)
        return optax.apply_updates(off, upd), o, val

    off0 = jnp.asarray(off0_np)
    compile_s, step_s = _time_steps(step, (off0, opt.init(off0)), steps)
    return dict(
        config=dict(scene="teapot+ground", triangles=int(base.n_triangles),
                    width=size, height=size, spp=spp, depth=depth,
                    seed=seed, edge_eps=[0.015, 0.03],
                    grads="pose (translation) via winner-recompute "
                          "mesh split"),
        rays_forward=rays,
        step_seconds=round(step_s, 4),
        compile_seconds=round(compile_s, 1),
        eff_rays_per_s=round(rays / step_s),
        pixel_samples_per_s=round(size * size * spp / step_s),
    )


def compute_report(steps=10, sphere=(128, 8, 10), teapot=(64, 8, 4),
                   verbose=True):
    report = {"workloads": {}}
    for name, fn, (size, spp, depth) in (
            ("sphere_albedo_fit", bench_sphere_albedo, sphere),
            ("teapot_pose_fit", bench_teapot_pose, teapot)):
        entry = fn(size, spp, depth, steps)
        report["workloads"][name] = entry
        if verbose:
            print(f"  {name}: {entry['step_seconds']*1e3:.0f} ms/step, "
                  f"{entry['eff_rays_per_s']/1e6:.2f}M eff rays/s "
                  f"(fwd rays {entry['rays_forward']})", file=sys.stderr,
                  flush=True)
    return report


def write_report(report, path):
    """Stamp the report with the device it ran on and write it."""
    import jax

    dev = jax.devices()[0]
    report["device"] = dict(platform=dev.platform, kind=dev.device_kind,
                            count=len(jax.devices()))
    with open(path, "w") as f:
        json.dump(report, f, indent=1)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--cpu", action="store_true")
    ap.add_argument("--steps", type=int, default=10)
    ap.add_argument("--out", default="DIFF_BENCH.json")
    args = ap.parse_args()
    from zraytrace_tpu.runtime import (
        enable_compilation_cache, force_cpu, require_gpu,
    )

    if args.cpu:
        force_cpu()
    else:
        require_gpu("diff_bench")
    enable_compilation_cache()

    t0 = time.time()
    report = compute_report(steps=args.steps)
    report["wall_seconds"] = round(time.time() - t0, 1)
    write_report(report, args.out)
    w = report["workloads"]
    print(json.dumps({
        "metric": "diff_step_eff_rays_per_s",
        "value": w["sphere_albedo_fit"]["eff_rays_per_s"],
        "unit": "rays/s (fwd+bwd)",
        "teapot_pose_fit": w["teapot_pose_fit"]["eff_rays_per_s"],
    }))


if __name__ == "__main__":
    main()
