#!/usr/bin/env python
"""Mesh-scale inverse rendering: recover a teapot's POSE (translation)
from a target image by gradient descent through the renderer.

The mesh path uses the winner-recompute split (diff_trace.py): a
brute-force scan finds winning triangles under stop-gradient, a per-ray
differentiable Möller-Trumbore recompute carries gradients into the
(traced) vertex positions, and edge-aware factors supply the
silhouette/occlusion coverage terms. The 6,320-triangle teapot is the
reference's own mesh workload (scenes.zig:206-232).

    python examples/mesh_fit.py [--steps 120] [--cpu]
"""

import argparse
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def parse_args(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=120)
    ap.add_argument("--size", type=int, default=64)
    ap.add_argument("--spp", type=int, default=8)
    ap.add_argument("--depth", type=int, default=4)
    ap.add_argument("--cpu", action="store_true")
    ap.add_argument("--tris", type=int, default=0,
                    help="optional triangle-count cap (0 = full teapot)")
    ap.add_argument("--goat", action="store_true",
                    help="goat-class scene: 5x5 teapot grid, 158k "
                         "triangles (the winner pass and the "
                         "silhouette-margin selection run the dense "
                         "O(rays x triangles) scan)")
    ap.add_argument("--init", type=float, default=0.5,
                    help="scale of the initial pose offset; far inits "
                         "(>~1) leave the silhouette attraction basin "
                         "and want a coarse-to-fine eps schedule")
    ap.add_argument("--lr", type=float, default=2e-2)
    ap.add_argument("--screen", action="store_true",
                    help="screen-space (angular) silhouette margins "
                         "(edge_grad screen mode, round 5): one uniform"
                         " angular band — converges from far AND "
                         "mid-range inits without --coarse; use with "
                         "--eps ~5e-4")
    ap.add_argument("--eps", type=float, default=0.015,
                    help="edge bandwidth (the pair (eps, 2*eps) is "
                         "used); wider reaches further from the "
                         "silhouette but biases more")
    ap.add_argument("--occlusion", choices=("off", "camera", "all"),
                    default="camera",
                    help="t-crossing occlusion term: off, camera "
                         "segments only (round-4 default), or every "
                         "bounce (swamps the pose signal at mesh "
                         "scale; round 3)")
    ap.add_argument("--coarse", type=float, default=1.0,
                    help="coarse-to-fine bandwidth schedule: start at "
                         "coarse*eps and decay geometrically to eps "
                         "over the first 60%% of steps (1.0 = off). "
                         "Far inits (--init >= 1) need it: the tight "
                         "band's silhouette gradient turns unreliable "
                         "mid-range; eps is traced, so the schedule costs no "
                         "recompiles")
    return ap.parse_args(argv)


def run(args, log=print):
    """Run the pose fit; returns ``(losses, final pose error, initial
    pose error)``. ``losses`` holds one value per step."""
    if args.cpu:
        from zraytrace_tpu.runtime import force_cpu

        force_cpu()
    else:
        from zraytrace_tpu.runtime import enable_compilation_cache

        enable_compilation_cache()

    import jax
    import jax.numpy as jnp
    import numpy as np
    import optax

    from zraytrace_tpu import scene as sc
    from zraytrace_tpu.camera import make_camera
    from zraytrace_tpu.io.obj import read_obj
    from zraytrace_tpu.render_diff import render_diff
    from zraytrace_tpu.scenes import assets_dir
    from zraytrace_tpu.scene import SceneBuilder

    model = read_obj(assets_dir() / "teapot/teapot.obj")
    a0, b0, c0 = (jnp.asarray(x) for x in model.tri_vertices)
    if args.tris:
        a0, b0, c0 = a0[:args.tris], b0[:args.tris], c0[:args.tris]

    bld = SceneBuilder()
    green = bld.add_lambertian_color(sc.COLOR_GREEN)
    bld.add_sphere((0.0, -102.33, 7.0), 100.0, green)
    red = bld.add_lambertian_color((0.7, 0.15, 0.1))
    if args.goat:
        # the goat-class stand-in: 25 teapots
        a_np, b_np, c_np = (np.asarray(x) for x in (a0, b0, c0))
        pa, pb, pc = [], [], []
        for gx in range(5):
            for gz in range(5):
                off_g = np.asarray(
                    [(gx - 2) * 8.0, 0.0, (gz - 2) * 8.0], np.float32)
                pa.append(a_np + off_g)
                pb.append(b_np + off_g)
                pc.append(c_np + off_g)
        bld.add_triangles(np.concatenate(pa), np.concatenate(pb),
                          np.concatenate(pc), red)
        base = bld.build()
        camera = make_camera((0.0, 8.0, -30.0), (0.0, 0.0, 1.0),
                             (0.0, 1.0, 0.0), 55.0, 1.0)
    else:
        bld.add_triangles(np.asarray(a0), np.asarray(b0),
                          np.asarray(c0), red)
        base = bld.build()
        camera = make_camera((0.0, 3.0, -9.0), (0.0, 1.0, 5.0),
                             (0.0, 1.0, 0.0), 50.0, 1.0)

    def scene_at(off):
        return base._replace(tri_a=base.tri_a + off,
                             tri_b=base.tri_b + off,
                             tri_c=base.tri_c + off)

    def image_at(off, eps):
        scene = scene_at(off)
        # occlusion term default: CAMERA SEGMENTS only (round 4) — a
        # 6k-triangle mesh has thousands of internal t-crossings on
        # bounce rays whose tight-bandwidth terms are zero-mean but
        # high-variance; at every bounce they swamp the pose signal
        # (round 3, FD-checked: axis gradients 12x-off/wrong-sign).
        occ = {"off": False, "camera": "camera", "all": True}[
            args.occlusion]
        return render_diff(scene, camera, args.size, args.size,
                           args.spp, args.depth, mesh_fast=True,
                           edge_eps=(eps, 2 * eps),
                           edge_screen=args.screen or None,
                           edge_occlusion=occ)

    true_off = jnp.asarray([0.0, 0.0, 0.0], jnp.float32)
    target = jax.lax.stop_gradient(
        image_at(true_off, jnp.float32(args.eps)))

    def loss_fn(off, eps):
        return jnp.mean((image_at(off, eps) - target) ** 2)

    def eps_at(i):
        # geometric decay coarse*eps -> eps over the first 60% of steps
        frac = min(1.0, i / max(1, int(0.6 * args.steps)))
        return jnp.float32(args.eps * args.coarse ** (1.0 - frac))

    opt = optax.adam(args.lr)
    init_off = jnp.asarray([0.5, -0.35, 0.45], jnp.float32) * args.init
    off = init_off
    state = opt.init(off)

    @jax.jit
    def step(off, state, eps):
        val, g = jax.value_and_grad(loss_fn)(off, eps)
        upd, state = opt.update(g, state)
        return optax.apply_updates(off, upd), state, val

    t0 = time.time()
    off1, state1, val = step(off, state, eps_at(0))
    losses = [float(val)]
    log(f"compile+step0: {time.time() - t0:.1f}s "
        f"(tris={base.n_triangles})")

    t0 = time.time()
    off, state = off1, state1
    for i in range(1, args.steps):
        off, state, val = step(off, state, eps_at(i))
        losses.append(float(val))
        if i % 10 == 0 or i == args.steps - 1:
            err = float(jnp.linalg.norm(off - true_off))
            log(f"step {i:3d} loss {losses[-1]:.3e} |pose error| {err:.4f}")
    err = float(jnp.linalg.norm(off - true_off))
    dt = time.time() - t0
    log(f"{args.steps - 1} steps in {dt:.1f}s "
        f"({dt / max(args.steps - 1, 1):.2f}s/step); "
        f"pose error {float(jnp.linalg.norm(init_off)):.3f} -> {err:.4f}")
    return losses, err, float(jnp.linalg.norm(init_off))


def main(argv=None):
    _, err, _ = run(parse_args(argv), log=lambda s: print(s, flush=True))
    if err > 0.08:
        print("WARNING: pose did not converge", file=sys.stderr)
        return 1
    print("converged")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
