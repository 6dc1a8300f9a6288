#!/usr/bin/env python
"""Inverse rendering demo: recover perturbed scene parameters from a
target image by gradient descent (BASELINE.json config #5 — a capability
the forward-only reference has no analogue for).

Recovers, in one optimization: a sphere's center and radius, and a
material albedo. Run on the GPU, or on the CPU with --cpu:

    python examples/inverse_rendering.py [--steps 150] [--cpu]
"""

import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=150)
    ap.add_argument("--size", type=int, default=24)
    ap.add_argument("--spp", type=int, default=8)
    ap.add_argument("--cpu", action="store_true")
    ap.add_argument("--out", default=None, help="write before/after PNGs")
    ap.add_argument("--fd", action="store_true",
                    help="use correlated finite differences for coverage "
                         "gradients instead of edge-aware analytic ones")
    args = ap.parse_args()

    if args.cpu:
        from zraytrace_tpu.runtime import force_cpu

        force_cpu()

    import jax.numpy as jnp
    import numpy as np

    from zraytrace_tpu import scene as sc
    from zraytrace_tpu.camera import make_camera
    from zraytrace_tpu.inverse import fit, merge_scene, split_scene
    from zraytrace_tpu.render_diff import render_diff
    from zraytrace_tpu.scene import SceneBuilder

    # Ground-truth scene: matte ball + ground.
    b = SceneBuilder()
    red = b.add_lambertian_color((0.8, 0.2, 0.1))
    green = b.add_lambertian_color(sc.COLOR_GREEN)
    b.add_sphere((0.0, 0.0, 3.0), 1.2, red)
    b.add_sphere((1.0, -52.0, 4.0), 50.0, green)
    camera = make_camera((0, 0, -5.0), (0, 0, 1.0), (0, 1.0, 0), 45.0, 1.0)
    truth = b.build()

    w = h = args.size
    target = np.asarray(render_diff(truth, camera, w, h, args.spp, 4, seed=5))

    # Perturb: move/shrink the ball, wrong albedo.
    params, static = split_scene(truth)
    centers = np.asarray(params["sph_center"]).copy()
    radii = np.asarray(params["sph_radius"]).copy()
    colors = np.asarray(params["tex_color"]).copy()
    centers[0] += (0.3, -0.25, 0.2)
    radii[0] *= 0.75
    colors[0] = (0.3, 0.5, 0.8)
    broken = merge_scene(
        {
            **params,
            "sph_center": jnp.asarray(centers),
            "sph_radius": jnp.asarray(radii),
            "tex_color": jnp.asarray(colors),
        },
        static,
    )

    # Sphere center/radius are coverage-dominated. Default: edge-aware
    # analytic silhouette gradients (edge_grad.py) carry that signal in
    # ONE backward pass; --fd switches to the correlated
    # finite-difference fallback (2 renders per scalar).
    result = fit(
        broken, camera, target, w, h, spp=args.spp, max_depth=4,
        steps=args.steps, learning_rate=8e-3, seed=5,
        optimize_fields=("sph_center", "sph_radius", "tex_color"),
        fd_fields=(("sph_center", "sph_radius") if args.fd else ()),
        edge_eps=(None if args.fd else 0.02),
    )

    losses = np.asarray(result.losses)
    rec_c = np.asarray(result.scene.sph_center)[0]
    rec_r = float(np.asarray(result.scene.sph_radius)[0])
    rec_col = np.asarray(result.scene.tex_color)[0]
    print(f"loss: {losses[0]:.5f} -> {losses[-1]:.5f}")
    print(f"center:  true (0.00, 0.00, 3.00)  recovered ({rec_c[0]:+.3f}, {rec_c[1]:+.3f}, {rec_c[2]:+.3f})")
    print(f"radius:  true 1.200               recovered {rec_r:.3f}")
    print(f"albedo:  true (0.80, 0.20, 0.10)  recovered ({rec_col[0]:.3f}, {rec_col[1]:.3f}, {rec_col[2]:.3f})")

    if args.out:
        from zraytrace_tpu.io.png import write_png

        write_png(args.out + ".target.png", target)
        write_png(args.out + ".broken.png",
                  np.asarray(render_diff(broken, camera, w, h, args.spp, 4, seed=5)))
        write_png(args.out + ".recovered.png",
                  np.asarray(render_diff(result.scene, camera, w, h, args.spp, 4, seed=5)))

    ok = losses[-1] < losses[0] * 0.25
    print("RECOVERY", "OK" if ok else "INCOMPLETE")
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
