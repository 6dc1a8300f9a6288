"""Command line interface.

Positional argument order matches the reference binary for drop-in
comparison (main.zig:16): ``width height samples depth scene_index
filename``. Unlike the reference, non-square images render correctly (the
reference's inner pixel loop iterates to ``height``, raytrace.zig:168).
"""

from __future__ import annotations

import argparse
import os
import sys


def run(argv=None):
    """Parse ``argv``, render, write the image; returns
    ``(image, RenderStats)``."""
    parser = argparse.ArgumentParser(
        prog="zraytrace-tpu",
        description="Differentiable path tracer on the GPU "
        "(usage mirrors the reference: main.zig:16)",
    )
    parser.add_argument("width", type=int)
    parser.add_argument("height", type=int)
    parser.add_argument("samples", type=int)
    parser.add_argument("depth", type=int)
    parser.add_argument("scene_index", type=int)
    parser.add_argument("filename")
    parser.add_argument("--seed", type=int, default=42)
    parser.add_argument("--no-bvh", action="store_true",
                        help="disable the BVH (raytrace.zig:102-108 flag)")
    parser.add_argument("--ppm", action="store_true",
                        help="also write a P3 PPM next to the PNG")
    parser.add_argument("--cpu", action="store_true",
                        help="render on the host CPU (explicit opt-in; "
                        "without it the CLI requires a GPU)")
    args = parser.parse_args(argv)

    from zraytrace_tpu.runtime import (
        enable_compilation_cache, force_cpu, require_gpu,
    )

    if args.cpu:
        force_cpu()
    else:
        require_gpu("zraytrace-tpu")
    enable_compilation_cache()

    from zraytrace_tpu.config import RenderParams
    from zraytrace_tpu.io.png import write_png
    from zraytrace_tpu.io.ppm import write_ppm
    from zraytrace_tpu.render import render
    from zraytrace_tpu.scenes import build_scene

    params = RenderParams(
        width=args.width,
        height=args.height,
        samples_per_pixel=args.samples,
        max_depth=args.depth,
        bvh=not args.no_bvh,
        seed=args.seed,
    )
    from zraytrace_tpu.profiling import PhaseTimer

    timer = PhaseTimer()
    with timer.span("scene build"):
        built = build_scene(args.scene_index)
    print(f"Rendering scene {built.name}", file=sys.stderr)
    print(f" - Surfaces:          {built.scene.n_primitives}", file=sys.stderr)
    print(f" - Pixels:            {params.width}x{params.height}", file=sys.stderr)
    print(f" - Samples per pixel: {params.samples_per_pixel}", file=sys.stderr)
    print(f" - Recursion depth:   {params.max_depth}", file=sys.stderr)

    from zraytrace_tpu.profiling import print_render_report, xla_trace

    with xla_trace(os.environ.get("ZRAYTRACE_TRACE_DIR")):
        with timer.span("render"):
            image, stats = render(built.scene, built.camera, params)
    with timer.span("image write"):
        write_png(args.filename, image)
        if args.ppm:
            write_ppm(str(args.filename) + ".ppm", image)

    print_render_report(stats)
    print("Phase timings:", file=sys.stderr)
    timer.report()
    return image, stats


def main(argv=None) -> int:
    run(argv)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
