#!/usr/bin/env python
"""Headline benchmark: rays/s on one GPU through ``render()``.

Reference baseline (BASELINE.md): the Zig tracer renders threeBalls at
1000x1000, 1000 spp, depth 30 in 617.41 s — 2,144,645,362 rays =>
~3.47 M rays/s on one CPU thread (README.md:58,61). ``vs_baseline`` is the
speedup over that ray rate.

Prints ONE JSON line: {"metric", "value", "unit", "vs_baseline", "passes",
"spread_pct", "device": {"platform", "kind", "count"}}. Requires a GPU.

Env knobs: ZRAYTRACE_BENCH_SPP / _SIZE / _DEPTH (defaults 1000/1000/30),
ZRAYTRACE_BENCH_SCENE (default 1 = threeBalls; 3 = teapot runs the
reference's mesh benchmark config 700x700x500@20, scenes.zig:130-166),
ZRAYTRACE_BENCH_REPEATS (default 3 timed passes; the median is reported).
"""

import json
import os
import sys
import time

REF_RAYS_PER_SEC = 2_144_645_362 / 617.41  # ~3.474e6 (README.md:58,61)
# Teapot mesh scene: 425,784,511 rays / 36,069 s (scenes.zig:161-164)
REF_TEAPOT_RAYS_PER_SEC = 425_784_511 / 36_069.0


def main() -> int:
    scene_idx = int(os.environ.get("ZRAYTRACE_BENCH_SCENE", "1"))
    if scene_idx == 3:
        size_d, spp_d, depth_d = "700", "500", "20"
    else:
        size_d, spp_d, depth_d = "1000", "1000", "30"
    size = int(os.environ.get("ZRAYTRACE_BENCH_SIZE", size_d))
    spp = int(os.environ.get("ZRAYTRACE_BENCH_SPP", spp_d))
    depth = int(os.environ.get("ZRAYTRACE_BENCH_DEPTH", depth_d))
    repeats = max(1, int(os.environ.get("ZRAYTRACE_BENCH_REPEATS", "3")))

    from zraytrace_tpu.runtime import enable_compilation_cache, require_gpu

    require_gpu("bench.py")
    enable_compilation_cache()

    import jax
    import numpy as np

    from zraytrace_tpu.config import RenderParams
    from zraytrace_tpu.render import render
    from zraytrace_tpu.scenes import build_scene

    built = build_scene(scene_idx)
    params = RenderParams(width=size, height=size, samples_per_pixel=spp,
                          max_depth=depth)
    # spp is a traced argument: a 1-spp render compiles the same program
    t0 = time.perf_counter()
    render(built.scene, built.camera,
           RenderParams(width=size, height=size, samples_per_pixel=1,
                        max_depth=depth))
    compile_s = time.perf_counter() - t0

    rates = []
    for rep in range(repeats):
        _, stats = render(built.scene, built.camera, params)
        rates.append(stats.rays_per_second)
        print(f"# pass {rep}: {stats.render_seconds:.3f}s "
              f"{rates[-1] / 1e6:.1f}M rays/s", file=sys.stderr)
    rays_per_sec = float(np.median(rates))
    spread_pct = 100.0 * (max(rates) - min(rates)) / rays_per_sec
    dev = jax.devices()[0]
    print(
        f"# size={size} spp={spp} depth={depth} rays={stats.rays} "
        f"iters={stats.wavefront_iterations} "
        f"compile+warm={compile_s:.1f}s passes={repeats}",
        file=sys.stderr,
    )
    if scene_idx == 3:
        metric = "rays_per_second_teapot_700x700"
        baseline = REF_TEAPOT_RAYS_PER_SEC
    else:
        metric = "rays_per_second_7spheres_1000x1000"
        baseline = REF_RAYS_PER_SEC
    print(json.dumps({
        "metric": metric,
        "value": rays_per_sec,
        "unit": "rays/s",
        "vs_baseline": rays_per_sec / baseline,
        "passes": repeats,
        "spread_pct": round(spread_pct, 2),
        "device": {"platform": dev.platform, "kind": dev.device_kind,
                   "count": len(jax.devices())},
    }))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
