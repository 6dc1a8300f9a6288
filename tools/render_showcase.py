#!/usr/bin/env python
"""Render the reference's showcase scenes through ``render()`` and record
their counters.

    python tools/render_showcase.py showcase --scene 1 --spp 1000
    python tools/render_showcase.py showcase --scene 0 --scene 2 --scene 4

Writes ``<outdir>/<name>_<W>x<H>_<spp>spp.png`` and appends one row of
counters per render to ``<outdir>/SWEEP.md``. Requires a GPU.
"""

import argparse
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))


def render_scene(scene_idx, outdir, spp=None, size=None, depth=None):
    from zraytrace_tpu.config import RenderParams
    from zraytrace_tpu.io.png import write_png
    from zraytrace_tpu.render import render
    from zraytrace_tpu.scenes import build_scene

    if scene_idx == 1:
        size, spp, depth = size or 1000, spp or 1000, depth or 30
    else:
        size, spp, depth = size or 700, spp or 100, depth or 20
    out = Path(outdir)
    out.mkdir(parents=True, exist_ok=True)

    built = build_scene(scene_idx)
    t0 = time.time()
    img, st = render(built.scene, built.camera, RenderParams(
        width=size, height=size, samples_per_pixel=spp, max_depth=depth))
    dt = time.time() - t0
    path = out / f"{built.name}_{size}x{size}_{spp}spp.png"
    write_png(path, img)

    assert st.samples == size * size * spp, (st.samples, size * size * spp)
    assert st.rays == (st.reflections + st.samples
                       - st.recursion_depth_hits), "counter identity"
    line = (f"| {scene_idx} {built.name} | {size}x{size} | {spp} | {depth} "
            f"| {st.rays} | {st.reflections} | {st.background_hits} "
            f"| {st.recursion_depth_hits} |")
    with open(out / "SWEEP.md", "a") as f:
        f.write(line + "\n")
    print(f"wrote {path} in {dt:.1f}s", file=sys.stderr, flush=True)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("outdir")
    ap.add_argument("--scene", type=int, action="append", required=True)
    ap.add_argument("--spp", type=int, default=None)
    ap.add_argument("--size", type=int, default=None)
    ap.add_argument("--depth", type=int, default=None)
    args = ap.parse_args()
    from zraytrace_tpu.runtime import enable_compilation_cache, require_gpu

    require_gpu("render_showcase")
    enable_compilation_cache()
    for sidx in args.scene:
        render_scene(sidx, args.outdir, args.spp, args.size, args.depth)


if __name__ == "__main__":
    main()
