#!/usr/bin/env python
"""Smoke run of the main paths on an NVIDIA GPU, checked against the
plain reference.

    python chip_smoke.py                      # one card, every phase
    python chip_smoke.py --spp 16             # cut the sample count
    python chip_smoke.py --four               # four cards: sharded paths only
    python chip_smoke.py --resume-across DIR  # run twice: resume in a new process

Phases on one card (each prints its own lines; any failure exits
non-zero and no result line is printed):

1. device: platform, kind, count and nvidia-smi's name and power limit;
   fails unless JAX's platform is ``gpu``.
2. spheres: the 7-spheres scene at 1000x1000, depth 30, through the CLI
   (``cli.run``), with the PNG written and the counters checked.
3. reference: small renders on the GPU and on the host CPU in the same
   process (identical RNG streams) must agree.
4. teapot: scene 3 at 700x700, depth 20, brute-force and BVH triangle
   engines, which must agree.
5. fit: ``fit()`` on the sphere recovery config and one value_and_grad
   against the CPU; two steps of ``examples/mesh_fit.py``.
6. checkpoint: ``render_checkpointed`` stopped after one chunk and
   resumed must equal an uninterrupted run bit for bit.

Only the sample count is cut from the reference configs (1000 spp for
the 7-spheres scene, 500 for the teapot); each cut is printed. The last
line of standard output is one JSON object:
``{"ok": true, "device": {"platform": ..., "kind": ..., "count": ...}}``.
"""

from __future__ import annotations

import argparse
import contextlib
import importlib.util
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

import zraytrace_tpu  # noqa: F401  (fails outside a checkout of the repo)

ROOT = Path(__file__).resolve().parent
OUT = ROOT / "chiprun_out" / "chip_smoke"

COUNTER_FIELDS = ("rays", "reflections", "background_hits",
                  "recursion_depth_hits", "samples")
COUNTER_REL = 1e-3       # counters of two engines or devices: 0.1%
IMAGE_MEAN_ABS = 1 / 255  # mean |difference| of two images
GRAD_REL_CPU = 1e-3      # GPU vs CPU value_and_grad (loss, albedo)
# GPU vs CPU gradients of silhouette-dominated fields (sphere centers and
# radii). f32 rounding differs between the two backends (the GPU
# contracts multiply-adds), so now and then a path flips at a boundary
# and drops its edge-factor weight elsewhere; the first H100 run
# observed 3.4e-2 with the loss equal to 6e-5.
GRAD_REL_CPU_BOUNDARY = 5e-2
GRAD_REL_SHARDED = 1e-4  # four-card vs one-card value_and_grad

# Shapes of each phase (width, height, depth, ...). Widths are the
# reference's own (scenes.zig, bench.py); tests shrink them to run the
# phases on the CPU.
SPHERES = dict(width=1000, height=1000, max_depth=30)
REFERENCE = ((1, dict(width=96, height=64, samples_per_pixel=4,
                      max_depth=8)),
             (3, dict(width=64, height=64, samples_per_pixel=2,
                      max_depth=8)))
TEAPOT = dict(width=700, height=700, max_depth=20)
FIT = dict(size=128, spp=8, depth=10, steps=6, cpu_size=32)
CKPT = dict(width=200, height=200, samples_per_pixel=8, max_depth=30)
CKPT_CHUNK = 4
TRAIN = dict(size=128, spp=4, depth=8)
MESH_FIT_ARGS = ["--steps", "2"]

PHASES_ONE = ("device", "spheres", "reference", "teapot", "fit",
              "checkpoint")
PHASES_FOUR = ("device", "four")
PHASES_RESUME = ("device", "resume_across")


def log(phase: str, msg: str) -> None:
    print(f"[{phase}] {msg}", flush=True)


# ---------------------------------------------------------------------------
# checks (pure; tested on the CPU)
# ---------------------------------------------------------------------------


def phases_for(args) -> tuple:
    """The phases one invocation runs."""
    if args.four:
        return PHASES_FOUR
    if args.resume_across:
        return PHASES_RESUME
    return PHASES_ONE


def stats_identity(stats, w: int, h: int, spp: int) -> None:
    """The reference's counter identities (raytrace.zig:20-34)."""
    if stats.samples != w * h * spp:
        raise AssertionError(f"samples {stats.samples} != {w}*{h}*{spp}")
    if stats.rays != (stats.reflections + stats.samples
                      - stats.recursion_depth_hits):
        raise AssertionError(
            f"rays {stats.rays} != reflections + samples - recursion hits")


def counter_rel_diff(got, ref) -> dict:
    """Relative difference of each reference counter."""
    return {f: abs(getattr(got, f) - getattr(ref, f))
            / max(getattr(ref, f), 1) for f in COUNTER_FIELDS}


def check_counters(phase, name, got, ref, rel=COUNTER_REL) -> float:
    diffs = counter_rel_diff(got, ref)
    worst = max(diffs.values())
    log(phase, f"{name}: counters max rel diff {worst:.3e} (limit {rel:g}); "
        + " ".join(f"{f}={getattr(got, f)}/{getattr(ref, f)}"
                   for f in COUNTER_FIELDS))
    if worst > rel:
        raise AssertionError(f"{name}: counters differ by {worst:.3e}")
    return worst


def check_image(phase, name, got, ref, tol=IMAGE_MEAN_ABS) -> float:
    got, ref = np.asarray(got), np.asarray(ref)
    if got.shape != ref.shape:
        raise AssertionError(f"{name}: shape {got.shape} != {ref.shape}")
    mad = float(np.mean(np.abs(got - ref)))
    log(phase, f"{name}: image mean |diff| {mad:.3e} (limit {tol:.3e}), "
        f"max {float(np.max(np.abs(got - ref))):.3e}")
    if not mad <= tol:
        raise AssertionError(f"{name}: mean |diff| {mad:.3e} > {tol:.3e}")
    return mad


def tree_rel_err(got: dict, ref: dict) -> dict:
    """Per-leaf ``|got - ref| / |ref|`` in the 2-norm."""
    out = {}
    for k in ref:
        a = np.asarray(got[k], np.float64)
        b = np.asarray(ref[k], np.float64)
        out[k] = float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))
    return out


def check_grads(phase, name, got, ref, rel) -> float:
    errs = tree_rel_err(got, ref)
    worst = max(errs.values())
    log(phase, f"{name}: grad rel err {worst:.3e} (limit {rel:g}); "
        + " ".join(f"{k}={v:.2e}" for k, v in errs.items()))
    if worst > rel:
        raise AssertionError(f"{name}: gradients differ by {worst:.3e}")
    return worst


def result_line(devices) -> str:
    d = devices[0]
    return json.dumps({"ok": True, "device": {
        "platform": d.platform, "kind": d.device_kind,
        "count": len(devices)}})


# ---------------------------------------------------------------------------
# phases
# ---------------------------------------------------------------------------


def phase_device(n_cards: int):
    import jax

    devs = jax.devices()
    d = devs[0]
    log("device", f"platform={d.platform} kind={d.device_kind} "
        f"count={len(devs)}")
    if d.platform != "gpu":
        raise SystemExit(f"[device] no GPU: JAX's platform is "
                         f"{d.platform!r}")
    if len(devs) < n_cards:
        raise SystemExit(f"[device] needs {n_cards} GPUs, has {len(devs)}")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    for line in smi.stdout.strip().splitlines():
        print(line, flush=True)
    return devs


@contextlib.contextmanager
def on_host_cpu():
    """The host CPU as JAX's default device, for the plain reference. Its
    programs are not written to the persistent compile cache: a CPU
    program is specific to the host it was compiled on, and the cache
    may travel to another machine."""
    import jax

    cpu = jax.devices("cpu")[0]
    keep = jax.config.jax_persistent_cache_min_compile_time_secs
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 1e9)
    try:
        with jax.default_device(cpu):
            yield cpu
    finally:
        jax.config.update("jax_persistent_cache_min_compile_time_secs", keep)


def _memory(phase, name, jitted, *args) -> None:
    """``compiled.memory_analysis()`` of one program (the persistent
    compile cache makes the second compile a load)."""
    m = jitted.lower(*args).compile().memory_analysis()
    log(phase, f"{name}: memory_analysis "
        f"args={m.argument_size_in_bytes} out={m.output_size_in_bytes} "
        f"temp={m.temp_size_in_bytes} code={m.generated_code_size_in_bytes}")


def _warm_render(scene, camera, params):
    """Compile ``render()``'s program with a 1-spp render (spp is a traced
    argument, so the timed render reuses it); returns seconds."""
    import dataclasses

    from zraytrace_tpu.render import render

    t0 = time.perf_counter()
    render(scene, camera, dataclasses.replace(params, samples_per_pixel=1))
    return time.perf_counter() - t0


def _report_render(phase, name, stats, compile_s) -> None:
    log(phase, f"{name}: {stats.rays_per_second:.6e} rays/s "
        f"(rays={stats.rays} render={stats.render_seconds:.4f}s "
        f"transfer={stats.transfer_seconds:.4f}s "
        f"preprocess={stats.preprocess_seconds:.4f}s "
        f"iterations={stats.wavefront_iterations} "
        f"compile+warm={compile_s:.1f}s)")


def phase_spheres(spp: int) -> None:
    from zraytrace_tpu import cli
    from zraytrace_tpu.config import RenderParams
    from zraytrace_tpu.io.png import read_png
    from zraytrace_tpu.render import _wavefront_jit, wavefront_args
    from zraytrace_tpu.scenes import build_scene

    w, h, depth = SPHERES["width"], SPHERES["height"], SPHERES["max_depth"]
    log("spheres", f"7-spheres {w}x{h} depth {depth} spp {spp} "
        "(reference config: 1000 spp)")
    built = build_scene(1)
    params = RenderParams(width=w, height=h, samples_per_pixel=spp,
                          max_depth=depth)
    compile_s = _warm_render(built.scene, built.camera, params)
    png = OUT / "spheres.png"
    png.unlink(missing_ok=True)
    image, stats = cli.run([str(w), str(h), str(spp), str(depth), "1",
                            str(png)])
    back = read_png(png)
    if back.shape != (h, w, 3):
        raise AssertionError(f"PNG shape {back.shape}")
    if not np.isfinite(image).all():
        raise AssertionError("non-finite pixels")
    stats_identity(stats, w, h, spp)
    log("spheres", f"PNG written ({png.stat().st_size} bytes); counter "
        "identities hold; image finite, mean "
        f"{float(np.mean(image)):.6f}")
    _report_render("spheres", "cli render", stats, compile_s)
    _memory("spheres", "wavefront", _wavefront_jit,
            *wavefront_args(built.scene, built.camera, params))


def phase_reference() -> None:
    import jax

    from zraytrace_tpu.config import RenderParams
    from zraytrace_tpu.render import render
    from zraytrace_tpu.scenes import build_scene

    for idx, shape in REFERENCE:
        built = build_scene(idx)
        params = RenderParams(**shape)
        w, h, spp, depth = (shape["width"], shape["height"],
                            shape["samples_per_pixel"], shape["max_depth"])
        img_g, st_g = render(built.scene, built.camera, params)
        with on_host_cpu() as cpu:
            scene_c, camera_c = jax.device_put(
                (built.scene, built.camera), cpu)
            img_c, st_c = render(scene_c, camera_c, params)
        name = f"scene {idx} {w}x{h}x{spp} d{depth} gpu vs cpu"
        check_counters("reference", name, st_g, st_c)
        check_image("reference", name, img_g, img_c)


def phase_teapot(spp: int) -> None:
    from zraytrace_tpu.config import RenderParams
    from zraytrace_tpu.render import (
        _wavefront_jit, maybe_build_bvh, render, wavefront_args,
    )
    from zraytrace_tpu.scenes import build_scene

    w, h, depth = TEAPOT["width"], TEAPOT["height"], TEAPOT["max_depth"]
    built = build_scene(3)
    log("teapot", f"teapot {w}x{h} depth {depth} spp {spp} "
        f"({built.scene.n_triangles} triangles; reference config: "
        "500 spp)")
    base = dict(width=w, height=h, samples_per_pixel=spp, max_depth=depth)
    results = {}
    for name, params in (
            ("brute", RenderParams(**base, bvh=False)),
            ("bvh", RenderParams(**base, bvh_min_triangles=0))):
        compile_s = _warm_render(built.scene, built.camera, params)
        img, st = render(built.scene, built.camera, params)
        if not np.isfinite(img).all():
            raise AssertionError(f"{name}: non-finite pixels")
        stats_identity(st, w, h, spp)
        _report_render("teapot", name, st, compile_s)
        _memory("teapot", name, _wavefront_jit, *wavefront_args(
            built.scene, built.camera, params,
            maybe_build_bvh(built.scene, params)))
        results[name] = (img, st)
    check_counters("teapot", "bvh vs brute", results["bvh"][1],
                   results["brute"][1])
    check_image("teapot", "bvh vs brute", results["bvh"][0],
                results["brute"][0])
    rb = results["brute"][1].rays_per_second
    rv = results["bvh"][1].rays_per_second
    log("teapot", f"bvh/brute rate ratio {rv / rb:.4f} "
        f"({'BVH faster' if rv > rb else 'brute faster'})")


FIT_FIELDS = ("sph_center", "sph_radius", "tex_color")
FIT_EPS = (0.01, 0.02)


def _fit_problem(size: int, spp: int, depth: int):
    """Sphere recovery on the 7-spheres scene: target rendered from the
    true scene, start from perturbed centers, radii and albedos (the
    ground sphere stays put)."""
    import jax.numpy as jnp

    from zraytrace_tpu.render_diff import render_diff
    from zraytrace_tpu.scenes import build_scene

    built = build_scene(1)
    true = built.scene
    target = render_diff(true, built.camera, size, size, spp, depth)
    rng = np.random.default_rng(0)
    s = true.n_spheres
    move = np.zeros((s, 3), np.float32)
    move[1:] = rng.normal(scale=0.05, size=(s - 1, 3))
    grow = np.ones((s,), np.float32)
    grow[1:] = 1.03
    init = true._replace(
        sph_center=true.sph_center + move,
        sph_radius=true.sph_radius * grow,
        tex_color=true.tex_color * 0.8)
    return init, built.camera, target


def _live_loss(scene, camera, target, size, spp, depth):
    """``fit()``'s loss over the optimized fields only."""
    from zraytrace_tpu.inverse import make_loss_fn, split_scene

    params, static = split_scene(scene)
    live = {f: params[f] for f in FIT_FIELDS}
    static = {**static, **{f: v for f, v in params.items()
                           if f not in FIT_FIELDS}}
    return live, make_loss_fn(static, camera, target, size, size, spp,
                              depth, edge_eps=FIT_EPS)


def phase_fit() -> None:
    import jax

    from zraytrace_tpu.inverse import fit
    from zraytrace_tpu.render_diff import render_diff

    size, spp, depth, steps = FIT["size"], FIT["spp"], FIT["depth"], FIT["steps"]
    log("fit", f"sphere recovery: scene 1 {size}x{size} spp {spp} "
        f"depth {depth} edge_eps {FIT_EPS} fields {FIT_FIELDS}")
    init, camera, target = _fit_problem(size, spp, depth)
    t0 = time.perf_counter()
    res = fit(init, camera, target, size, size, spp=spp, max_depth=depth,
              steps=steps, learning_rate=1e-2, optimize_fields=FIT_FIELDS,
              edge_eps=FIT_EPS)
    losses = np.asarray(res.losses)
    log("fit", f"fit() {steps} steps in {time.perf_counter() - t0:.1f}s "
        f"(compile included); losses {np.array2string(losses)}")
    if not np.isfinite(losses).all():
        raise AssertionError("non-finite loss")
    if not losses[-1] < losses[0]:
        raise AssertionError("loss did not fall")

    live, loss_fn = _live_loss(init, camera, target, size, spp, depth)
    vg = jax.jit(jax.value_and_grad(loss_fn))
    jax.block_until_ready(vg(live))
    n = 5
    t0 = time.perf_counter()
    for _ in range(n):
        out = vg(live)
    jax.block_until_ready(out)
    log("fit", f"value_and_grad {1e3 * (time.perf_counter() - t0) / n:.4f}"
        " ms/step (mean of 5 warm steps)")
    _memory("fit", "value_and_grad", vg, live)

    # one value_and_grad against the host CPU, same inputs
    small = FIT["cpu_size"]
    init_s, camera_s, target_s = _fit_problem(small, spp, depth)
    target_s = np.asarray(target_s)
    live_g, loss_g = _live_loss(init_s, camera_s, target_s, small, spp,
                                depth)
    v_g, g_g = jax.jit(jax.value_and_grad(loss_g))(live_g)
    with on_host_cpu() as cpu:
        init_c, camera_c = jax.device_put((init_s, camera_s), cpu)
        live_c, loss_c = _live_loss(init_c, camera_c, target_s, small, spp,
                                    depth)
        v_c, g_c = jax.jit(jax.value_and_grad(loss_c))(live_c)
    v_rel = abs(float(v_g) - float(v_c)) / abs(float(v_c))
    log("fit", f"{small}x{small} loss gpu {float(v_g):.8e} cpu "
        f"{float(v_c):.8e} rel {v_rel:.3e} (limit {GRAD_REL_CPU:g})")
    if v_rel > GRAD_REL_CPU:
        raise AssertionError(f"loss differs by {v_rel:.3e}")
    img_g = np.asarray(render_diff(init_s, camera_s, small, small, spp,
                                   depth))
    with on_host_cpu():
        img_c = np.asarray(render_diff(init_c, camera_c, small, small, spp,
                                       depth))
    log("fit", f"{small}x{small} forward gpu vs cpu: "
        f"{int((np.abs(img_g - img_c) > 1e-3).any(-1).sum())} of "
        f"{small * small} pixels differ by > 1e-3")
    boundary = ("sph_center", "sph_radius")
    check_grads("fit", f"{small}x{small} gpu vs cpu, albedo",
                {k: g_g[k] for k in g_g if k not in boundary},
                {k: g_c[k] for k in g_c if k not in boundary}, GRAD_REL_CPU)
    check_grads("fit", f"{small}x{small} gpu vs cpu, silhouette fields",
                {k: g_g[k] for k in boundary}, {k: g_c[k] for k in boundary},
                GRAD_REL_CPU_BOUNDARY)

    spec = importlib.util.spec_from_file_location(
        "mesh_fit", ROOT / "examples" / "mesh_fit.py")
    mesh_fit = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mesh_fit)
    args = mesh_fit.parse_args(MESH_FIT_ARGS)
    log("fit", f"examples/mesh_fit.py defaults ({args.size}x{args.size} "
        f"spp {args.spp} depth {args.depth}), 2 steps")
    losses, err, err0 = mesh_fit.run(args, log=lambda s: log("fit", s))
    log("fit", f"mesh_fit losses {losses}; pose error {err0:.4f} -> "
        f"{err:.4f}")
    if len(losses) != 2 or not np.isfinite(losses).all():
        raise AssertionError("mesh_fit losses not finite")


def _checkpoint_runs(params, full_path, part_path, chunk):
    import dataclasses

    from zraytrace_tpu.checkpoint import render_checkpointed
    from zraytrace_tpu.scenes import build_scene

    built = build_scene(1)
    img_full, st_full = render_checkpointed(
        built.scene, built.camera, params, full_path, chunk_spp=chunk)
    render_checkpointed(
        built.scene, built.camera,
        dataclasses.replace(params, samples_per_pixel=chunk), part_path,
        chunk_spp=chunk)
    return built, img_full, st_full


def phase_checkpoint() -> None:
    from zraytrace_tpu.checkpoint import render_checkpointed
    from zraytrace_tpu.config import RenderParams

    params = RenderParams(**CKPT)
    d = OUT / "checkpoint"
    d.mkdir(parents=True, exist_ok=True)
    full, part = d / "full.npz", d / "resume.npz"
    full.unlink(missing_ok=True)
    part.unlink(missing_ok=True)
    log("checkpoint", f"scene 1 {CKPT}, chunk {CKPT_CHUNK}: stop after one "
        "chunk, resume in this process")
    built, img_full, st_full = _checkpoint_runs(params, full, part,
                                                CKPT_CHUNK)
    img_res, st_res = render_checkpointed(
        built.scene, built.camera, params, part, chunk_spp=CKPT_CHUNK)
    same = np.array_equal(img_full, img_res)
    log("checkpoint", f"resumed == uninterrupted bit for bit: {same}; "
        f"max |diff| {float(np.max(np.abs(img_full - img_res))):.3e}; "
        f"rays {st_res.rays}/{st_full.rays}")
    if not same or st_res.rays != st_full.rays:
        raise AssertionError("resume is not bit-identical")


def phase_resume_across(d: Path) -> None:
    """First call: uninterrupted run + a run stopped after one chunk.
    Second call (a new process): resume, compare with the first."""
    from zraytrace_tpu.checkpoint import render_checkpointed
    from zraytrace_tpu.config import RenderParams

    params = RenderParams(**CKPT)
    d.mkdir(parents=True, exist_ok=True)
    full, part, ref = d / "full.npz", d / "resume.npz", d / "image.npy"
    if not ref.exists():
        _, img_full, st_full = _checkpoint_runs(params, full, part,
                                                CKPT_CHUNK)
        np.save(ref, img_full)
        log("resume_across", f"first process: uninterrupted image saved, "
            f"rays {st_full.rays}; run again to resume")
        return
    from zraytrace_tpu.scenes import build_scene

    built = build_scene(1)
    img_res, _ = render_checkpointed(built.scene, built.camera, params,
                                     part, chunk_spp=CKPT_CHUNK)
    img_full = np.load(ref)
    diff = np.abs(img_full - img_res)
    same = np.array_equal(img_full, img_res)
    log("resume_across", f"second process: resumed == first process's "
        f"uninterrupted run bit for bit: {same}; max |diff| "
        f"{float(diff.max()):.3e}, mean {float(diff.mean()):.3e}")
    check_image("resume_across", "resume across processes", img_res,
                img_full)


def phase_four(spp: int) -> None:
    import jax
    import jax.numpy as jnp

    from zraytrace_tpu.config import RenderParams
    from zraytrace_tpu.inverse import (
        make_sharded_loss, make_sharded_train_step, split_scene,
    )
    from zraytrace_tpu.parallel.mesh import make_mesh, render_sharded
    from zraytrace_tpu.render import render
    from zraytrace_tpu.scenes import build_scene

    devs = jax.devices()[:4]
    w, h, depth = SPHERES["width"], SPHERES["height"], SPHERES["max_depth"]
    built = build_scene(1)
    params = RenderParams(width=w, height=h, samples_per_pixel=spp,
                          max_depth=depth)
    log("four", f"7-spheres {w}x{h} depth {depth} spp {spp} "
        "(reference config: 1000 spp) on card 0 and on 4 cards")
    compile_s = _warm_render(built.scene, built.camera, params)
    img_1, st_1 = render(built.scene, built.camera, params)
    _report_render("four", "render() card 0", st_1, compile_s)
    for shape in ((2, 2), (4, 1)):
        mesh = make_mesh(*shape, devices=devs)
        t0 = time.perf_counter()
        render_sharded(built.scene, built.camera, RenderParams(
            width=w, height=h, samples_per_pixel=shape[1],
            max_depth=depth), mesh)
        warm = time.perf_counter() - t0
        img_4, st_4 = render_sharded(built.scene, built.camera, params,
                                     mesh)
        name = f"render_sharded {shape[0]}x{shape[1]} (data x sample)"
        _report_render("four", name, st_4, warm)
        equal = all(getattr(st_4, f) == getattr(st_1, f)
                    for f in COUNTER_FIELDS)
        log("four", f"{name}: counters equal to card 0: {equal}")
        check_counters("four", name + " vs card 0", st_4, st_1)
        check_image("four", name + " vs card 0", img_4, img_1)

    size, s_spp, s_depth = TRAIN["size"], TRAIN["spp"], TRAIN["depth"]
    scene_params, static = split_scene(built.scene)
    target = jnp.full((size * size, 3), 0.5, jnp.float32)
    log("four", f"sharded train step: scene 1 {size}x{size} spp {s_spp} "
        f"depth {s_depth}, mesh 2x2 vs 1x1 on card 0")
    mesh1 = make_mesh(1, 1, devices=devs[:1])
    mesh4 = make_mesh(2, 2, devices=devs)
    args = (static, built.camera, size, size, s_spp, s_depth)
    v1, g1 = jax.jit(jax.value_and_grad(make_sharded_loss(mesh1, *args)))(
        scene_params, target)
    v4, g4 = jax.jit(jax.value_and_grad(make_sharded_loss(mesh4, *args)))(
        scene_params, target)
    step_fn, optimizer = make_sharded_train_step(mesh4, *args)
    new_params, _, loss = step_fn(scene_params,
                                  optimizer.init(scene_params), target)
    rel = abs(float(loss) - float(v1)) / abs(float(v1))
    log("four", f"train step loss {float(loss):.8e} vs card 0 "
        f"{float(v1):.8e}: rel {rel:.3e} (limit {GRAD_REL_SHARDED:g})")
    if rel > GRAD_REL_SHARDED:
        raise AssertionError(f"sharded loss differs by {rel:.3e}")
    for k, v in new_params.items():
        if not np.isfinite(np.asarray(v)).all():
            raise AssertionError(f"non-finite parameters in {k}")
    check_grads("four", "value_and_grad 2x2 vs card 0", g4, g1,
                GRAD_REL_SHARDED)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--spp", type=int, default=64,
                    help="samples per pixel of the full-size renders")
    ap.add_argument("--four", action="store_true",
                    help="run only the four-card phases")
    ap.add_argument("--resume-across", metavar="DIR", default=None,
                    help="run only the two-process resume check")
    args = ap.parse_args(argv)

    from zraytrace_tpu.runtime import enable_compilation_cache

    phases = phases_for(args)
    enable_compilation_cache()
    devs = phase_device(4 if args.four else 1)
    t_all = time.perf_counter()
    run_phases(phases[1:], args)
    log("all", f"{len(phases)} phases in {time.perf_counter() - t_all:.1f}s")
    print(result_line(devs), flush=True)
    return 0


def run_phases(phases, args) -> None:
    """Run the named phases in order (the device phase excepted)."""
    OUT.mkdir(parents=True, exist_ok=True)
    for phase in phases:
        t0 = time.perf_counter()
        if phase == "spheres":
            phase_spheres(args.spp)
        elif phase == "reference":
            phase_reference()
        elif phase == "teapot":
            phase_teapot(args.spp)
        elif phase == "fit":
            phase_fit()
        elif phase == "checkpoint":
            phase_checkpoint()
        elif phase == "resume_across":
            phase_resume_across(Path(args.resume_across))
        elif phase == "four":
            phase_four(args.spp)
        log(phase, f"done in {time.perf_counter() - t0:.1f}s")


if __name__ == "__main__":
    sys.exit(main())
