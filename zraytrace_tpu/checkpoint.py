"""Checkpoint / resume for long renders and optimizations.

The reference has nothing here — a crash loses the render (SURVEY.md §5).
Design: Monte Carlo accumulation is a running sum, so the checkpoint is
simply (pixel_sum, samples_done, counters). Resuming continues the SAME
sample streams (stateless RNG is keyed by absolute sample index), so a
resumed render is bit-identical to an uninterrupted one.
"""

from __future__ import annotations

import dataclasses
import os
import tempfile

import numpy as np

from zraytrace_tpu import camera as cam
from zraytrace_tpu.config import RenderParams
from zraytrace_tpu.render import N_COUNTERS, RenderStats, _counters_to_ints
from zraytrace_tpu.scene import Scene

_MAGIC = "zraytrace_tpu-render-v1"


def scene_fingerprint(scene, camera=None, extra: tuple = ()) -> str:
    """Stable hash of every scene/camera array plus ``extra`` config.

    Resuming a checkpoint against a different scene would silently blend
    sample sums from two scenes into one image; the fingerprint rejects
    that instead.
    """
    import hashlib

    import jax

    h = hashlib.sha256()
    for leaf in jax.tree_util.tree_leaves((scene, camera)):
        arr = np.asarray(leaf)
        h.update(str(arr.dtype).encode())
        h.update(str(arr.shape).encode())
        h.update(np.ascontiguousarray(arr).tobytes())
    h.update(repr(extra).encode())
    return h.hexdigest()


@dataclasses.dataclass
class RenderCheckpoint:
    pixel_sum: np.ndarray  # (H*W, 3) f64 accumulated radiance sums
    counters: np.ndarray  # (N_COUNTERS, 2) uint64 two-limb totals
    samples_done: int
    width: int
    height: int
    seed: int
    max_depth: int
    # sha256 over scene + camera arrays + chunking; "" accepts anything
    # (pre-v2 checkpoints).
    scene_hash: str = ""


def save_checkpoint(path, ckpt: RenderCheckpoint) -> None:
    """Atomic write (tmp + rename) so an interrupt never corrupts it."""
    d = os.path.dirname(os.path.abspath(path)) or "."
    os.makedirs(d, exist_ok=True)
    fd, tmp = tempfile.mkstemp(dir=d, suffix=".tmp")
    try:
        with os.fdopen(fd, "wb") as f:
            np.savez(
                f,
                magic=_MAGIC,
                pixel_sum=ckpt.pixel_sum,
                counters=ckpt.counters,
                samples_done=ckpt.samples_done,
                width=ckpt.width,
                height=ckpt.height,
                seed=ckpt.seed,
                max_depth=ckpt.max_depth,
                scene_hash=ckpt.scene_hash,
            )
        os.replace(tmp, path)
    except BaseException:
        if os.path.exists(tmp):
            os.unlink(tmp)
        raise


def load_checkpoint(path) -> RenderCheckpoint | None:
    if not os.path.exists(path):
        return None
    with np.load(path, allow_pickle=False) as z:
        if str(z["magic"]) != _MAGIC:
            raise ValueError(f"{path} is not a {_MAGIC} checkpoint")
        return RenderCheckpoint(
            pixel_sum=z["pixel_sum"],
            counters=z["counters"],
            samples_done=int(z["samples_done"]),
            width=int(z["width"]),
            height=int(z["height"]),
            seed=int(z["seed"]),
            max_depth=int(z["max_depth"]),
            scene_hash=str(z["scene_hash"]) if "scene_hash" in z else "",
        )


_FIT_MAGIC = "zraytrace_tpu-fit-v1"


def save_fit_checkpoint(path, params, opt_state, step: int, losses,
                        fingerprint: str = "") -> None:
    """Checkpoint an inverse-rendering optimization: parameter pytree +
    optimizer state + step counter (SURVEY.md §5 'and optimizer state for
    inverse rendering'). Atomic like save_checkpoint."""
    import jax

    leaves = jax.tree_util.tree_leaves((params, opt_state))
    d = os.path.dirname(os.path.abspath(path)) or "."
    os.makedirs(d, exist_ok=True)
    fd, tmp = tempfile.mkstemp(dir=d, suffix=".tmp")
    try:
        payload = {f"leaf_{i}": np.asarray(x) for i, x in enumerate(leaves)}
        with os.fdopen(fd, "wb") as f:
            np.savez(
                f, magic=_FIT_MAGIC, n_leaves=len(leaves), step=step,
                losses=np.asarray(losses, np.float32),
                fingerprint=fingerprint, **payload,
            )
        os.replace(tmp, path)
    except BaseException:
        if os.path.exists(tmp):
            os.unlink(tmp)
        raise


def load_fit_checkpoint(path, params_like, opt_state_like,
                        fingerprint: str = ""):
    """Restore (params, opt_state, step, losses) from a fit checkpoint.

    ``params_like`` / ``opt_state_like`` provide the pytree structure
    (build a fresh optimizer state to get it). Returns None if ``path``
    does not exist; raises on structure or fingerprint mismatch.
    """
    import jax

    if not os.path.exists(path):
        return None
    tree = (params_like, opt_state_like)
    treedef = jax.tree_util.tree_structure(tree)
    like_leaves = jax.tree_util.tree_leaves(tree)
    with np.load(path, allow_pickle=False) as z:
        if str(z["magic"]) != _FIT_MAGIC:
            raise ValueError(f"{path} is not a {_FIT_MAGIC} checkpoint")
        if fingerprint and str(z["fingerprint"]) and \
                str(z["fingerprint"]) != fingerprint:
            raise ValueError(
                f"fit checkpoint {path} was written for a different "
                "scene/target/config"
            )
        n = int(z["n_leaves"])
        if n != len(like_leaves):
            raise ValueError(
                f"fit checkpoint {path} has {n} leaves, expected "
                f"{len(like_leaves)} — optimizer or scene structure changed"
            )
        leaves = [jnp_like(z[f"leaf_{i}"], like_leaves[i]) for i in range(n)]
        params, opt_state = jax.tree_util.tree_unflatten(treedef, leaves)
        return params, opt_state, int(z["step"]), z["losses"]


def jnp_like(arr, like):
    """Restore a saved leaf with the dtype/weak-type of its template."""
    import jax.numpy as jnp

    out = jnp.asarray(arr)
    if hasattr(like, "dtype") and out.dtype != like.dtype:
        out = out.astype(like.dtype)
    return out


def _restore_or_init(path, fp: str, params: RenderParams, n: int):
    """Shared checkpoint restore/validation for the chunked render
    wrappers: returns ``(pixel_sum f64, counters u64 limbs, done)``."""
    ckpt = load_checkpoint(path)
    if ckpt is not None:
        if (ckpt.width, ckpt.height, ckpt.seed, ckpt.max_depth) != (
            params.width, params.height, params.seed, params.max_depth,
        ):
            raise ValueError(
                f"checkpoint {path} does not match render config")
        if ckpt.scene_hash and ckpt.scene_hash != fp:
            raise ValueError(
                f"checkpoint {path} was written for a different scene/"
                "camera/engine/chunking — refusing to blend sample sums"
            )
        return (ckpt.pixel_sum.astype(np.float64),
                ckpt.counters.astype(np.uint64), ckpt.samples_done)
    return (np.zeros((n, 3), np.float64),
            np.zeros((N_COUNTERS, 2), np.uint64), 0)


def _chunk_step(total: int, done: int, chunk: int) -> int:
    """Next chunk size: plain ``min(chunk, remaining)``.

    The chunk plan must not depend on the total spp: folding a short tail
    into the previous chunk would make a partial run plus resume chunk
    differently from an uninterrupted run, and break the bit-identical
    resume."""
    return min(chunk, total - done)


def _final_stats(pixel_sum, counters, params: RenderParams, n: int,
                 elapsed: float):
    """Shared image + RenderStats assembly for the chunked wrappers."""
    image = (pixel_sum / params.samples_per_pixel).reshape(
        params.height, params.width, 3).astype(np.float32)
    rays, refl, bg, rec, samples, iters = _counters_to_ints(counters)
    return image, RenderStats(
        rays=rays, reflections=refl, background_hits=bg,
        recursion_depth_hits=rec, samples=samples, pixels=n,
        wavefront_iterations=iters, render_seconds=elapsed,
    )


def render_checkpointed(
    scene: Scene,
    camera: cam.Camera,
    params: RenderParams,
    path,
    chunk_spp: int = 50,
):
    """Render with periodic checkpointing every ``chunk_spp`` samples.

    Resumes from ``path`` if present (must match the render config).
    Because sample streams are keyed by absolute sample index, a resumed
    run produces bit-identical results to an uninterrupted
    ``render_checkpointed`` call with the same chunking (and is
    statistically identical to ``render``, which accumulates in a
    different order). Returns ``(image, RenderStats)``.
    """
    import time

    import jax

    from zraytrace_tpu.render import (
        _wavefront_jit, maybe_build_bvh, wavefront_args,
    )

    w, h = params.width, params.height
    n = w * h
    tri_bvh = maybe_build_bvh(scene, params)
    # Same lane/slot layout as render() (render.wavefront_args); pixel
    # ids stay global, so resumed results are layout-invariant.
    layout = wavefront_args(scene, camera, params)
    n_lanes, n_slots = layout[-3], layout[-1]

    # the fingerprint covers everything that shapes the accumulated
    # sums: scene, camera, chunking, the triangle engine, the layout and
    # the backend (a resume on another engine or backend would blend two
    # float orders and their borderline-comparison events into one image)
    fp = scene_fingerprint(
        scene, camera,
        extra=(chunk_spp, tri_bvh is not None, n_lanes, n_slots,
               jax.default_backend()))
    pixel_sum, counters, done = _restore_or_init(path, fp, params, n)

    t0 = time.perf_counter()
    while done < params.samples_per_pixel:
        step = _chunk_step(params.samples_per_pixel, done, chunk_spp)
        sums, cnts = jax.block_until_ready(_wavefront_jit(*wavefront_args(
            scene, camera, params, tri_bvh, spp=step, sample_start=done)))
        flat = np.asarray(sums, np.float64).reshape(n_slots * n_lanes, 3)[:n]
        pixel_sum += flat
        counters += np.asarray(cnts, np.uint64)
        done += step
        save_checkpoint(
            path,
            RenderCheckpoint(
                pixel_sum=pixel_sum, counters=counters, samples_done=done,
                width=w, height=h, seed=params.seed,
                max_depth=params.max_depth, scene_hash=fp,
            ),
        )
    elapsed = time.perf_counter() - t0
    return _final_stats(pixel_sum, counters, params, n, elapsed)


def render_sharded_checkpointed(
    scene: Scene,
    camera: cam.Camera,
    params: RenderParams,
    mesh,
    path,
    chunk_spp: int = 50,
):
    """Distributed render with periodic checkpointing (SURVEY §5: long
    multi-host renders restart from tile checkpoints instead of
    restarting from zero).

    Chunks the global sample range through ``render_sharded`` (streams
    are keyed by absolute sample index, so a resumed run is
    bit-identical to an uninterrupted one at the same chunking and mesh
    shape) and saves accumulated pixel sums + counters after every
    chunk — the same atomic format ``render_checkpointed`` uses, with
    the mesh shape folded into the fingerprint so a checkpoint cannot
    silently resume on a different device topology. ``chunk_spp`` must
    be a multiple of the mesh's sample-axis size. Returns
    ``(image (H,W,3) f32, RenderStats)``.
    """
    import dataclasses
    import time

    n_sample = mesh.shape["sample"]
    if chunk_spp % n_sample:
        raise ValueError(
            f"chunk_spp={chunk_spp} must be a multiple of the sample "
            f"axis size {n_sample}")
    if params.samples_per_pixel % n_sample:
        raise ValueError(
            f"spp={params.samples_per_pixel} must divide over sample "
            f"axis {n_sample}")
    w, h = params.width, params.height
    n = w * h
    # engine settings in the fingerprint for the same reason as
    # render_checkpointed: a resume must not silently blend chunks from
    # a different engine, backend, or mesh topology
    import jax

    fp = scene_fingerprint(
        scene, camera,
        extra=(chunk_spp, "sharded", tuple(mesh.devices.shape),
               jax.default_backend(), params.max_wavefront, params.bvh,
               params.bvh_min_triangles))
    pixel_sum, counters, done = _restore_or_init(path, fp, params, n)

    t0 = time.perf_counter()
    while done < params.samples_per_pixel:
        step = _chunk_step(params.samples_per_pixel, done, chunk_spp)
        sub = dataclasses.replace(params, samples_per_pixel=step)
        from zraytrace_tpu.parallel.mesh import render_sharded

        img, st = render_sharded(scene, camera, sub, mesh,
                                 sample_start=done)
        # render_sharded returns the chunk MEAN; re-weight to sums (the
        # f32 divide/re-multiply is deterministic, so resume stays
        # bit-identical)
        pixel_sum += np.asarray(img, np.float64).reshape(n, 3) * step
        for i, v in enumerate((st.rays, st.reflections,
                               st.background_hits,
                               st.recursion_depth_hits, st.samples,
                               st.wavefront_iterations)):
            counters[i, 0] += np.uint64(v >> 32)
            counters[i, 1] += np.uint64(v & 0xFFFFFFFF)
        done += step
        save_checkpoint(
            path,
            RenderCheckpoint(
                pixel_sum=pixel_sum, counters=counters, samples_done=done,
                width=w, height=h, seed=params.seed,
                max_depth=params.max_depth, scene_hash=fp,
            ),
        )
    elapsed = time.perf_counter() - t0
    return _final_stats(pixel_sum, counters, params, n, elapsed)
