"""Inverse rendering: recover scene parameters from target images.

Entirely new capability (the reference is forward-only). Gradient descent
on the float leaves of ``Scene`` — sphere centers/radii, triangle
vertices, IORs, texture colors, atlas texels — and optionally camera
parameters, through the differentiable renderer (render_diff.py).

The distributed training step shards pixels over the ``data`` mesh axis
and samples over ``sample``; scene parameters are replicated and their
gradients all-reduce automatically through the shard_map transpose
(cotangent of a replicated input is a psum over the mesh).
"""

from __future__ import annotations

from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp
import optax
from jax.sharding import Mesh, PartitionSpec as P

from zraytrace_tpu import camera as cam
from zraytrace_tpu.parallel.mesh import DATA_AXIS, SAMPLE_AXIS
from zraytrace_tpu.render_diff import render_diff, trace_paths
from zraytrace_tpu.scene import Scene

# Differentiable leaves of Scene (the rest is integer structure).
DIFF_FIELDS = (
    "sph_center", "sph_radius", "tri_a", "tri_b", "tri_c",
    "mat_ior", "tex_color", "atlas",
)


def split_scene(scene: Scene):
    """Scene -> (params dict, static dict)."""
    params = {f: getattr(scene, f) for f in DIFF_FIELDS}
    static = {f: getattr(scene, f) for f in Scene._fields if f not in DIFF_FIELDS}
    return params, static


def merge_scene(params: dict, static: dict) -> Scene:
    return Scene(**params, **static)


def image_loss(img, target):
    """Mean squared error over pixels/channels."""
    return jnp.mean((img - target) ** 2)


def make_loss_fn(static, camera, target, width, height, spp, max_depth,
                 seed=42, edge_eps=None, edge_screen: bool | None = None):
    """Single-device differentiable loss over the full image.

    ``edge_eps`` enables edge-aware silhouette gradients (edge_grad.py):
    the loss VALUE is unchanged, its gradient gains visibility terms.
    """

    def loss_fn(params, eps_scale=None):
        scene = merge_scene(params, static)
        eps = edge_eps
        if eps is not None and eps_scale is not None:
            # coarse-to-fine schedules pass a traced per-step bandwidth
            # multiplier (fit(coarse_to_fine=...)) — no recompiles
            eps = (tuple(e * eps_scale for e in eps)
                   if isinstance(eps, (tuple, list)) else eps * eps_scale)
        img = render_diff(scene, camera, width, height, spp, max_depth,
                          seed=seed, edge_eps=eps, edge_screen=edge_screen)
        return image_loss(img, target)

    return loss_fn


def fd_gradients(loss_fn, params: dict, fields: tuple, eps: float = 2e-3) -> dict:
    """Exact central-difference gradients for a few low-dimensional fields.

    Analytic reverse-mode gradients capture shading but NOT visibility/
    silhouette coverage (moving a sphere changes which pixels it covers —
    a discontinuous integrand; SURVEY.md §7.7). Because the stateless RNG
    makes ``loss_fn`` deterministic, central differences over the SAME
    sample streams measure the true derivative including coverage, at a
    cost of 2 renders per scalar — practical for sphere centers/radii or
    pose parameters, not for vertex/texel arrays.
    """
    import numpy as np

    grads = {}
    for f in fields:
        arr = np.asarray(params[f])
        flat = arr.ravel().astype(np.float64)
        g = np.zeros_like(flat)
        for i in range(flat.size):
            for sign in (+1.0, -1.0):
                p = flat.copy()
                p[i] += sign * eps
                val = float(
                    loss_fn({**params, f: jnp.asarray(p.reshape(arr.shape), jnp.float32)})
                )
                g[i] += sign * val
            g[i] /= 2.0 * eps
        grads[f] = jnp.asarray(g.reshape(arr.shape), jnp.float32)
    return grads


class FitResult(NamedTuple):
    scene: Scene
    losses: jnp.ndarray


def fit(
    scene_init: Scene,
    camera: cam.Camera,
    target,
    width: int,
    height: int,
    spp: int = 4,
    max_depth: int = 4,
    steps: int = 100,
    learning_rate: float = 1e-2,
    seed: int = 42,
    optimize_fields: tuple = DIFF_FIELDS,
    fd_fields: tuple = (),
    checkpoint_path=None,
    checkpoint_every: int = 10,
    edge_eps=None,
    coarse_to_fine: float = 1.0,
    edge_screen: bool | None = None,
) -> FitResult:
    """Gradient-descend scene parameters toward a target image.

    ``optimize_fields`` restricts which leaves move (e.g. only
    ``("sph_center", "sph_radius")`` for geometry recovery).

    ``fd_fields``: subset of optimize_fields whose gradients come from
    correlated finite differences instead of autodiff — for parameters
    whose image effect is dominated by visibility coverage when
    ``edge_eps`` is off. See ``fd_gradients``.

    ``edge_eps``: enable edge-aware analytic silhouette gradients
    (edge_grad.py) — the preferred replacement for ``fd_fields``; works
    for vertex arrays where FD is intractable.

    ``checkpoint_path``: save (params, optimizer state, step) every
    ``checkpoint_every`` steps and resume from it if present. Because the
    loss is deterministic (stateless RNG), a resumed fit is bit-identical
    to an uninterrupted one.

    ``coarse_to_fine``: start the edge bandwidth at ``coarse_to_fine *
    edge_eps`` and decay geometrically to ``edge_eps`` over the first
    60% of steps (1.0 = off). Far initializations need it: the
    tight-band silhouette gradient turns unreliable mid-range
    (the teapot pose fit from init 1.0
    stalls at pose error 0.85 without the schedule and converges to
    0.066 in 120 steps with it). The multiplier is
    traced, so the schedule costs no recompiles; checkpoints resume
    bit-identically because the scale is a pure function of the step.
    """
    params, static = split_scene(scene_init)
    target = jnp.asarray(target, jnp.float32)

    # Differentiate ONLY the optimized leaves: frozen leaves close over
    # the loss as constants, so their adjoints are never built. The
    # (A,H,W,3) atlas adjoint is a scatter-add per bilinear tap per
    # bounce; a geometry/color fit that doesn't move atlas texels must
    # not pay it.
    live = set(optimize_fields) | set(fd_fields)
    frozen = {f: v for f, v in params.items() if f not in live}
    params = {f: v for f, v in params.items() if f in live}
    static = {**static, **frozen}

    # Freeze non-optimized leaves with a masked optimizer.
    mask = {f: (f in optimize_fields) for f in params}
    optimizer = optax.chain(
        optax.masked(optax.adam(learning_rate), mask),
        optax.masked(optax.set_to_zero(), {f: not m for f, m in mask.items()}),
    )
    opt_state = optimizer.init(params)
    loss_fn = make_loss_fn(static, camera, target, width, height, spp,
                           max_depth, seed, edge_eps=edge_eps,
                           edge_screen=edge_screen)
    loss_jit = jax.jit(loss_fn)
    vg_jit = jax.jit(jax.value_and_grad(loss_fn))

    @jax.jit
    def apply(params, opt_state, grads):
        updates, opt_state = optimizer.update(grads, opt_state, params)
        return optax.apply_updates(params, updates), opt_state

    losses = []
    start = 0
    fp = ""
    if checkpoint_path:
        from zraytrace_tpu.checkpoint import (
            load_fit_checkpoint, save_fit_checkpoint, scene_fingerprint,
        )

        # edge_eps is always part of the fingerprint (a resume with a
        # different bandwidth would silently blend two estimators);
        # steps joins it ONLY when the coarse-to-fine schedule is
        # active, because eps_scale_at divides by 0.6*steps — plain
        # fits keep the resume-and-extend pattern (run steps=2, resume
        # steps=4) that the schedule makes ill-defined
        sched_on = coarse_to_fine != 1.0 and edge_eps is not None
        fp = scene_fingerprint(
            static, camera,
            extra=(width, height, spp, max_depth, seed, learning_rate,
                   tuple(sorted(optimize_fields)), tuple(sorted(fd_fields)),
                   float(coarse_to_fine), repr(edge_eps),
                   repr(edge_screen),
                   int(steps) if sched_on else -1),
        )
        resumed = load_fit_checkpoint(checkpoint_path, params, opt_state, fp)
        if resumed is not None:
            params, opt_state, start, saved_losses = resumed
            losses = [jnp.asarray(v) for v in saved_losses]

    def eps_scale_at(i):
        if coarse_to_fine == 1.0 or edge_eps is None:
            return None  # legacy signature: no retrace, bit-compatible
        frac = min(1.0, i / max(1, int(0.6 * steps)))
        return jnp.float32(coarse_to_fine ** (1.0 - frac))

    for i in range(start, steps):
        sc = eps_scale_at(i)
        loss, grads = vg_jit(params) if sc is None else vg_jit(params, sc)
        if fd_fields:
            # FD sees the UNSCALED loss program: the loss VALUE is
            # bit-exactly independent of the edge bandwidth (edge
            # factors are exactly 1.0 forward), so threading eps_scale
            # through would only compile a second identical forward
            grads = {**grads, **fd_gradients(loss_jit, params, fd_fields)}
        params, opt_state = apply(params, opt_state, grads)
        losses.append(loss)
        if checkpoint_path and ((i + 1) % checkpoint_every == 0
                                or i + 1 == steps):
            save_fit_checkpoint(checkpoint_path, params, opt_state, i + 1,
                                jnp.stack(losses), fp)
    return FitResult(merge_scene(params, static), jnp.stack(losses))


# ---------------------------------------------------------------------------
# Distributed training step (the dryrun_multichip / multi-pod path)
# ---------------------------------------------------------------------------


def make_sharded_loss(
    mesh: Mesh,
    static,
    camera: cam.Camera,
    width: int,
    height: int,
    spp: int,
    max_depth: int,
    seed: int = 42,
):
    """``loss_fn(params, target_flat)``: the pixel-mean squared error of
    the differentiable render over the ``('data', 'sample')`` mesh:

    - pixel lanes sharded over ``data``
    - sample indices sharded over ``sample``
    - per-shard partial images pmean over ``sample``; pixel-mean loss psum
      over ``data``
    - scene-parameter gradients all-reduce via the shard_map transpose.
    """
    n_pixels = width * height
    n_data = mesh.shape[DATA_AXIS]
    n_sample = mesh.shape[SAMPLE_AXIS]
    assert n_pixels % n_data == 0, (n_pixels, n_data)
    assert spp % n_sample == 0, (spp, n_sample)

    def shard_loss(scene, camera, pix_local, samp_local, target_local):
        p_l = pix_local.shape[0]
        s_l = samp_local.shape[0]
        pids = jnp.tile(pix_local, s_l)
        sids = jnp.repeat(samp_local, p_l)
        r = trace_paths(scene, camera, pids, sids, seed, width, height, max_depth)
        img_partial = r.reshape(s_l, p_l, 3).mean(axis=0)
        img = jax.lax.pmean(img_partial, SAMPLE_AXIS)
        sq = jnp.sum((img - target_local) ** 2)
        return jax.lax.psum(sq, DATA_AXIS) / (3.0 * n_pixels)

    loss_sharded = jax.shard_map(
        shard_loss,
        mesh=mesh,
        in_specs=(P(), P(), P(DATA_AXIS), P(SAMPLE_AXIS), P(DATA_AXIS, None)),
        out_specs=P(),
        check_vma=False,
    )

    pixel_ids = jnp.arange(n_pixels, dtype=jnp.int32)
    sample_ids = jnp.arange(spp, dtype=jnp.int32)

    def loss_fn(params, target_flat):
        scene = merge_scene(params, static)
        return loss_sharded(scene, camera, pixel_ids, sample_ids, target_flat)

    return loss_fn


def make_sharded_train_step(
    mesh: Mesh,
    static,
    camera: cam.Camera,
    width: int,
    height: int,
    spp: int,
    max_depth: int,
    learning_rate: float = 1e-2,
    seed: int = 42,
):
    """Build ``(step_fn, optimizer)`` where step_fn is a jitted SPMD Adam
    step on ``make_sharded_loss`` over the ``('data', 'sample')`` mesh."""
    loss_fn = make_sharded_loss(mesh, static, camera, width, height, spp,
                                max_depth, seed)
    optimizer = optax.adam(learning_rate)

    @jax.jit
    def step_fn(params, opt_state, target_flat):
        loss, grads = jax.value_and_grad(loss_fn)(params, target_flat)
        updates, opt_state = optimizer.update(grads, opt_state, params)
        params = optax.apply_updates(params, updates)
        return params, opt_state, loss

    return step_fn, optimizer
