"""Differentiable render path.

The fast wavefront renderer uses ``lax.while_loop`` (not reverse-mode
differentiable). This module re-expresses the identical light transport as
a fixed-trip ``lax.scan`` over bounce depth — reverse-differentiable — so
pixel gradients flow to every float leaf of the ``Scene`` pytree (sphere
centers/radii, triangle vertices, IORs, texture colors, atlas texels) and
to camera parameters.

Because RNG is a stateless hash of (pixel, sample, bounce), this path
draws bitwise-identical sample streams to the wavefront renderer: both
produce the same image for the same seed.

Gradient semantics (SURVEY.md §7.7):
- discrete choices (which primitive is hit, reflect-vs-refract, front
  face, absorb) are piecewise-constant: gradients flow through the
  *continuous* quantities (t, point, normal, uv, attenuation) at fixed
  topology; visibility/silhouette terms come from the edge factors
  (``edge_eps``, edge_grad.py) and the stochastic Fresnel branch from
  the REINFORCE score (``branch_grad``).
- all masked branches use "double-where" guards so no NaN/Inf from
  inactive lanes poisons the backward pass.
"""

from __future__ import annotations


import jax
import jax.numpy as jnp

from zraytrace_tpu import camera as cam
from zraytrace_tpu import materials as mat
from zraytrace_tpu import rng as zrng
from zraytrace_tpu.render import background_color, trace_closest
from zraytrace_tpu.scene import Scene


def trace_paths(
    scene: Scene,
    camera: cam.Camera,
    pixel_ids: jnp.ndarray,  # (N,) int32
    sample_ids: jnp.ndarray,  # (N,) int32
    seed,
    width,
    height,
    max_depth: int,  # static: scan trip count
    bilinear_textures: bool = True,
    remat: bool = True,
    edge_eps: float | None = None,
    edge_occlusion: bool | str = True,
    mesh_fast: bool | None = None,
    branch_grad: bool = False,
    score_baseline=None,
    edge_screen: bool | None = None,
):
    """Radiance of one path per lane, ``(N, 3)``.

    ``max_depth`` is static (it is the scan length); everything else is
    traced. ``bilinear_textures`` defaults on — nearest-neighbor lookups
    have zero gradient w.r.t. the hit position.

    ``edge_eps``: when set, multiply the throughput each bounce by the
    edge_grad factor — forward-identical (factor == 1.0) but the
    backward pass gains silhouette/visibility gradients with relative
    bandwidth ``edge_eps`` (see edge_grad.py). Replaces the round-1
    finite-difference hybrid for coverage terms.

    ``mesh_fast``: route triangles through the winner-recompute split
    (diff_trace.py) — the stop-gradient winner pass plus an O(N)
    differentiable recompute on the winning triangle, instead of
    differentiating the brute O(N*T) scan. Gradients are identical at
    fixed topology (tests/test_diff_mesh.py); default auto: on when the
    scene has >= 64 triangles.

    ``branch_grad``: REINFORCE gradient for the stochastic Fresnel
    branch (material.zig:117). The per-bounce branch log-probabilities
    (materials.scatter, variance-isolated to ``mat_ior``) accumulate
    along each path; at path termination the radiance gains the
    forward-zero term ``(stop(R) - b) * (score - stop(score))`` whose
    backward pass is the baseline-subtracted score-function estimator
    ``(R - b) d log P / d ior``. Zero-radiance terminations (absorb,
    depth exhaustion) contribute their ``-b * d log P`` term too — the
    estimator is unbiased only with them included.

    ``score_baseline``: per-lane ``(N, 3)`` control variate ``b``
    (stop-gradded inside). Any value independent of this sample's
    randomness keeps the estimator unbiased; ``render_diff`` feeds the
    running mean of the pixel's previous samples, which removes the
    DC component of the radiance that dominated the round-3 variance
    (GRAD_REPORT ior 33%). None = 0 (plain REINFORCE).
    """
    width = jnp.asarray(width, jnp.int32)
    fw = jnp.asarray(width, jnp.float32)
    fh = jnp.asarray(height, jnp.float32)
    px = (pixel_ids % width).astype(jnp.float32)
    py = (pixel_ids // width).astype(jnp.float32)

    j = zrng.uniform4(seed, pixel_ids, sample_ids, 0, zrng.STREAM_CAMERA)
    u, v = cam.pixel_uv(px, py, j[:, 0], j[:, 1], fw, fh)
    o, d = cam.get_rays(camera, u, v)

    n = pixel_ids.shape[0]
    init = dict(
        o=o,
        d=d,
        throughput=jnp.ones((n, 3), jnp.float32),
        radiance=jnp.zeros((n, 3), jnp.float32),
        alive=jnp.ones((n,), bool),
    )
    # the amp carry rides with EDGE factors, not with branch_grad: the
    # refraction-amplified bandwidths (the round-4 lensed-silhouette
    # fix) must apply whenever edge_eps is on, or toggling branch_grad
    # would change geometry/camera gradients and break the isolation
    # claim (materials.scatter docstring)
    want_amp = edge_eps is not None
    if branch_grad or want_amp:
        # per-ray edge-bandwidth amplification (edge_grad.edge_factor
        # eps_scale): product of refraction angular magnifications,
        # reset by diffuse bounces
        init["amp"] = jnp.ones((n,), jnp.float32)
    if branch_grad:
        init["score"] = jnp.zeros((n,), jnp.float32)
        baseline = (jnp.zeros((n, 3), jnp.float32) if score_baseline is None
                    else jax.lax.stop_gradient(score_baseline))

    fast = mesh_fast if mesh_fast is not None else scene.n_triangles >= 64
    if fast and scene.n_triangles > 0:
        from zraytrace_tpu.diff_trace import trace_closest_diff

        trace = trace_closest_diff
    else:
        trace = trace_closest

    def bounce(state, depth_idx):
        h = trace(scene, state["o"], state["d"])
        throughput = state["throughput"]
        if edge_eps is not None:
            from zraytrace_tpu.edge_grad import edge_factor

            # edge_occlusion: True (every bounce), False, or "camera"
            # (t-crossing term on primary segments only — bounce rays'
            # internal crossings add variance that swamps the pose
            # signal at mesh scale; VERDICT round-3 item 7)
            occ_w = None
            occ_on = bool(edge_occlusion)
            if edge_occlusion == "camera":
                occ_w = (depth_idx == 0).astype(jnp.float32)
            f = edge_factor(scene, state["o"], state["d"], h, edge_eps,
                            occlusion=occ_on,
                            eps_scale=state.get("amp"),
                            occ_weight=occ_w, screen=edge_screen)
            throughput = throughput * jnp.where(
                state["alive"], f, 1.0)[:, None]
        rnd = zrng.uniform4(seed, pixel_ids, sample_ids, depth_idx, zrng.STREAM_SCATTER)
        out = mat.scatter(
            scene, state["d"], h["normal"], h["front_face"], h["uv"], h["mat_id"],
            rnd, bilinear_textures=bilinear_textures,
            branch_grad=branch_grad or want_amp,
        )
        new_dir, atten, absorbed = out[:3]
        alive = state["alive"]
        miss = alive & ~h["hit"]
        scattered = alive & h["hit"] & ~absorbed

        contrib = jnp.where(
            miss[:, None], throughput * background_color(state["d"]), 0.0
        )
        radiance = state["radiance"] + contrib
        sc3 = scattered[:, None]
        new_state = dict(
            o=jnp.where(sc3, h["point"], state["o"]),
            d=jnp.where(sc3, new_dir, state["d"]),
            throughput=jnp.where(sc3, throughput * atten, throughput),
            radiance=radiance,
            alive=scattered,
        )
        if branch_grad:
            # score at this bounce's terminations excludes this bounce's
            # branch (termination and a dielectric scatter are mutually
            # exclusive), so masking by `scattered` makes the order moot
            score = state["score"] + jnp.where(scattered, out[3], 0.0)
            score0 = (score - jax.lax.stop_gradient(score))[:, None]
            died = alive & h["hit"] & absorbed
            # terminal REINFORCE terms (docstring): forward-exact zero
            reinforce = (
                jnp.where(miss[:, None],
                          jax.lax.stop_gradient(contrib) - baseline, 0.0)
                - jnp.where(died[:, None], baseline, 0.0)
            ) * score0
            new_state["radiance"] = radiance + reinforce
            new_state["score"] = score
        if branch_grad or want_amp:
            # bandwidth amp carry: 0 marks a diffuse bounce (reset)
            mul = out[4]
            amp2 = jnp.where(mul == 0.0, 1.0,
                             jnp.minimum(state["amp"] * mul, 32.0))
            new_state["amp"] = jnp.where(scattered, amp2, state["amp"])
        return new_state, None

    if remat:
        # save the edge-selection indices across the checkpoint (tiny
        # i32 planes, tagged in edge_grad) so the backward pass does
        # not re-run the O(rays x triangles) selection scan; everything
        # else rematerializes as before
        bounce = jax.checkpoint(
            bounce,
            policy=jax.checkpoint_policies.save_only_these_names(
                "edge_sel_idx"))
    final, _ = jax.lax.scan(bounce, init, jnp.arange(max_depth, dtype=jnp.int32))
    # Paths still alive after max_depth bounces contribute black
    # (raytrace.zig:64-67) — radiance already excludes them.
    radiance = final["radiance"]
    if branch_grad:
        # depth-exhausted paths terminate with R = 0: their -b * d logP
        # term still belongs in the estimator
        score0 = (final["score"]
                  - jax.lax.stop_gradient(final["score"]))[:, None]
        radiance = radiance - jnp.where(
            final["alive"][:, None], baseline, 0.0) * score0
    return radiance


def render_diff(
    scene: Scene,
    camera: cam.Camera,
    width: int,
    height: int,
    spp: int,
    max_depth: int,
    seed=42,
    sample_start=0,
    bilinear_textures: bool = True,
    edge_eps: float | None = None,
    edge_occlusion: bool | str = True,
    mesh_fast: bool | None = None,
    branch_grad: bool = True,
    edge_screen: bool | None = None,
):
    """Differentiable image ``(H, W, 3)``: mean over ``spp`` paths/pixel.

    Samples are laid out as a leading axis and scanned so the live lane
    count stays H*W; gradients accumulate across the scan.

    ``branch_grad`` (default ON since round 4 — the estimator is
    variance-isolated to ``mat_ior``, so other gradient classes are
    bit-identical either way): each sample's REINFORCE baseline is the
    running mean of the pixel's PREVIOUS samples — independent of the
    current sample's randomness, hence unbiased, and free (the
    stop-gradded radiance totals ride the existing sample scan).
    Forward images are bit-identical with it on or off.
    """
    n = width * height
    pixel_ids = jnp.arange(n, dtype=jnp.int32)

    def one_spp(carry, s):
        total, stop_total, count = carry
        if branch_grad:
            b = stop_total / jnp.maximum(count, 1.0)
        else:
            b = None
        r = trace_paths(
            scene, camera, pixel_ids, jnp.full((n,), s, jnp.int32),
            seed, width, height, max_depth, bilinear_textures,
            edge_eps=edge_eps, edge_occlusion=edge_occlusion,
            mesh_fast=mesh_fast, branch_grad=branch_grad, score_baseline=b,
            edge_screen=edge_screen,
        )
        return (total + r, stop_total + jax.lax.stop_gradient(r),
                count + 1.0), None

    (total, _, _), _ = jax.lax.scan(
        one_spp,
        (jnp.zeros((n, 3), jnp.float32), jnp.zeros((n, 3), jnp.float32),
         jnp.float32(0.0)),
        jnp.arange(spp, dtype=jnp.int32) + jnp.asarray(sample_start, jnp.int32),
    )
    return (total / spp).reshape(height, width, 3)
