"""Branchless material megakernel.

Reference semantics: material.zig — tagged-union dispatch (material.zig:43)
over Lambertian (material.zig:71-77: normal + random unit vector), Metal
(material.zig:87-97: perfect mirror, no fuzz, absorbs if the reflection
points below the surface) and Dielectric (material.zig:109-128: Schlick
test + refract/reflect; attenuation always white).

Design: every ray evaluates all three scatter candidates with fused
elementwise math and ``jnp.where``-selects by material tag — no divergent
branches. RNG comes in as precomputed uniforms, replacing the mutable
``*Random`` the reference stores inside materials (material.zig:64,101).

Parity note: the reference's Schlick ``r0`` is NOT squared
(material.zig:126: ``r0 = (1-n)/(1+n)``, standard form squares it). We
match the reference so images compare pixel-for-pixel.
"""

from __future__ import annotations

import jax.numpy as jnp

from zraytrace_tpu import rng as zrng
from zraytrace_tpu import scene as sc
from zraytrace_tpu import vecmath as vm
from zraytrace_tpu.textures import texture_albedo


# Bandwidth of the relaxed total-internal-reflection indicator in
# ratio*sin_theta units (see scatter's branch_grad); same order as the
# geometric silhouette bandwidths in edge_grad.py.
TIR_EPS = 0.01


def schlick_reflectance(cosine, ref_ratio):
    """material.zig:125-127 (unsquared r0 — see module docstring)."""
    r0 = (1.0 - ref_ratio) / (1.0 + ref_ratio)
    return r0 + (1.0 - r0) * (1.0 - cosine) ** 5


def scatter(scene: sc.Scene, d_in, normal, front_face, uv, mat_id, rnd,
            bilinear_textures: bool = False, branch_grad: bool = False):
    """Scatter a batch of rays off their hit surfaces.

    Args:
      d_in: ``(N, 3)`` unit incoming directions.
      normal: ``(N, 3)`` unit normals already flipped against the ray
        (hit_record.zig:28-41).
      front_face: ``(N,)`` bool.
      uv: ``(N, 2)`` texture coords.
      mat_id: ``(N,)`` int32 material table indices.
      rnd: ``(N, 4)`` U[0,1) uniforms: [0:2] lambertian direction,
        [2] dielectric Fresnel test, [3] spare.
      branch_grad: score-function gradient for the stochastic Fresnel
        branch (material.zig:117). When True, a fourth return value
        ``log_w`` carries ``log P(branch taken)`` (Schlick reflectance
        or its complement, with the total-internal-reflection threshold
        sigmoid-relaxed) for dielectric lanes, zero elsewhere. The
        caller (render_diff.trace_paths) accumulates it along the path
        and adds the baseline-subtracted REINFORCE term
        ``(R - b) * d log_w`` at path termination — the unbiased,
        bandwidth-free derivative of the branch probabilities w.r.t.
        IOR. VARIANCE-ISOLATED: every input to ``log_w`` except the
        IOR itself (``cos_theta``, ``sin_theta``) is stop-gradded, so
        the score term reaches ONLY ``mat_ior`` — geometry/albedo/
        camera gradients are bit-identical with it on or off (round-4
        fix for the round-3 "adds variance to every other class"
        toggle). Off by default (the fast forward paths skip the extra
        ops); render_diff turns it on.

    Returns:
      (new_dir ``(N,3)`` unit, attenuation ``(N,3)``, absorbed ``(N,)``)
      plus ``log_w (N,)`` when ``branch_grad`` is True.
    """
    # Per-lane material attributes via one one-hot (N,M)@(M,3) contraction
    # instead of three gathers.
    from zraytrace_tpu.geometry.sphere import onehot_rows

    mtable = jnp.stack(
        [
            scene.mat_type.astype(jnp.float32),
            scene.mat_ior,
            scene.mat_tex.astype(jnp.float32),
        ],
        axis=-1,
    )
    attrs = onehot_rows(mat_id, mtable)  # (N, 3)
    mat_type = attrs[:, 0]
    ior = attrs[:, 1]
    tex_id = attrs[:, 2].astype(jnp.int32)
    albedo = texture_albedo(scene, tex_id, uv, bilinear_textures)

    # --- Lambertian (material.zig:71-77) ---
    ruv = zrng.random_unit_vector(rnd[:, 0], rnd[:, 1])
    lam_dir = normal + ruv
    # Degenerate (near-zero) scatter direction falls back to the normal.
    # The reference would emit NaNs here (vector.zig:88 divide by zero);
    # the event has probability ~0 and never affects parity.
    degenerate = vm.length_squared(lam_dir) < 1e-12
    lam_dir = jnp.where(degenerate[:, None], normal, lam_dir)

    # --- Metal (material.zig:87-97) ---
    met_dir = vm.reflect(d_in, normal)
    met_absorb = vm.dot(met_dir, normal) <= 0.0

    # --- Dielectric (material.zig:109-123) ---
    ratio = jnp.where(front_face, 1.0 / ior, ior)
    cos_theta = jnp.minimum(vm.dot(-d_in, normal), 1.0)
    sin_theta = jnp.sqrt(jnp.maximum(0.0, 1.0 - cos_theta * cos_theta))
    cannot_refract = ratio * sin_theta > 1.0
    refl = schlick_reflectance(cos_theta, ratio)
    reflect_now = cannot_refract | (refl > rnd[:, 2])
    die_dir = jnp.where(
        reflect_now[:, None],
        vm.reflect(d_in, normal),
        vm.refract(d_in, normal, ratio),
    )

    # --- select by tag ---
    is_lam = (mat_type == sc.LAMBERTIAN)[:, None]
    is_met = (mat_type == sc.METAL)[:, None]
    new_dir = jnp.where(is_lam, lam_dir, jnp.where(is_met, met_dir, die_dir))
    new_dir = vm.normalize_safe(new_dir)  # Ray.init normalizes (ray.zig:11)

    white = jnp.ones_like(albedo)
    attenuation = jnp.where(is_lam | is_met, albedo, white)
    absorbed = (mat_type == sc.METAL) & met_absorb
    if not branch_grad:
        return new_dir, attenuation, absorbed

    import jax

    sg = jax.lax.stop_gradient
    # Relaxed probability of the branch taken. Two discrete decisions
    # move with IOR: the stochastic Schlick test (probability refl /
    # 1-refl — its score-function derivative is exact) and the
    # total-internal-reflection threshold ratio*sin_theta = 1
    # (material.zig:116), relaxed with a sigmoid of bandwidth TIR_EPS
    # like the silhouette margins in edge_grad.py. Combined:
    # P(reflect) = s + (1-s) R, P(refract) = (1-s)(1-R) with s the soft
    # TIR indicator. Geometry inputs (cos/sin of the incidence angle)
    # are stop-gradded — isolation, see docstring — so d log_w flows
    # through ``ratio`` (hence mat_ior) alone.
    cos_d = sg(cos_theta)
    refl_d = schlick_reflectance(cos_d, ratio)
    r_c = jnp.clip(refl_d, 1e-4, 1.0 - 1e-4)
    # sin_theta's sqrt has an infinite derivative at 0 (normal
    # incidence); it is stop-gradded anyway, but keep the guard so the
    # forward value matches the branch decision's input exactly.
    sin_g = sg(sin_theta)
    s = jax.nn.sigmoid((ratio * sin_g - 1.0) / TIR_EPS)
    w = jnp.where(reflect_now, s + (1.0 - s) * r_c,
                  (1.0 - s) * (1.0 - r_c))
    w = jnp.maximum(w, 1e-6)
    is_die = ~(mat_type == sc.LAMBERTIAN) & ~(mat_type == sc.METAL)
    log_w = jnp.where(is_die, jnp.log(w), 0.0)

    # Angular-magnification multiplier for the BANDWIDTH of downstream
    # edge factors (render_diff edge amp carry): a refraction maps an
    # incoming-direction band to an outgoing band stretched by
    # d(theta_t)/d(theta_i) = ratio * cos_i / cos_t — near-grazing exit
    # rays (cos_t -> 0) sweep enormously per unit incoming change, so a
    # silhouette seen THROUGH them needs a proportionally wider sigmoid
    # band to be sampled at all (the lensed-boundary gap, PERF.md round
    # 4). Encoding: 0 = diffuse bounce (decorrelates the mapping —
    # reset the carried product to 1), else multiply. Mirrors are 1.
    cos_t_out = jnp.sqrt(jnp.maximum(
        1.0 - ratio * ratio * (1.0 - cos_theta * cos_theta), 1e-6))
    amp_refract = jnp.clip(ratio * cos_theta / cos_t_out, 1.0, 32.0)
    amp_mul = jnp.where(is_die & ~reflect_now, amp_refract, 1.0)
    amp_mul = jnp.where(is_lam[:, 0], 0.0, amp_mul)
    amp_mul = jax.lax.stop_gradient(amp_mul)
    return new_dir, attenuation, absorbed, log_w, amp_mul
