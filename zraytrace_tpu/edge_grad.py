"""Edge-aware (silhouette) gradients for inverse rendering.

The scan renderer's analytic reverse-mode gradients flow through the
continuous quantities of a FIXED hit topology (t, normal, uv,
attenuation) — they carry no signal for *visibility*: moving a sphere
changes which rays hit it, a discontinuous integrand whose derivative
lives on silhouette boundaries (SURVEY.md §7.7). Round 1 bridged this
with correlated finite differences (2 renders per scalar,
inverse.fd_gradients) — unusable for vertex arrays.

This module implements the standard smoothed-indicator estimator of the
boundary term: per bounce, compute the *signed relative silhouette
margin* ``m`` of the decisive boundary —

- ray hits a sphere:    m = disc / (2 r^2)  (≈ (r - d_perp)/r > 0)
- ray hits a triangle:  m = min(u, v, 1-u-v)  (barycentric edge margin)
- ray misses:           m = -(distance to the nearest silhouette it
                         almost hit), the max margin over near-missed
                         primitives in front of the hit/sky

— and multiplies the path throughput by ``w / stop_grad(w)`` with
``w = sigmoid(m / eps)`` for hit rays and ``(1-w)/stop_grad(1-w)`` for
miss rays. The factor is exactly 1.0 in the forward pass (images are
unchanged bit for bit); in the backward pass it contributes
``d log w = sigmoid'(m/eps) dm / eps`` — rays within ~eps of a
silhouette push its boundary with the correct sign and weight on both
sides, which is a consistent O(eps)-biased estimate of the boundary
integral (the soft-rasterizer / relaxed-visibility construction).

Occlusion boundaries between two overlapping primitives (t-crossings)
are modeled the same way (round 3): the decisive quantity is the
relative second-hit margin ``m_occ = (t2 - t1)/t2`` with ``t2`` the
nearest intersection of any OTHER primitive behind the winner — the
boundary where the winner changes is ``t1 = t2``, so hit rays multiply
an additional ``sigmoid(m_occ/eps)`` relaxed-visibility factor (each
side of the crossing pushes with its own shading, the same
construction as the silhouette term).

``eps`` may be a tuple of bandwidths: the factor becomes the geometric
mean of the per-bandwidth factors, so the gradient is the plain mean —
the two-bandwidth averaging that cancels most of the O(eps) smoothing
bias (previously hand-rolled in tests) lives in the library.

Bandwidth guidance (measured, round 3): sphere margins are accurate at
eps=(0.01, 0.02) (<=5% vs FD); triangle barycentric margins bias
superlinearly past ~0.01 and want eps=(0.005, 0.01) (<=4%); the
occlusion sigmoid runs at eps*OCC_EPS_SCALE internally.
"""

from __future__ import annotations

import os as _os

import jax
import jax.numpy as jnp
import numpy as np

from zraytrace_tpu import vecmath as vm
from zraytrace_tpu.scene import Scene

_BIG = np.float32(3.4e38)

# Margins are relative (sphere: fraction of radius; triangle:
# barycentric), so one bandwidth serves both primitive types.
DEFAULT_EDGE_EPS = 0.01

# SCREEN-SPACE margins (round 5, verdict item 3): relative margins give
# every primitive the same band in ITS OWN units, so the effective
# geometric band width varies with triangle shape and viewing distance
# — at mid-range (teapot scale 0.5) the mix of wide and narrow
# effective bands biases the pose gradient (cos vs exact FD +0.61,
# y-axis sign flipped). Screen mode divides
# each margin by its sweep speed: triangles use the true geometric
# distance to the nearest edge (barycentric x edge height, from
# |fn| = 2*Area) and spheres the geometric limb distance (m_rel * r),
# both divided by the candidate's own t — an ANGULAR margin, so eps
# becomes an angular bandwidth uniform across the image (the classical
# soft-rasterizer normalization). Forward images are unchanged either
# way (the factor is exactly 1.0); only the backward weighting moves.
_SCREEN = _os.environ.get("ZRAYTRACE_EDGE_SCREEN", "0") == "1"

# Boundary-kernel choice (round 5): "log" (default) is the shipped
# d log sigma construction; "exact" uses per-side exp(+-2 sigma(z))
# factors whose backward kernels 2 sigma'(z) integrate to EXACTLY 1
# per side (the log kernel's integrate to ln 2 — see the normalization
# note in edge_factor). Measured trade-offs in PERF.md round 5.
_KERNEL = _os.environ.get("ZRAYTRACE_EDGE_KERNEL", "log")
# Exclude a convex sphere's own near-miss margin for rays originating
# on its surface (see the _NOSELF note at the sphere near mask).
_NOSELF = _os.environ.get("ZRAYTRACE_EDGE_NOSELF", "0") == "1"

# Meshes with at least this many triangles run the near-miss/occlusion
# search as a stop-gradient selection plus a per-ray recompute (see
# SELECT-RECOMPUTE in silhouette_margin); smaller ones differentiate the
# dense scan directly.
SELECT_MIN_TRIANGLES = 64


def silhouette_margin(scene: Scene, o, d, h, t_min=1e-3,
                      tri_chunk: int = 512, screen: bool | None = None):
    """Signed relative silhouette margin per ray plus the occlusion
    (second-hit) margin and the near-miss margin: returns ``(margin
    (N,), occ_margin (N,), near_margin (N,))``.

    ``h`` is the hit dict from ``trace_closest`` (hit, t, uv, mat_id...).
    ``margin`` is positive for hit rays (interior margin of the winning
    primitive), negative for miss rays (margin of the nearest
    near-missed silhouette in front of the eventual hit).

    ``near_margin`` is the near-miss margin for EVERY ray (equal to
    ``margin`` on miss rays): the best margin among primitives the ray
    passed close to IN FRONT of its winner (or in front of the sky).
    Hit rays need it too — a silhouette against a BACKDROP OBJECT
    (sphere edge over the ground, anything seen through a refracting
    lens) has its miss side land on the backdrop as a hit, and a
    boundary estimator that only pushes from the on-silhouette side
    measures roughly half the term (round-4 fix; the sky-backed
    classes in GRAD_REPORT were two-sided all along, which is why they
    verified while ior/lensed boundaries sat at ~35%).

    ``occ_margin = (t2 - t1)/t2`` with ``t2`` the nearest intersection
    of any OTHER primitive behind the winner (the t-crossing boundary
    where the winner would change); large (1.0) when nothing else is
    behind. Both are differentiable w.r.t. sphere centers/radii and
    triangle vertices through the recomputation. The winner's own
    candidate is excluded by a 1e-5 relative guard (its recomputed t
    can differ from ``h['t']`` by ulps) — a band far narrower than any
    useful ``eps``.
    """
    screen = _SCREEN if screen is None else bool(screen)
    n = o.shape[0]
    hit = h["hit"]
    # near-misses only matter if their (would-be) intersection lies in
    # front of what the ray actually hit
    t_cap = jnp.where(hit, h["t"], _BIG)
    # occlusion candidates: strictly behind the winner
    t_first = jnp.where(hit, h["t"], _BIG)
    t_excl = t_first * jnp.float32(1.0 + 1e-5)
    t_occ = jnp.full((n,), _BIG)

    margin_hit_sph = jnp.zeros((n,), jnp.float32)
    t_best = jnp.full((n,), _BIG)
    miss_margin = jnp.full((n,), -jnp.inf)

    if scene.n_spheres > 0:
        o_dot_d = vm.dot(o, d)
        o_sq = vm.length_squared(o)
        for s in range(scene.sph_center.shape[0]):
            c = scene.sph_center[s]
            r = scene.sph_radius[s]
            half_b = o_dot_d - d @ c
            cc = o_sq - 2.0 * (o @ c) + (c @ c - r * r)
            disc = half_b * half_b - cc
            m = disc / (2.0 * r * r + 1e-12)
            pos = disc > 0.0
            root = jnp.where(pos, jnp.sqrt(jnp.where(pos, disc, 1.0)), 0.0)
            t1 = -half_b - root
            t2 = -half_b + root
            ok1 = (t1 > t_min) & (t1 < _BIG)
            ok2 = (t2 > t_min) & (t2 < _BIG)
            t = jnp.where(ok1, t1, t2)
            valid = (disc >= 0.0) & (ok1 | ok2)
            better = valid & (t < t_best)
            if screen:
                # angular margin: geometric limb distance (m * r) over
                # the candidate's own distance (hit t / tangency point)
                m_hit_s = m * r / jnp.maximum(jnp.where(valid, t, 1.0),
                                              t_min)
                m_near_s = m * r / jnp.maximum(-half_b, t_min)
            else:
                m_hit_s = m_near_s = m
            t_best = jnp.where(better, t, t_best)
            margin_hit_sph = jnp.where(better, m_hit_s, margin_hit_sph)
            # near miss: tangency point (-half_b) in front, before t_cap
            near = (disc < 0.0) & (-half_b > t_min) & (-half_b < t_cap)
            if _NOSELF:
                # EXPERIMENT (round 5, env ZRAYTRACE_EDGE_NOSELF): a
                # ray ORIGINATING ON a convex sphere can never re-hit
                # it — its own near-miss margin has no boundary to
                # estimate (hit/miss topology never flips), only the
                # quadratic-tangency mass that breaks the linear
                # kernel calibration. cc = |o-c|^2 - r^2 ~ 0 exactly
                # for surface origins; genuinely nearby origins (other
                # geometry next to the sphere) keep cc >> the f32
                # tolerance.
                near = near & (cc > 1e-4 * r * r)
            miss_margin = jnp.maximum(miss_margin,
                                      jnp.where(near, m_near_s, -jnp.inf))
            # occlusion candidate: this sphere's nearest root behind
            # the ray's winner (the winner itself fails the guard)
            occ = valid & (t > t_excl)
            t_occ = jnp.minimum(t_occ, jnp.where(occ, t, _BIG))

    # the scene winner is a triangle iff its t beats every sphere's
    hit_is_tri = hit & (h["t"] < t_best) & (scene.n_triangles > 0)
    if scene.n_triangles > 0:
        u = h["uv"][:, 0]
        v = h["uv"][:, 1]
        margin_hit_tri = jnp.minimum(jnp.minimum(u, v), 1.0 - u - v)

        # near-missed triangles: valid front-facing plane crossing in
        # front of t_cap but outside the barycentric interior
        from zraytrace_tpu.geometry.triangle import (
            DET_EPS, pack_triangles,
        )

        T = scene.tri_a.shape[0]
        n_chunks = -(-T // tri_chunk)
        pad = n_chunks * tri_chunk - T
        pad3 = lambda x: jnp.concatenate(
            [x, jnp.zeros((pad, 3), x.dtype)], axis=0)
        pack = pack_triangles(pad3(scene.tri_a), pad3(scene.tri_b),
                              pad3(scene.tri_c))
        pack_r = jax.tree_util.tree_map(
            lambda x: x.reshape((n_chunks, tri_chunk) + x.shape[1:]), pack)
        oxd = vm.cross(o, d)

        def body(i, carry):
            mm, tocc, mwin = carry
            p = jax.tree_util.tree_map(lambda x: x[i], pack_r)
            det = -(d @ p.fn.T)
            safe = jnp.abs(det) > 1e-12
            inv_det = 1.0 / jnp.where(safe, det, 1.0)
            uu = (oxd @ p.e2.T - d @ p.e2xa.T) * inv_det
            vv = -(oxd @ p.e1.T - d @ p.e1xa.T) * inv_det
            tt = (o @ p.fn.T - p.a_dot_fn[None, :]) * inv_det
            m = jnp.minimum(jnp.minimum(uu, vv), 1.0 - uu - vv)
            if screen:
                # geometric edge distances: barycentric x edge height
                # (|fn| = 2*Area; height over edge e = |fn| / |e|),
                # over the candidate's own distance -> angular margin
                fl = jnp.sqrt(jnp.sum(p.fn * p.fn, -1))
                hu = fl / jnp.maximum(
                    jnp.sqrt(jnp.sum(p.e2 * p.e2, -1)), 1e-12)
                hv = fl / jnp.maximum(
                    jnp.sqrt(jnp.sum(p.e1 * p.e1, -1)), 1e-12)
                ew = p.e2 - p.e1
                hw = fl / jnp.maximum(
                    jnp.sqrt(jnp.sum(ew * ew, -1)), 1e-12)
                m_s = jnp.minimum(
                    jnp.minimum(uu * hu[None, :], vv * hv[None, :]),
                    (1.0 - uu - vv) * hw[None, :],
                ) / jnp.maximum(jnp.abs(tt), t_min)
            else:
                m_s = m
            # NOTE tt < t_cap is deliberate (round-5 measured): a
            # 1e-5 guard symmetric to the occlusion one was tried and
            # REVERTED — candidates at tt ~ t_cap include genuine
            # contact-line silhouettes (an occluder edge against the
            # surface right behind it, e.g. the teapot spout at
            # mid-range), and excluding them dropped the pose-grad
            # cosine 0.92 -> 0.65.
            near = ((det >= DET_EPS) & (tt > t_min)
                    & (tt < t_cap[:, None]) & (m < 0.0))
            m_near = jnp.max(jnp.where(near, m_s, -jnp.inf), axis=-1)
            # occlusion candidate: interior crossing behind the winner
            occ = ((det >= DET_EPS) & (m >= 0.0)
                   & (tt > t_excl[:, None]))
            t_near = jnp.min(jnp.where(occ, tt, _BIG), axis=-1)
            if screen:
                # recover the WINNER's screen margin (the hit dict has
                # only uv): the interior candidate whose t matches the
                # ray's winner within the 1e-5 relative guard
                winm = ((det >= DET_EPS) & (m >= 0.0)
                        & (tt > t_min) & (tt <= t_excl[:, None])
                        & (tt >= (t_first * (1.0 - 1e-5))[:, None]))
                m_w = jnp.max(jnp.where(winm, m_s, -jnp.inf), axis=-1)
                mwin = jnp.maximum(mwin, m_w)
            return jnp.maximum(mm, m_near), jnp.minimum(tocc, t_near), mwin

        # SELECT-RECOMPUTE: the brute chunk loop above is
        # O(rays x triangles) PER BOUNCE, and its reverse-mode transpose
        # is as large again at mesh scale. But the gradient of a max
        # (near-miss margin) / min (occlusion t) flows only through the
        # ARG element — so at mesh scale the loop runs once under
        # stop_gradient tracking ARGMAX/ARGMIN indices, and the margin
        # is recomputed differentiably for just the selected triangle
        # per ray (the winner-recompute pattern of diff_trace). Values
        # are identical (same selected triangle, same formulas);
        # gradients are identical because max/min subgradients already
        # flow through the arg alone.
        if T >= SELECT_MIN_TRIANGLES:
            sg = jax.lax.stop_gradient

            def body_sel(i, carry):
                mm, mi, tocc, ti_, mw, wi = carry
                p = jax.tree_util.tree_map(lambda x: sg(x[i]), pack_r)
                o_, d_, oxd_ = sg(o), sg(d), sg(oxd)
                det = -(d_ @ p.fn.T)
                safe = jnp.abs(det) > 1e-12
                inv_det = 1.0 / jnp.where(safe, det, 1.0)
                uu = (oxd_ @ p.e2.T - d_ @ p.e2xa.T) * inv_det
                vv = -(oxd_ @ p.e1.T - d_ @ p.e1xa.T) * inv_det
                tt = (o_ @ p.fn.T - p.a_dot_fn[None, :]) * inv_det
                m = jnp.minimum(jnp.minimum(uu, vv), 1.0 - uu - vv)
                if screen:
                    fl = jnp.sqrt(jnp.sum(p.fn * p.fn, -1))
                    hu = fl / jnp.maximum(
                        jnp.sqrt(jnp.sum(p.e2 * p.e2, -1)), 1e-12)
                    hv = fl / jnp.maximum(
                        jnp.sqrt(jnp.sum(p.e1 * p.e1, -1)), 1e-12)
                    ew = p.e2 - p.e1
                    hw = fl / jnp.maximum(
                        jnp.sqrt(jnp.sum(ew * ew, -1)), 1e-12)
                    m_s = jnp.minimum(
                        jnp.minimum(uu * hu[None, :], vv * hv[None, :]),
                        (1.0 - uu - vv) * hw[None, :],
                    ) / jnp.maximum(jnp.abs(tt), t_min)
                else:
                    m_s = m
                near = ((det >= DET_EPS) & (tt > t_min)
                        & (tt < sg(t_cap)[:, None]) & (m < 0.0))
                mloc = jnp.where(near, m_s, -jnp.inf)
                aj = jnp.argmax(mloc, axis=-1)
                av = jnp.take_along_axis(mloc, aj[:, None], -1)[:, 0]
                bet = av > mm
                mm = jnp.where(bet, av, mm)
                mi = jnp.where(bet, i * tri_chunk + aj, mi)
                occ = ((det >= DET_EPS) & (m >= 0.0)
                       & (tt > sg(t_excl)[:, None]))
                tloc = jnp.where(occ, tt, _BIG)
                oj = jnp.argmin(tloc, axis=-1)
                ov = jnp.take_along_axis(tloc, oj[:, None], -1)[:, 0]
                bet2 = ov < tocc
                tocc = jnp.where(bet2, ov, tocc)
                ti_ = jnp.where(bet2, i * tri_chunk + oj, ti_)
                if screen:
                    winm = ((det >= DET_EPS) & (m >= 0.0)
                            & (tt > t_min) & (tt <= sg(t_excl)[:, None])
                            & (tt >= (sg(t_first)
                                      * (1.0 - 1e-5))[:, None]))
                    wloc = jnp.where(winm, m_s, -jnp.inf)
                    wj = jnp.argmax(wloc, axis=-1)
                    wv = jnp.take_along_axis(wloc, wj[:, None], -1)[:, 0]
                    bet3 = wv > mw
                    mw = jnp.where(bet3, wv, mw)
                    wi = jnp.where(bet3, i * tri_chunk + wj, wi)
                return mm, mi, tocc, ti_, mw, wi

            neg1 = jnp.full((n,), -1, jnp.int32)
            ninf = jnp.full((n,), -jnp.inf)
            _, mi, _, ti_, _, wi = jax.lax.fori_loop(
                0, n_chunks, body_sel,
                (ninf, neg1, jnp.full((n,), _BIG), neg1, ninf, neg1))
            # name the indices so render_diff's remat policy can SAVE
            # them: without this the bounce checkpoint re-runs the
            # whole selection scan in the backward pass (the scan is
            # the dominant forward term at mesh scale; the indices are
            # 3 small i32 planes)
            from jax.ad_checkpoint import checkpoint_name

            mi = checkpoint_name(mi, "edge_sel_idx")
            ti_ = checkpoint_name(ti_, "edge_sel_idx")
            wi = checkpoint_name(wi, "edge_sel_idx")

            def recompute(idx):
                """Differentiable margin of ONE selected triangle per
                ray — same formulas as the brute loop, row-wise."""
                j = jnp.maximum(idx, 0)
                fn = pack.fn[j]
                e1 = pack.e1[j]
                e2 = pack.e2[j]
                e2xa = pack.e2xa[j]
                e1xa = pack.e1xa[j]
                adf = pack.a_dot_fn[j]
                det = -jnp.sum(d * fn, -1)
                safe = jnp.abs(det) > 1e-12
                inv_det = 1.0 / jnp.where(safe, det, 1.0)
                uu = (jnp.sum(oxd * e2, -1)
                      - jnp.sum(d * e2xa, -1)) * inv_det
                vv = -(jnp.sum(oxd * e1, -1)
                       - jnp.sum(d * e1xa, -1)) * inv_det
                tt = (jnp.sum(o * fn, -1) - adf) * inv_det
                if screen:
                    fl = jnp.sqrt(jnp.sum(fn * fn, -1))
                    hu = fl / jnp.maximum(
                        jnp.sqrt(jnp.sum(e2 * e2, -1)), 1e-12)
                    hv = fl / jnp.maximum(
                        jnp.sqrt(jnp.sum(e1 * e1, -1)), 1e-12)
                    ew = e2 - e1
                    hw = fl / jnp.maximum(
                        jnp.sqrt(jnp.sum(ew * ew, -1)), 1e-12)
                    m_s = jnp.minimum(
                        jnp.minimum(uu * hu, vv * hv),
                        (1.0 - uu - vv) * hw,
                    ) / jnp.maximum(jnp.abs(tt), t_min)
                else:
                    m_s = jnp.minimum(jnp.minimum(uu, vv),
                                      1.0 - uu - vv)
                return m_s, tt

            m_near_t, _ = recompute(mi)
            miss_margin = jnp.maximum(
                miss_margin, jnp.where(mi >= 0, m_near_t, -jnp.inf))
            _, t_occ_t = recompute(ti_)
            t_occ = jnp.minimum(
                t_occ, jnp.where(ti_ >= 0, t_occ_t, _BIG))
            if screen:
                m_win_t, _ = recompute(wi)
                margin_hit_tri = jnp.where(
                    wi >= 0, m_win_t, margin_hit_tri)
        else:
            miss_margin, t_occ, m_win_scr = jax.lax.fori_loop(
                0, n_chunks, body,
                (miss_margin, t_occ, jnp.full((n,), -jnp.inf)))
            if screen:
                # fall back to the relative margin if the guard missed
                # (ulp-level t mismatch): better a slightly off scale
                # than a -inf margin
                margin_hit_tri = jnp.where(
                    m_win_scr > -jnp.inf, m_win_scr, margin_hit_tri)
    else:
        margin_hit_tri = jnp.zeros((n,), jnp.float32)

    margin_hit = jnp.where(hit_is_tri, margin_hit_tri, margin_hit_sph)
    # rays that near-missed nothing: margin -inf -> sigmoid weight 0 and
    # zero gradient; clamp to a large negative instead of -inf so the
    # backward pass stays NaN-free
    miss_margin = jnp.maximum(miss_margin, -1e3)
    # occlusion margin: relative t gap to the second hit; 1.0 (far from
    # any crossing, zero gradient) when nothing is behind or on miss
    has_occ = hit & (t_occ < _BIG)
    occ_margin = jnp.where(
        has_occ,
        (t_occ - t_first) / jnp.where(has_occ, t_occ, 1.0),
        1.0,
    )
    return (jnp.where(hit, margin_hit, miss_margin), occ_margin,
            miss_margin)


# The occlusion margin is a relative-t gap: near a grazing t-crossing
# the same screen-space boundary band maps to a much NARROWER t band
# than a silhouette's, so the occlusion sigmoid needs a tighter
# bandwidth. Measured on the two-overlapping-spheres probe (round 3):
# occ bandwidth eps/1 overshoots the FD crossing term 2.5x; eps/8
# lands within ~6% (converging monotonically as the band shrinks).
OCC_EPS_SCALE = 0.125


def edge_factor(scene: Scene, o, d, h, eps=DEFAULT_EDGE_EPS,
                t_min=1e-3, occlusion: bool = True, eps_scale=None,
                occ_weight=None, screen: bool | None = None):
    """Per-ray multiplicative factor: exactly 1.0 forward, silhouette +
    occlusion gradients backward. Multiply into path throughput each
    bounce.

    ``eps``: relative bandwidth, or a tuple of bandwidths — the factor
    is the geometric mean over bandwidths, so the backward pass is the
    plain mean of the per-bandwidth gradients (bias cancellation). The
    occlusion term uses ``eps * OCC_EPS_SCALE`` per bandwidth.

    Hit rays carry TWO sigmoid terms (round 4): their winner's interior
    margin AND the complement of their best in-front near-miss margin,
    so a silhouette whose far side lands on a backdrop object (ground
    behind a sphere edge, geometry seen through a lens) pushes from
    both sides — see silhouette_margin's ``near_margin`` docstring.
    A hit ray that near-missed nothing has near_margin ~ -1e3, weight
    exactly 1, zero gradient — sky-backed boundaries are unchanged.

    ``eps_scale``: optional per-ray (N,) bandwidth multiplier
    (stop-gradded), carried by render_diff as the product of angular
    magnifications of the refractions the path went through
    (materials.scatter amp_mul). A silhouette seen through near-grazing
    refraction sweeps so fast per unit upstream change that no sample
    lands inside an UNSCALED band — the estimator silently drops the
    whole boundary (the ior "lensed ring" gap, PERF.md round 4). The
    widened band trades O(eps * amp) smoothing bias for actually
    sampling the boundary, the same trade the FD pairing makes."""
    m, m_occ, m_near = silhouette_margin(scene, o, d, h, t_min=t_min,
                                         screen=screen)
    eps_list = tuple(eps) if isinstance(eps, (tuple, list)) else (eps,)
    scale = 1.0 if eps_scale is None else jax.lax.stop_gradient(eps_scale)
    log_w = jnp.zeros_like(m)
    for e0 in eps_list:
        e = e0 * scale
        if _KERNEL == "exact":
            # per-side-exact kernels: hit rays +2*sigma(m/e), miss
            # rays -2*sigma(m_near/e) (m == m_near there), hit rays'
            # backdrop complement -2*sigma(m_near/e), occlusion
            # +2*sigma(m_occ/(e*OCC)); backward kernels 2*sigma'
            # integrate to 1 per side
            s_hit = 2.0 * jax.nn.sigmoid(m / e)
            s_near = 2.0 * jax.nn.sigmoid(m_near / e)
            lg = jnp.where(h["hit"], s_hit - s_near, -s_near)
            if occlusion:
                so = 2.0 * jax.nn.sigmoid(m_occ / (e * OCC_EPS_SCALE))
                occ_lg = jnp.where(h["hit"], so, 0.0)
                if occ_weight is not None:
                    occ_lg = occ_lg * occ_weight
                lg = lg + occ_lg
            log_w = log_w + lg
            continue
        w = jax.nn.sigmoid(m / e)
        near_c = jnp.maximum(1.0 - jax.nn.sigmoid(m_near / e), 1e-6)
        # miss rays: m == m_near, factor (1 - w) as before; hit rays:
        # interior w TIMES the near-miss complement
        wh = jnp.where(h["hit"], jnp.maximum(w, 1e-6) * near_c, near_c)
        lg = jnp.log(wh)
        if occlusion:
            wo = jnp.maximum(
                jax.nn.sigmoid(m_occ / (e * OCC_EPS_SCALE)), 1e-6)
            occ_lg = jnp.where(h["hit"], jnp.log(wo), 0.0)
            if occ_weight is not None:
                # traced gate (e.g. camera-segments-only): scales the
                # occlusion GRADIENT; the factor stays exactly 1.0
                # forward either way
                occ_lg = occ_lg * occ_weight
            lg = lg + occ_lg
        log_w = log_w + lg
    log_w = log_w / len(eps_list)
    # KERNEL NORMALIZATION NOTE (round 5, measured + derived): the
    # ratio trick backpropagates d log sigma = sigma'/sigma, whose
    # half-line integrals are ln 2 per side, NOT the 1 an exactly
    # normalized boundary kernel needs — a 1D pencil integration
    # confirms each side delivers exactly ln2 x the true boundary
    # term, and pure-lateral probes measure g/fd = 0.72 ~ ln 2
    # (black AND red spheres — shading-independent). A global 1/ln2
    # rescale was tried and REVERTED: single-bounce sky-backed
    # coverage terms (the radius class) already measure ~0.98 of FD
    # under THIS kernel — multi-bounce re-crossings and complement
    # terms compensate non-uniformly, so the constant fixed the
    # lateral classes (0.72 -> 1.04) while breaking radius
    # (0.98 -> 1.42). The principled alternative (per-side-exact
    # exp(+-2 sigma) kernels, ZRAYTRACE_EDGE_KERNEL=exact below) is
    # measured in PERF.md round 5; the log kernel stays the default
    # the shipped fits and tests are calibrated on.
    # exactly 0.0 forward (x - x), so exp == 1.0 bit-exactly
    return jnp.exp(log_w - jax.lax.stop_gradient(log_w))
