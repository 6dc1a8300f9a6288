"""Bounding volume hierarchy: host build, flattened layout, lockstep
traversal.

Reference: bvh.zig builds a recursive pointer tree (BVHNode.init:171,
divide:129) with a 3-axes x 3-candidate-splits surface-area heuristic
(optimal_axis_divide:85-120) and traverses it recursively (hit:187-205).
The reference's own TODO asks for a flattened array layout (bvh.zig:19-20)
— this module is that design, for a vectorized device:

- build runs on the host in numpy (it is per-scene preprocessing, exactly
  like the reference's host-side build) using **binned SAH** — a strict
  upgrade of the reference's median-ish candidate splits,
- nodes are emitted in DFS preorder with **skip links** (escape indices):
  traversal needs no stack — a ray either descends to ``node + 1`` on an
  AABB hit or jumps to ``skip[node]``; all rays advance in lockstep
  vectorized gathers,
- leaves reference a contiguous range of a permuted primitive array so
  leaf tests are a short static loop of gathers.

Differentiability: traversal returns *indices only* (integers). The
caller recomputes t/u/v analytically for the chosen primitive — gradients
flow through that recomputation while the discrete search stays opaque
(the "non-differentiable argmin, differentiable value" pattern;
SURVEY.md §7.7: BVH topology is stop-gradient structure).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import jax
import jax.numpy as jnp

from zraytrace_tpu import vecmath as vm
from zraytrace_tpu.geometry.triangle import DET_EPS

_BIG = np.float32(3.4e38)  # numpy scalar: no backend init at import

LEAF_SIZE = 4
N_BINS = 16


class TriBVH(NamedTuple):
    """Flattened BVH over triangles. ``M`` nodes, ``T`` primitives.

    All arrays are static structure (int32/f32); never differentiated.
    """

    node_min: jnp.ndarray  # (M, 3) f32
    node_max: jnp.ndarray  # (M, 3) f32
    # For internal nodes: prim_count == 0. For leaves: range into
    # prim_order.
    prim_start: jnp.ndarray  # (M,) int32
    prim_count: jnp.ndarray  # (M,) int32
    skip: jnp.ndarray  # (M,) int32 escape index (M = done sentinel)
    prim_order: jnp.ndarray  # (T,) int32 permutation of triangle ids

    @property
    def n_nodes(self) -> int:
        return self.node_min.shape[0]


# ---------------------------------------------------------------------------
# Host-side build (numpy)
# ---------------------------------------------------------------------------


def build_tri_bvh(a, b, c, leaf_size: int = LEAF_SIZE) -> TriBVH:
    """Binned-SAH build over triangle vertex arrays ``(T, 3)`` each.

    Runs once per scene on the host (the analogue of the reference's
    prepare step, raytrace.zig:150; SAH upgrade per SURVEY.md §7.4).
    """
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    c = np.asarray(c, np.float64)
    T = a.shape[0]
    if T == 0:
        raise ValueError("cannot build a BVH over zero triangles")

    lo = np.minimum(np.minimum(a, b), c)
    hi = np.maximum(np.maximum(a, b), c)

    # Prefer the native (C++) builder — same algorithm, ~100x faster on
    # big meshes; numpy fallback below is always available.
    from zraytrace_tpu.native.api import build_bvh_native

    native = build_bvh_native(lo.astype(np.float32), hi.astype(np.float32),
                              leaf_size)
    if native is not None:
        nmin, nmax, pstart, pcount, skip, order = native
        return TriBVH(
            node_min=jnp.asarray(nmin),
            node_max=jnp.asarray(nmax),
            prim_start=jnp.asarray(pstart),
            prim_count=jnp.asarray(pcount),
            skip=jnp.asarray(skip),
            prim_order=jnp.asarray(order),
        )

    centroid = (lo + hi) * 0.5

    order = np.arange(T, dtype=np.int64)

    nodes_min: list[np.ndarray] = []
    nodes_max: list[np.ndarray] = []
    prim_start: list[int] = []
    prim_count: list[int] = []
    skip: list[int] = []

    def surface_area(bmin, bmax):
        d = np.maximum(bmax - bmin, 0.0)
        return 2.0 * (d[0] * d[1] + d[1] * d[2] + d[2] * d[0])

    def emit(ids: np.ndarray) -> None:
        """Append the subtree over ``ids`` (a slice of prim order) in DFS
        preorder; patch skip links afterwards."""
        node = len(nodes_min)
        bmin = lo[ids].min(axis=0)
        bmax = hi[ids].max(axis=0)
        nodes_min.append(bmin)
        nodes_max.append(bmax)
        prim_start.append(0)
        prim_count.append(0)
        skip.append(-1)

        n = len(ids)
        if n <= leaf_size:
            start = emit.cursor
            order[start : start + n] = ids
            prim_start[node] = start
            prim_count[node] = n
            emit.cursor += n
            return

        # Binned SAH over the centroid extent of the widest axes; falls
        # back to a median split when all centroids coincide.
        cmin = centroid[ids].min(axis=0)
        cmax = centroid[ids].max(axis=0)
        best = None  # (cost, axis, left_ids, right_ids)
        for axis in range(3):
            extent = cmax[axis] - cmin[axis]
            if extent <= 1e-12:
                continue
            pos = centroid[ids, axis]
            bins = np.minimum(
                ((pos - cmin[axis]) / extent * N_BINS).astype(np.int64), N_BINS - 1
            )
            counts = np.bincount(bins, minlength=N_BINS)
            # bin bounds
            bin_min = np.full((N_BINS, 3), np.inf)
            bin_max = np.full((N_BINS, 3), -np.inf)
            for bi in range(N_BINS):
                sel = bins == bi
                if counts[bi]:
                    bin_min[bi] = lo[ids[sel]].min(axis=0)
                    bin_max[bi] = hi[ids[sel]].max(axis=0)
            # prefix/suffix sweep
            lmin = np.minimum.accumulate(bin_min, axis=0)
            lmax = np.maximum.accumulate(bin_max, axis=0)
            rmin = np.minimum.accumulate(bin_min[::-1], axis=0)[::-1]
            rmax = np.maximum.accumulate(bin_max[::-1], axis=0)[::-1]
            lcount = np.cumsum(counts)
            rcount = n - lcount
            for cut in range(N_BINS - 1):
                nl, nr = lcount[cut], rcount[cut]
                if nl == 0 or nr == 0:
                    continue
                cost = nl * surface_area(lmin[cut], lmax[cut]) + nr * surface_area(
                    rmin[cut + 1], rmax[cut + 1]
                )
                if best is None or cost < best[0]:
                    left = ids[bins <= cut]
                    right = ids[bins > cut]
                    best = (cost, axis, left, right)
        if best is None:
            half = n // 2
            axis = int(np.argmax(cmax - cmin))
            srt = ids[np.argsort(centroid[ids, axis], kind="stable")]
            left, right = srt[:half], srt[half:]
        else:
            _, _, left, right = best

        emit(left)
        emit(right)
        skip[node] = len(nodes_min)  # first node after this subtree

    emit.cursor = 0
    emit(np.arange(T, dtype=np.int64))
    M = len(nodes_min)
    skip_arr = np.asarray([s if s >= 0 else M for s in skip], np.int32)
    # leaves: skip == next node in preorder == node + 1 unless subtree end
    for i in range(M):
        if prim_count[i] > 0:
            skip_arr[i] = min(i + 1, M)

    return TriBVH(
        node_min=jnp.asarray(np.asarray(nodes_min), jnp.float32),
        node_max=jnp.asarray(np.asarray(nodes_max), jnp.float32),
        prim_start=jnp.asarray(prim_start, jnp.int32),
        prim_count=jnp.asarray(prim_count, jnp.int32),
        skip=jnp.asarray(skip_arr),
        prim_order=jnp.asarray(order, jnp.int32),
    )


def bvh_depth_stats(bvh: TriBVH) -> dict:
    """Host-side sanity stats, the analogue of the reference's depth
    Tracking (bvh.zig:23-30, 'Max depth in BVH is 13')."""
    skip = np.asarray(bvh.skip)
    count = np.asarray(bvh.prim_count)
    # Iterative preorder walk: internal nodes have exactly two children at
    # node+1 and after the left subtree, so depth is tracked with an
    # explicit stack of subtree-end sentinels (no host recursion).
    max_depth = 0
    ends: list[int] = []
    for node in range(len(skip)):
        while ends and node >= ends[-1]:
            ends.pop()
        max_depth = max(max_depth, len(ends))
        if count[node] == 0:
            ends.append(int(skip[node]) if skip[node] > node else len(skip))
    return dict(
        n_nodes=len(skip),
        n_leaves=int((count > 0).sum()),
        max_depth=int(max_depth),
        max_leaf_size=int(count.max()),
    )


# ---------------------------------------------------------------------------
# Device-side traversal (lockstep, stackless)
# ---------------------------------------------------------------------------


def _slab_test(o, inv_d, bmin, bmax, t_min, t_max):
    """Vectorized slab test (aabb.zig:109-128 optimized variant): the
    per-axis swap becomes min/max of the two crossing distances."""
    t0 = (bmin - o) * inv_d
    t1 = (bmax - o) * inv_d
    near = jnp.minimum(t0, t1)
    far = jnp.maximum(t0, t1)
    enter = jnp.maximum(jnp.max(near, axis=-1), t_min)
    exit_ = jnp.minimum(jnp.min(far, axis=-1), t_max)
    return enter <= exit_


def _tri_hit_one(o, d, av, bv, cv, t_min, t_max):
    """Per-ray single-triangle test (triangle.zig:48-71), elementwise.

    Returns (t, u, v, is_hit); t is _BIG when missed.
    """
    e1 = bv - av
    e2 = cv - av
    fn = vm.cross(e1, e2)
    det = -vm.dot(d, fn)
    safe = jnp.abs(det) > 1e-12
    inv_det = 1.0 / jnp.where(safe, det, 1.0)
    ao = o - av
    dao = vm.cross(ao, d)
    u = vm.dot(e2, dao) * inv_det
    v = -vm.dot(e1, dao) * inv_det
    t = vm.dot(ao, fn) * inv_det
    is_hit = (
        (det >= DET_EPS) & (t > t_min) & (t < t_max)
        & (u >= 0.0) & (v >= 0.0) & (u + v <= 1.0)
    )
    return jnp.where(is_hit, t, _BIG), u, v, is_hit


def bvh_closest_triangle(bvh: TriBVH, a, b, c, o, d, t_min, t_max):
    """Closest triangle per ray via stackless lockstep traversal.

    All rays advance one node per iteration; dead rays (node == M) idle
    until every lane finishes. The found-so-far ``t`` tightens the slab
    test exactly like the reference's recursive t_max tightening
    (bvh.zig:196-203).

    Returns ``(t, idx, hit, uv)`` with the same contract as
    ``intersect_triangles``. The search itself is non-differentiable;
    t/u/v ARE recomputed differentiably for the chosen triangle, so
    gradients flow to vertices even through the BVH path.
    """
    # The discrete search must not be differentiated (while_loop has no
    # transpose); gradients re-enter via the recomputation below.
    sg = jax.lax.stop_gradient
    bvh_s = jax.tree_util.tree_map(sg, bvh)
    o_s, d_s = sg(o), sg(d)
    a_s, b_s, c_s = sg(a), sg(b), sg(c)

    n = o.shape[0]
    M = bvh.n_nodes
    T = a_s.shape[0]
    # The leaf test unrolls to the BVH's actual max leaf size (a BVH built
    # with leaf_size > LEAF_SIZE would otherwise silently skip primitives
    # beyond the 4th of each leaf). prim_count is concrete host data in
    # every real call path; if it is ever traced, fall back to LEAF_SIZE
    # and trust the default build.
    try:
        max_leaf = max(int(np.max(np.asarray(bvh.prim_count))), 1)
    except (jax.errors.TracerArrayConversionError, TypeError):
        max_leaf = LEAF_SIZE
    inv_d = 1.0 / jnp.where(jnp.abs(d_s) > 1e-20, d_s, 1e-20)

    # The node attributes pack into one (M, 9) table and the leaf
    # primitives into one (T, 10) table in prim_order — one row gather
    # per traversal step plus LEAF_SIZE row gathers at leaves, instead of
    # ~10 scalar gathers.
    nodes_packed = jnp.concatenate(
        [
            bvh_s.node_min,
            bvh_s.node_max,
            bvh_s.skip.astype(jnp.float32)[:, None],
            bvh_s.prim_count.astype(jnp.float32)[:, None],
            bvh_s.prim_start.astype(jnp.float32)[:, None],
        ],
        axis=1,
    )  # (M, 9)
    order = bvh_s.prim_order
    prims_packed = jnp.concatenate(
        [
            a_s[order], b_s[order], c_s[order],
            order.astype(jnp.float32)[:, None],
        ],
        axis=1,
    )  # (T, 10) in leaf order

    state = dict(
        node=jnp.zeros((n,), jnp.int32),
        t=jnp.broadcast_to(jnp.asarray(t_max, jnp.float32), (n,)).astype(jnp.float32),
        idx=jnp.zeros((n,), jnp.int32),
        found=jnp.zeros((n,), bool),
    )

    def cond(s):
        return jnp.any(s["node"] < M)

    def body(s):
        node = jnp.minimum(s["node"], M - 1)  # clamp for safe gathers
        active = s["node"] < M
        nrow = nodes_packed[node]  # (N, 9) — one row gather
        bmin = nrow[:, 0:3]
        bmax = nrow[:, 3:6]
        skip = nrow[:, 6].astype(jnp.int32)
        count = nrow[:, 7].astype(jnp.int32)
        start = nrow[:, 8].astype(jnp.int32)
        box_hit = active & _slab_test(o_s, inv_d, bmin, bmax, t_min, s["t"])

        is_leaf = count > 0

        t_best = s["t"]
        idx_best = s["idx"]
        found = s["found"]
        do_leaf = box_hit & is_leaf
        for k in range(max_leaf):
            prow = prims_packed[jnp.minimum(start + k, T - 1)]  # (N, 10)
            av, bv, cv = prow[:, 0:3], prow[:, 3:6], prow[:, 6:9]
            prim = prow[:, 9].astype(jnp.int32)
            tk, _, _, hk = _tri_hit_one(o_s, d_s, av, bv, cv, t_min, t_best)
            take = do_leaf & (k < count) & hk & (tk < t_best)
            t_best = jnp.where(take, tk, t_best)
            idx_best = jnp.where(take, prim, idx_best)
            found = found | take

        descend = box_hit & ~is_leaf
        nxt = jnp.where(descend, node + 1, skip)
        nxt = jnp.where(active, nxt, M)
        return dict(node=nxt, t=t_best, idx=idx_best, found=found)

    out = jax.lax.while_loop(cond, body, state)
    idx = out["idx"]
    hit = out["found"]

    # Differentiable recomputation for the chosen triangle only.
    t_re, u_re, v_re, _ = _tri_hit_one(
        o, d, a[idx], b[idx], c[idx], t_min, jnp.asarray(t_max, jnp.float32) * 2.0
    )
    t_out = jnp.where(hit, t_re, _BIG)
    uv = jnp.stack([u_re, v_re], axis=-1)
    return t_out, idx, hit, uv
