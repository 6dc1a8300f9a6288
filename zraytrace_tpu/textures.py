"""Texture lookup: gather-free table access + one flat atlas gather.

Reference semantics: texture.zig — constant color (texture.zig:31-44) and
nearest-neighbor image lookup with u-flip and u/v offsets with single-step
wrap (texture.zig:52-74). The image rows are stored bottom-up (the PNG
reader flips vertically, png_image.zig:86), which our loader reproduces.

Design: per-lane lookups into the small texture table are where-chains
or one-hot ``(N,K) @ (K,C)`` matmuls (geometry/sphere.onehot_rows). Only
the actual texel fetch is a real gather, done once per lane against the
flattened ``(A*H*W, 3)`` atlas.

Note: the reference wraps ``vv`` by +1 when ``uu_first < 0`` instead of
``vv_first < 0`` (texture.zig:66) — a latent bug that can never fire with
the offsets used anywhere in the repo (u_offset = 0.19 keeps
``uu_first >= 0.19``). We implement the evidently-intended wrap; behaviour
is identical on every reference scene.
"""

from __future__ import annotations

import os as _os

import jax
import jax.numpy as jnp

from zraytrace_tpu import scene as sc
from zraytrace_tpu.geometry.sphere import onehot_rows

# Sorted-scatter atlas adjoint (experiment, off by default): the
# bilinear taps' gather adjoint is a scatter-add into the atlas. This
# custom-vjp wrapper sorts the tap indices in the backward pass and
# scatters with indices_are_sorted=True (sort of N*4 keys is ~free at
# fit sizes). Gradient VALUES are identical up to f32 add order.
_SORTED_SCATTER = _os.environ.get("ZRAYTRACE_TEX_SORTED_SCATTER",
                                  "0") == "1"


@jax.custom_vjp
def _gather_rows(table, flat_idx):
    return table[flat_idx]


def _gather_rows_fwd(table, flat_idx):
    return table[flat_idx], (table.shape, flat_idx)


def _gather_rows_bwd(res, ct):
    shape, flat_idx = res
    order = jnp.argsort(flat_idx)
    d = jnp.zeros(shape, ct.dtype).at[flat_idx[order]].add(
        ct[order], indices_are_sorted=True, unique_indices=False)
    return d, None


_gather_rows.defvjp(_gather_rows_fwd, _gather_rows_bwd)


def _wrap(x):
    """Single-step wrap into [0, 1] (texture.zig:54-68)."""
    x = jnp.where(x > 1.0, x - 1.0, x)
    return jnp.where(x < 0.0, x + 1.0, x)


def _texture_table(scene: sc.Scene) -> jnp.ndarray:
    """Per-texture attribute matrix ``(K, 9)``:
    [type, r, g, b, flat_base, u_off, v_off, h, w].

    Built in-trace from scene leaves (K is tiny), so gradients flow to
    ``tex_color`` through the one-hot contraction.
    """
    a_h, a_w = scene.atlas.shape[1], scene.atlas.shape[2]
    aid = scene.tex_image  # (K,)
    hw = scene.atlas_hw[aid].astype(jnp.float32)  # (K, 2) — tiny gather
    base = (aid * (a_h * a_w)).astype(jnp.float32)  # flat offset into atlas
    return jnp.concatenate(
        [
            scene.tex_type.astype(jnp.float32)[:, None],
            scene.tex_color,
            base[:, None],
            scene.tex_offset,
            hw[:, 0:1],
            hw[:, 1:2],
        ],
        axis=-1,
    )


def texture_albedo(scene: sc.Scene, tex_id: jnp.ndarray, uv: jnp.ndarray,
                   bilinear: bool = False) -> jnp.ndarray:
    """Albedo at the hit point, ``(N, 3)``.

    Args:
      tex_id: ``(N,)`` int32 texture table indices.
      uv: ``(N, 2)`` texture coordinates.
      bilinear: smooth interpolation instead of the reference's
        nearest-neighbor lookup (texture.zig:70-73) — needed for usable
        gradients w.r.t. hit position; off by default for forward parity.
    """
    attrs = onehot_rows(tex_id, _texture_table(scene))  # (N, 9)
    tex_type = attrs[:, 0]
    const_color = attrs[:, 1:4]
    # Imageless scenes carry a (1, 1, 1, 3) dummy atlas (scene.py) and
    # can hold no TEX_IMAGE entries: skip the per-lane atlas gather
    # entirely (pure waste for const-only scenes like man/bunny/teapot).
    if scene.atlas.shape[1] == 1 and scene.atlas.shape[2] == 1:
        return const_color
    base = attrs[:, 4]
    off = attrs[:, 5:7]
    h, w = attrs[:, 7], attrs[:, 8]

    uu = _wrap(1.0 - uv[:, 0] + off[:, 0])  # u flip + offset (texture.zig:54)
    vv = _wrap(uv[:, 1] + off[:, 1])

    atlas_w = scene.atlas.shape[2]
    flat_atlas = scene.atlas.reshape(-1, 3)

    def fetch(ix, iy):
        flat = base.astype(jnp.int32) + iy * atlas_w + ix
        return flat_atlas[flat]  # the one real gather

    if bilinear:
        fx = uu * w - 0.5
        fy = vv * h - 0.5
        x0 = jnp.floor(fx)
        y0 = jnp.floor(fy)
        tx = (fx - x0)[:, None]
        ty = (fy - y0)[:, None]

        # ONE batched (N, 4) gather instead of four separate fetches:
        # XLA then emits ONE scatter for the atlas adjoint instead of
        # four. Forward values are bit-identical: each tap's
        # product keeps the original association
        # (c * weight_x) * weight_y.
        xs = jnp.stack([x0, x0 + 1.0, x0, x0 + 1.0], axis=1)  # (N, 4)
        ys = jnp.stack([y0, y0, y0 + 1.0, y0 + 1.0], axis=1)
        xi = jnp.clip(xs, 0.0, (w - 1.0)[:, None]).astype(jnp.int32)
        yi = jnp.clip(ys, 0.0, (h - 1.0)[:, None]).astype(jnp.int32)
        flat4 = base.astype(jnp.int32)[:, None] + yi * atlas_w + xi
        # gather through a FLAT (N*4,) index; optionally through the
        # sorted-scatter custom-vjp wrapper (_SORTED_SCATTER above)
        if _SORTED_SCATTER:
            c = _gather_rows(flat_atlas, flat4.reshape(-1)).reshape(
                flat4.shape + (3,))
        else:
            c = flat_atlas[flat4.reshape(-1)].reshape(flat4.shape + (3,))
        img_color = (
            c[:, 0] * (1 - tx) * (1 - ty)
            + c[:, 1] * tx * (1 - ty)
            + c[:, 2] * (1 - tx) * ty
            + c[:, 3] * tx * ty
        )
    else:
        # Truncation + clamp exactly as texture.zig:70-73.
        ix = jnp.clip((uu * w).astype(jnp.int32), 0, (w - 1).astype(jnp.int32))
        iy = jnp.clip((vv * h).astype(jnp.int32), 0, (h - 1).astype(jnp.int32))
        img_color = fetch(ix, iy)

    return jnp.where((tex_type > 0.5)[:, None], img_color, const_color)
