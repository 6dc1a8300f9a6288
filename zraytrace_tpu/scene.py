"""Scene representation: flat, typed SoA arrays.

The reference models a scene as ``ArrayList(Surface)`` of tagged unions with
material pointers (surface.zig:12-15, sphere.zig:16-21). That design is
pointer-chasing and branchy — hostile to XLA. Here a scene is a pytree of
flat arrays:

- spheres:   centers ``(S,3)``, signed radii ``(S,)`` (negative radius keeps
  the reference's inward-normal hollow-glass trick, sphere.zig:45,
  scenes.zig:96,195), material ids ``(S,)``
- triangles: vertex arrays ``(T,3)`` each (edges/normals derived at trace
  time so gradients flow to vertices; reference precomputes, triangle.zig:32-46)
- materials: type/texture/ior tables (material.zig:27-29)
- textures:  type/color/atlas tables (texture.zig:7-9); images live in one
  padded atlas array so lookups are a single gather.

All float arrays are f32 leaves of a pytree — the differentiable scene
parameters. Integer tables are static structure.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import jax.numpy as jnp

from zraytrace_tpu.camera import Camera, make_camera

# Material type tags (material.zig:27-29).
LAMBERTIAN = 0
METAL = 1
DIELECTRIC = 2

# Texture type tags (texture.zig:7-9).
TEX_COLOR = 0
TEX_IMAGE = 1

# Named color constants (image.zig:14-20).
COLOR_BLACK = (0.0, 0.0, 0.0)
COLOR_WHITE = (1.0, 1.0, 1.0)
COLOR_GOLD = (1.0, 0.843, 0.0)
COLOR_SILVER = (0.752, 0.752, 0.752)
COLOR_RED = (1.0, 0.01, 0.01)
COLOR_GREEN = (0.01, 1.0, 0.01)
COLOR_BLUE = (0.01, 0.01, 1.0)

# Default image-texture offsets (texture.zig:15).
DEFAULT_U_OFFSET = 0.19
DEFAULT_V_OFFSET = 0.1


class Scene(NamedTuple):
    """Flat scene arrays. ``S`` spheres, ``T`` triangles, ``M`` materials,
    ``K`` textures, ``A`` atlas images. Any of S/T/A may be zero."""

    # --- differentiable geometry ---
    sph_center: jnp.ndarray  # (S, 3) f32
    sph_radius: jnp.ndarray  # (S,)   f32, signed
    tri_a: jnp.ndarray  # (T, 3) f32
    tri_b: jnp.ndarray  # (T, 3) f32
    tri_c: jnp.ndarray  # (T, 3) f32
    # --- differentiable material/texture parameters ---
    mat_ior: jnp.ndarray  # (M,)   f32 index of refraction (dielectrics)
    tex_color: jnp.ndarray  # (K, 3) f32 constant colors
    atlas: jnp.ndarray  # (A, H, W, 3) f32 padded image atlas
    # --- static structure (int32) ---
    sph_mat: jnp.ndarray  # (S,) material id per sphere
    tri_mat: jnp.ndarray  # (T,) material id per triangle
    mat_type: jnp.ndarray  # (M,) LAMBERTIAN/METAL/DIELECTRIC
    mat_tex: jnp.ndarray  # (M,) texture id
    tex_type: jnp.ndarray  # (K,) TEX_COLOR/TEX_IMAGE
    tex_image: jnp.ndarray  # (K,) atlas index (0 if unused)
    tex_offset: jnp.ndarray  # (K, 2) f32 (u_offset, v_offset), texture.zig:15
    atlas_hw: jnp.ndarray  # (A, 2) i32 true (height, width) of each image

    @property
    def n_spheres(self) -> int:
        return self.sph_center.shape[0]

    @property
    def n_triangles(self) -> int:
        return self.tri_a.shape[0]

    @property
    def n_primitives(self) -> int:
        return self.n_spheres + self.n_triangles


class SceneBuilder:
    """Host-side scene assembly (numpy), the analogue of the reference's
    scene builder functions (scenes.zig:26-265). ``build()`` produces the
    immutable jnp ``Scene``.

    Primitive insertion order is preserved: spheres keep their insertion
    index; the reference's closest-hit scan breaks ties by list order
    (raytrace.zig:75-81). All reference scenes insert spheres before
    triangles, which our sphere-wins-ties merge reproduces.
    """

    def __init__(self):
        self._sph = []  # (center, radius, mat_id)
        self._tri = []  # (a, b, c, mat_id) possibly vectorized blocks
        self._mats = []  # (type, tex_id, ior)
        self._texs = []  # (type, color, atlas_id, u_off, v_off)
        self._images = []  # np arrays (H, W, 3) f32

    # -- textures -------------------------------------------------------
    def add_color_texture(self, color) -> int:
        self._texs.append((TEX_COLOR, np.asarray(color, np.float32), 0, 0.0, 0.0))
        return len(self._texs) - 1

    def add_image_texture(
        self, image: np.ndarray,
        u_offset: float = DEFAULT_U_OFFSET,
        v_offset: float = DEFAULT_V_OFFSET,
    ) -> int:
        """``image`` is (H, W, 3) f32 with row 0 = image bottom, matching the
        reference's vertically-flipped PNG read (png_image.zig:86)."""
        image = np.asarray(image, np.float32)
        assert image.ndim == 3 and image.shape[-1] == 3
        self._images.append(image)
        atlas_id = len(self._images) - 1
        self._texs.append(
            (TEX_IMAGE, np.zeros(3, np.float32), atlas_id, float(u_offset), float(v_offset))
        )
        return len(self._texs) - 1

    # -- materials ------------------------------------------------------
    def add_material(self, mat_type: int, tex_id: int = 0, ior: float = 1.0) -> int:
        self._mats.append((mat_type, tex_id, float(ior)))
        return len(self._mats) - 1

    def add_lambertian(self, tex_id: int) -> int:
        return self.add_material(LAMBERTIAN, tex_id)

    def add_metal(self, tex_id: int) -> int:
        return self.add_material(METAL, tex_id)

    def add_dielectric(self, ior: float) -> int:
        return self.add_material(DIELECTRIC, 0, ior)

    def add_lambertian_color(self, color) -> int:
        return self.add_lambertian(self.add_color_texture(color))

    def add_metal_color(self, color) -> int:
        return self.add_metal(self.add_color_texture(color))

    # -- geometry -------------------------------------------------------
    def add_sphere(self, center, radius: float, mat_id: int) -> None:
        self._sph.append((np.asarray(center, np.float32), float(radius), mat_id))

    def add_triangle(self, a, b, c, mat_id: int) -> None:
        self.add_triangles(
            np.asarray(a, np.float32)[None],
            np.asarray(b, np.float32)[None],
            np.asarray(c, np.float32)[None],
            mat_id,
        )

    def add_triangles(self, a: np.ndarray, b: np.ndarray, c: np.ndarray, mat_id: int):
        """Add a block of triangles sharing one material (the OBJ-model
        case: one material per model, obj_reader.zig:114)."""
        n = a.shape[0]
        self._tri.append(
            (
                np.asarray(a, np.float32),
                np.asarray(b, np.float32),
                np.asarray(c, np.float32),
                np.full((n,), mat_id, np.int32),
            )
        )

    # -- build ----------------------------------------------------------
    def build(self) -> Scene:
        S = len(self._sph)
        sph_center = np.zeros((S, 3), np.float32)
        sph_radius = np.zeros((S,), np.float32)
        sph_mat = np.zeros((S,), np.int32)
        for i, (center, radius, mid) in enumerate(self._sph):
            sph_center[i] = center
            sph_radius[i] = radius
            sph_mat[i] = mid

        if self._tri:
            tri_a = np.concatenate([t[0] for t in self._tri], axis=0)
            tri_b = np.concatenate([t[1] for t in self._tri], axis=0)
            tri_c = np.concatenate([t[2] for t in self._tri], axis=0)
            tri_mat = np.concatenate([t[3] for t in self._tri], axis=0)
        else:
            tri_a = tri_b = tri_c = np.zeros((0, 3), np.float32)
            tri_mat = np.zeros((0,), np.int32)

        M = max(len(self._mats), 1)
        mat_type = np.zeros((M,), np.int32)
        mat_tex = np.zeros((M,), np.int32)
        mat_ior = np.ones((M,), np.float32)
        for i, (mt, tid, ior) in enumerate(self._mats):
            mat_type[i], mat_tex[i], mat_ior[i] = mt, tid, ior

        K = max(len(self._texs), 1)
        tex_type = np.zeros((K,), np.int32)
        tex_color = np.zeros((K, 3), np.float32)
        tex_image = np.zeros((K,), np.int32)
        tex_offset = np.zeros((K, 2), np.float32)
        for i, (tt, col, aid, uo, vo) in enumerate(self._texs):
            tex_type[i], tex_color[i], tex_image[i] = tt, col, aid
            tex_offset[i] = (uo, vo)

        if self._images:
            max_h = max(im.shape[0] for im in self._images)
            max_w = max(im.shape[1] for im in self._images)
            A = len(self._images)
            atlas = np.zeros((A, max_h, max_w, 3), np.float32)
            atlas_hw = np.zeros((A, 2), np.int32)
            for i, im in enumerate(self._images):
                atlas[i, : im.shape[0], : im.shape[1]] = im
                atlas_hw[i] = (im.shape[0], im.shape[1])
        else:
            atlas = np.zeros((1, 1, 1, 3), np.float32)
            atlas_hw = np.ones((1, 2), np.int32)

        return Scene(
            sph_center=jnp.asarray(sph_center),
            sph_radius=jnp.asarray(sph_radius),
            tri_a=jnp.asarray(tri_a),
            tri_b=jnp.asarray(tri_b),
            tri_c=jnp.asarray(tri_c),
            mat_ior=jnp.asarray(mat_ior),
            tex_color=jnp.asarray(tex_color),
            atlas=jnp.asarray(atlas),
            sph_mat=jnp.asarray(sph_mat),
            tri_mat=jnp.asarray(tri_mat),
            mat_type=jnp.asarray(mat_type),
            mat_tex=jnp.asarray(mat_tex),
            tex_type=jnp.asarray(tex_type),
            tex_image=jnp.asarray(tex_image),
            tex_offset=jnp.asarray(tex_offset),
            atlas_hw=jnp.asarray(atlas_hw),
        )
