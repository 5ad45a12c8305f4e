"""Flattened SoA scene representation.

The reference keeps a pointer graph of ``shared_ptr<Hittable>`` with virtual
dispatch (reference: src/cpu_raytrace/Hittable.hpp:11-15, Scene.hpp:17-25).
That shape cannot run under jit. Here a scene is compiled into a frozen
structure-of-arrays pytree:

* spheres   — center0/displacement/radius/material  (src/cpu_raytrace/Sphere.hpp:15-34)
* quads     — q/u/v plus precomputed normal/d/w      (src/cpu_raytrace/Quad.hpp:14-31);
              boxes are expanded to 6 quads at load   (src/cpu_raytrace/Quad.hpp:34-50)
* media     — analytic boundary (sphere or box) + inverse affine + density
              (src/cpu_raytrace/ConstantMedium.cpp:14-58)
* materials — integer type id + packed params         (src/cpu_raytrace/Material.hpp)
* textures  — integer type id + params + Perlin tables (src/cpu_raytrace/Texture.hpp,
              PerlinNoiseGen.cpp:66-103)

Scene-graph transforms (src/cpu_raytrace/Transform.cpp:75-88) are *baked* into
primitive parameters at load time where exactly representable (any affine for
quads; rigid/uniform-scale for spheres) and carried as an inverse affine for
medium boundaries. Instancing via shared primitives (src/Serialize.cpp:161-197)
is preserved by duplicating records per graph occurrence.

Every array family carries an explicit ``active`` mask so each family can be
padded to a static, tile-friendly size without affecting results.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np

import jax
import jax.numpy as jnp

from raytrace2 import defs


def _field(**kw):
    return dataclasses.field(**kw)


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class Spheres:
    """SoA sphere records. Center is stored as (start, displacement): the
    center at shutter time t in [0,1) is ``center0 + t * displacement``
    (reference: src/cpu_raytrace/Sphere.hpp:15-29, Sphere.cpp:8)."""

    center0: Any      # [S,3] f32
    displacement: Any  # [S,3] f32
    radius: Any        # [S]   f32
    material: Any      # [S]   i32
    active: Any        # [S]   bool

    @property
    def count(self) -> int:
        return self.radius.shape[0]


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class Quads:
    """SoA quad records with the reference's precomputed plane quantities
    (reference: src/cpu_raytrace/Quad.hpp:14-21): n = cross(u,v),
    normal = n/|n|, d = normal·q, w = n/(n·n)."""

    q: Any         # [Q,3]
    u: Any         # [Q,3]
    v: Any         # [Q,3]
    normal: Any    # [Q,3]
    d: Any         # [Q]
    w: Any         # [Q,3]
    material: Any  # [Q] i32
    active: Any    # [Q] bool

    @property
    def count(self) -> int:
        return self.d.shape[0]


def derive_quad_plane(quads: "Quads") -> "Quads":
    """Recompute the derived plane rows (normal/d/w) from q/u/v in jnp —
    the differentiable analog of the loader's numpy derivation
    (Quad.hpp:24-29 via loader._flatten). Use after perturbing quad
    geometry so the intersector sees consistent records (it reads the
    DERIVED rows, not q/u/v)."""
    import jax.numpy as jnp

    n_raw = jnp.cross(quads.u, quads.v)
    nn = jnp.sum(n_raw * n_raw, axis=-1, keepdims=True)
    safe_nn = jnp.where(nn > 0, nn, 1.0)
    normal = n_raw / jnp.sqrt(safe_nn)
    d = jnp.sum(normal * quads.q, axis=-1)
    w = n_raw / safe_nn
    return dataclasses.replace(quads, normal=normal, d=d, w=w)


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class Boxes:
    """Axis-aligned boxes kept as first-class records for the megakernel's
    slab-test sweep (~5× cheaper than their 6-quad expansion). The loader
    ALSO expands every box to quads (appended after the plain quads) so the
    XLA path is unchanged; the kernel sweeps plain quads + this family.
    Only boxes whose baked transform is axis-aligned land here — rotated
    boxes (e.g. Cornell interiors) stay quad-only."""

    bmin: Any      # [B,3]
    bmax: Any      # [B,3]
    material: Any  # [B] i32
    active: Any    # [B] bool

    @property
    def count(self) -> int:
        return self.material.shape[0]


def empty_boxes() -> "Boxes":
    return Boxes(
        bmin=np.zeros((1, 3), defs.REAL),
        bmax=np.zeros((1, 3), defs.REAL),
        material=np.zeros(1, defs.INDEX),
        active=np.zeros(1, bool),
    )


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class Media:
    """Constant-density participating media. The reference wraps an arbitrary
    convex hittable and finds entry/exit by calling Hit twice
    (src/cpu_raytrace/ConstantMedium.cpp:17-37); here the boundary is analytic:
    a (possibly moving) sphere or a box, intersected in the boundary's model
    space via a carried inverse affine (world→model). The model ray direction
    is renormalized exactly as the reference does
    (src/cpu_raytrace/Transform.cpp:17)."""

    btype: Any            # [M] i32 — defs.MEDIUM_SPHERE | defs.MEDIUM_BOX
    p0: Any               # [M,3] sphere center0 | box min
    p1: Any               # [M,3] sphere (radius,0,0) | box max
    displacement: Any     # [M,3] sphere center displacement (motion blur)
    inv_model: Any        # [M,3,4] world→model affine (identity if none)
    neg_inv_density: Any  # [M] = -1/density (ConstantMedium.cpp:12)
    material: Any         # [M] i32
    active: Any           # [M] bool

    @property
    def count(self) -> int:
        return self.btype.shape[0]


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class Ellipsoids:
    """Spheres under a NON-similarity affine (the reference's
    TransformedHittable over a sphere with non-uniform scale/shear,
    src/cpu_raytrace/Transform.cpp:75-88 — authorable via scene-graph
    node scales, make_scene.py add_node). The model-space sphere keeps
    the reference sphere parameterization (moving center + radius,
    Sphere.hpp:15-29); the record carries the world→model inverse affine
    and the inverse-transpose linear part for normals (Transform.cpp:38
    normal_mat). The model direction is NOT renormalized, so the model-
    space hit parameter IS the world-space t (affine maps preserve the
    ray parameter) — same true-world-t convention as the baked
    similarity spheres (the reference leaves t in model units, one of
    its known scaled-instance quirks)."""

    center0: Any       # [E,3] model-space center at shutter t=0
    displacement: Any  # [E,3] model-space center displacement
    radius: Any        # [E]
    inv_model: Any     # [E,3,4] world→model affine
    inv_t: Any         # [E,3,3] inverse-transpose linear part (normals)
    material: Any      # [E] i32
    active: Any        # [E] bool

    @property
    def count(self) -> int:
        return self.radius.shape[0]


def make_ellipsoids(center0, displacement, radius, inv_model, inv_t,
                    material) -> "Ellipsoids":
    center0 = np.asarray(center0, defs.REAL).reshape(-1, 3)
    n = center0.shape[0]
    target = max(n, 1)
    active = np.zeros(target, bool)
    active[:n] = True
    ident34 = np.hstack([np.eye(3), np.zeros((3, 1))])[None]
    return Ellipsoids(
        center0=_pad(center0, target),
        displacement=_pad(
            np.asarray(displacement, defs.REAL).reshape(-1, 3), target),
        radius=_pad(np.asarray(radius, defs.REAL).reshape(-1), target),
        inv_model=np.concatenate(
            [np.asarray(inv_model, defs.REAL).reshape(-1, 3, 4),
             np.tile(ident34.astype(defs.REAL), (target - n, 1, 1))]
        ) if n else np.tile(ident34.astype(defs.REAL), (target, 1, 1)),
        inv_t=np.concatenate(
            [np.asarray(inv_t, defs.REAL).reshape(-1, 3, 3),
             np.tile(np.eye(3, dtype=defs.REAL)[None], (target - n, 1, 1))]
        ) if n else np.tile(np.eye(3, dtype=defs.REAL)[None], (target, 1, 1)),
        material=_pad(np.asarray(material, defs.INDEX).reshape(-1), target),
        active=active,
    )


def empty_ellipsoids() -> "Ellipsoids":
    return make_ellipsoids(
        np.zeros((0, 3)), np.zeros((0, 3)), np.zeros((0,)),
        np.zeros((0, 3, 4)), np.zeros((0, 3, 3)), np.zeros((0,), np.int32))


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class Materials:
    """One row per material: type id + packed params
    (reference variant: src/cpu_raytrace/Fwd.hpp:13-14, Material.hpp:31-65).
    ``param`` holds metal fuzz or dielectric refraction_index."""

    mtype: Any   # [K] i32
    albedo: Any  # [K,3]
    param: Any   # [K]
    tex: Any     # [K] i32

    @property
    def count(self) -> int:
        return self.mtype.shape[0]


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class Textures:
    """One row per texture (reference: src/cpu_raytrace/Texture.hpp:14-39).

    * solid:   albedo
    * checker: inv_scale (= 1/scale, Texture.hpp:20), child indices even/odd
    * noise:   albedo, scale, noise_type, per-texture Perlin tables
               (reference generates one table set per Noise texture,
               src/Serialize.cpp:227-235 + PerlinNoiseGen.cpp:40-50)
    """

    ttype: Any       # [L] i32
    albedo: Any      # [L,3]
    inv_scale: Any   # [L] checker inverse scale
    scale: Any       # [L] noise scale
    even: Any        # [L] i32 checker child
    odd: Any         # [L] i32 checker child
    noise_type: Any  # [L] i32
    perm: Any        # [L,3,256] i32 Perlin permutation tables (x,y,z)
    grad: Any        # [L,256,3] f32 Perlin unit gradient vectors

    @property
    def count(self) -> int:
        return self.ttype.shape[0]


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class CameraParams:
    """Raw camera parameters (reference: src/cpu_raytrace/Camera.hpp:108-123,
    loaded in src/Serialize.cpp:32-40). Derived quantities (basis, viewport,
    pixel deltas) are computed in ops.camera at trace time — they are a few
    scalars, and keeping them derived makes the camera differentiable."""

    center: Any         # [3]
    look_at: Any        # [3]
    vup: Any            # [3]
    vfov: Any           # [] degrees
    defocus_angle: Any  # [] degrees
    focus_dist: Any     # []


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class FlatScene:
    """The complete device-resident scene pytree."""

    spheres: Spheres
    quads: Quads
    boxes: Boxes
    media: Media
    materials: Materials
    textures: Textures
    camera: CameraParams
    background: Any  # [3] (reference: Scene.hpp:23, default {1,1,1})
    # Optional flattened BVH over the active spheres (scene/bvh.py),
    # attached by the Renderer for large scenes on the XLA path — the
    # production form of the reference's App-level BVH wrap
    # (src/App.cpp:126). None when the dense sweep / megakernel is used.
    sphere_bvh: Any = None
    # Spheres under non-similarity transforms (see Ellipsoids). None for
    # every corpus scene; scenes carrying them render on the XLA path
    # (features() withholds mega_sizes).
    ellipsoids: Any = None

    @property
    def num_records(self) -> int:
        return self.spheres.count + self.quads.count + self.media.count

    def features(self) -> dict:
        """Static feature gates for the tracer, computed host-side at load
        time. Scenes without media/noise/checker skip those code paths
        entirely under jit (call before moving the pytree to device).
        ``mega_sizes`` carries the active record counts for the megakernel's
        static loops."""
        ttypes = np.asarray(self.textures.ttype)

        def checker_depth() -> int:
            # Max checker-nesting depth (reference checkers recurse
            # arbitrarily, Texture.cpp:7-11; the loader rejects cycles so
            # this DFS terminates). 0 = no checkers; plain bool tests on
            # the feature keep working (depth >= 1 is truthy).
            even = np.asarray(self.textures.even)
            odd = np.asarray(self.textures.odd)

            def depth(i: int) -> int:
                if ttypes[i] != 1:  # defs.TEX_CHECKER
                    return 0
                return 1 + max(depth(int(even[i])), depth(int(odd[i])))

            return max((depth(i) for i in range(len(ttypes))), default=0)

        has_ell = (self.ellipsoids is not None
                   and bool(np.any(np.asarray(self.ellipsoids.active))))
        return {
            "has_media": bool(np.any(np.asarray(self.media.active))),
            "has_ellipsoids": has_ell,
            "has_noise": bool(np.any(ttypes == 2)),    # defs.TEX_NOISE
            "has_checker": checker_depth(),            # nesting depth (int)
            # (n_spheres, n_plain_quads, n_mats, n_texs, n_media, n_boxes):
            # box-derived quads sit AFTER the plain quads, so the kernel's
            # quad sweep covers the first (active_quads - 6·n_boxes) rows
            # and the box family covers the rest via slab tests.
            # Ellipsoid scenes render on the XLA path (no kernel family
            # yet; mega_sizes=None routes every megakernel gate away).
            "mega_sizes": None if has_ell else (
                int(np.asarray(self.spheres.active).sum()),
                int(np.asarray(self.quads.active).sum())
                - 6 * int(np.asarray(self.boxes.active).sum()),
                int(self.materials.mtype.shape[0]),
                int(self.textures.ttype.shape[0]),
                int(np.asarray(self.media.active).sum()),
                int(np.asarray(self.boxes.active).sum()),
            ),
        }


def _pad(arr: np.ndarray, n: int) -> np.ndarray:
    """Pad the leading axis of ``arr`` to length ``n`` with zeros."""
    if arr.shape[0] == n:
        return arr
    pad = [(0, n - arr.shape[0])] + [(0, 0)] * (arr.ndim - 1)
    return np.pad(arr, pad)


def make_spheres(center0, displacement, radius, material, pad_to: int | None = None) -> Spheres:
    center0 = np.asarray(center0, defs.REAL).reshape(-1, 3)
    n = center0.shape[0]
    target = max(pad_to or n, 1)
    active = np.zeros(target, bool)
    active[:n] = True
    return Spheres(
        center0=_pad(center0, target),
        displacement=_pad(np.asarray(displacement, defs.REAL).reshape(-1, 3), target),
        radius=_pad(np.asarray(radius, defs.REAL).reshape(-1), target),
        material=_pad(np.asarray(material, defs.INDEX).reshape(-1), target),
        active=active,
    )


def make_quads(q, u, v, material, pad_to: int | None = None) -> Quads:
    q = np.asarray(q, np.float64).reshape(-1, 3)
    u = np.asarray(u, np.float64).reshape(-1, 3)
    v = np.asarray(v, np.float64).reshape(-1, 3)
    n_raw = np.cross(u, v)
    nn = np.sum(n_raw * n_raw, axis=-1, keepdims=True)
    # Inactive/padded rows would divide by zero; park them on a unit normal.
    safe_nn = np.where(nn > 0, nn, 1.0)
    normal = n_raw / np.sqrt(safe_nn)
    d = np.sum(normal * q, axis=-1)
    w = n_raw / safe_nn
    n = q.shape[0]
    target = max(pad_to or n, 1)
    active = np.zeros(target, bool)
    active[:n] = True
    return Quads(
        q=_pad(q.astype(defs.REAL), target),
        u=_pad(u.astype(defs.REAL), target),
        v=_pad(v.astype(defs.REAL), target),
        normal=_pad(normal.astype(defs.REAL), target),
        d=_pad(d.astype(defs.REAL), target),
        w=_pad(w.astype(defs.REAL), target),
        material=_pad(np.asarray(material, defs.INDEX).reshape(-1), target),
        active=active,
    )


def empty_media() -> Media:
    ident = np.zeros((1, 3, 4), defs.REAL)
    ident[0, :, :3] = np.eye(3)
    return Media(
        btype=np.zeros(1, defs.INDEX),
        p0=np.zeros((1, 3), defs.REAL),
        p1=np.zeros((1, 3), defs.REAL),
        displacement=np.zeros((1, 3), defs.REAL),
        inv_model=ident,
        neg_inv_density=np.full(1, -1.0, defs.REAL),
        material=np.zeros(1, defs.INDEX),
        active=np.zeros(1, bool),
    )


def to_device(scene: FlatScene) -> FlatScene:
    """Move every leaf to the default device as jnp arrays."""
    return jax.tree_util.tree_map(jnp.asarray, scene)
