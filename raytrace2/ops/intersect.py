"""Closest-hit intersection over the flattened SoA scene.

Design note: the reference finds the closest hit by walking a pointer-based
BVH with virtual dispatch (src/cpu_raytrace/BVH.cpp:50-55,
HittableList.cpp:8-22). Here every per-(ray, primitive) quantity is a dense
batched product ([N,3]·[3,P] contractions feeding elementwise resolve + a
min/argmin reduction) that XLA fuses into a few reductions. A flattened-BVH
sphere sweep serves sphere-heavy scenes (scene/bvh.py).

Precision: every K=3 contraction is written as explicit multiply-adds
(``_mm``) or carries ``precision=HIGHEST``. A float32 dot may otherwise run
at reduced precision (TF32 on a GPU's tensor cores, bf16 passes elsewhere),
which moves hit distances by ~1e-2 at Cornell scale — acne rings and a
visibly dimmer image.

Semantics are bit-matched to the reference:
* sphere:  quadratic with moving center c(t) = c0 + time·disp, nearest root
           strictly inside (tmin, tmax) — Interval::Surrounds
           (src/cpu_raytrace/Sphere.cpp:7-37, Interval.hpp).
* quad:    plane solve + planar alpha/beta interior test with *closed*
           interval — Interval::Contains (src/cpu_raytrace/Quad.cpp:19-43).
* medium:  analytic boundary entry/exit over (-inf, inf) then exponential
           free-path sampling (src/cpu_raytrace/ConstantMedium.cpp:14-58).

The winning hit record (point/normal/uv/material/front_face) is reconstructed
once per ray from the argmin index only — per-primitive records are never
materialized.
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

from raytrace2 import defs

BIG = jnp.float32(3.0e38)  # sentinel "no hit" distance (< f32 max to stay finite)


_HI = jax.lax.Precision.HIGHEST


def _mm(a, bt):
    """[N,3]·[3,P] ray×primitive contraction as explicit broadcast
    multiply-adds — full f32 whatever the backend's default dot precision,
    and a K=3 contraction gains nothing from a matrix unit."""
    return (
        a[:, 0:1] * bt[0][None, :]
        + a[:, 1:2] * bt[1][None, :]
        + a[:, 2:3] * bt[2][None, :]
    )


class Hit(NamedTuple):
    """SoA hit record — the batched form of cpu::HitRecord
    (src/cpu_raytrace/HitRecord.hpp:9-21); the material pointer is an i32
    index and ``valid`` replaces the bool return."""

    valid: jnp.ndarray       # [N] bool
    t: jnp.ndarray           # [N]
    point: jnp.ndarray       # [N,3]
    normal: jnp.ndarray      # [N,3] — face-forwarded
    front_face: jnp.ndarray  # [N] bool
    uv: jnp.ndarray          # [N,2]
    material: jnp.ndarray    # [N] i32
    fam: jnp.ndarray = None  # [N] i32 family: 0 sphere / 1 quad / 2 medium /
                             #       3 ellipsoid / -1 miss
    prim: jnp.ndarray = None  # [N] i32 index within the family


# --------------------------------------------------------------------------
# Spheres
# --------------------------------------------------------------------------


def _sphere_ts(spheres, o, d, time, t_min, t_max):
    """Per-(ray, sphere) accepted hit t, BIG where no hit. Shapes [N,S].

    All cross terms are [N,3]·[3,S] contractions (``_mm``) plus per-ray/-sphere
    rank-1 broadcasts; reference math: src/cpu_raytrace/Sphere.cpp:7-26.
    """
    c0, disp, rad = spheres.center0, spheres.displacement, spheres.radius
    # Ray-invariant sphere scalars.
    c0c0 = jnp.sum(c0 * c0, -1)          # [S]
    c0disp = jnp.sum(c0 * disp, -1)      # [S]
    dispdisp = jnp.sum(disp * disp, -1)  # [S]
    r2 = rad * rad

    d_c0 = _mm(d, c0.T)        # [N,S]
    d_disp = _mm(d, disp.T)
    o_c0 = _mm(o, c0.T)
    o_disp = _mm(o, disp.T)
    oo = jnp.sum(o * o, -1, keepdims=True)   # [N,1]
    a = jnp.sum(d * d, -1, keepdims=True)    # [N,1] (1.0 for normalized dirs)
    tt = time[:, None]

    # oc = c(time) - o;  h = d·oc;  c_coef = oc·oc - r².
    h = d_c0 + tt * d_disp - jnp.sum(d * o, -1, keepdims=True)
    cc = c0c0[None, :] + 2.0 * tt * c0disp[None, :] + tt * tt * dispdisp[None, :]
    c_coef = cc - 2.0 * (o_c0 + tt * o_disp) + oo - r2[None, :]

    disc = h * h - a * c_coef
    # Safe sqrt: sqrt'(0) is inf and 0·inf = NaN in the VJP of the masked
    # select below; feed a dummy operand where there is no real root.
    has_root = disc >= 0.0
    sq = jnp.sqrt(jnp.where(has_root, disc, 1.0))
    root0 = (h - sq) / a
    root1 = (h + sq) / a
    tmin = t_min[:, None] if t_min.ndim else t_min
    tmax = t_max[:, None]
    # Interval::Surrounds — strict (Interval.hpp; Sphere.cpp:20-25).
    ok0 = (root0 > tmin) & (root0 < tmax)
    ok1 = (root1 > tmin) & (root1 < tmax)
    root = jnp.where(ok0, root0, root1)
    hit = has_root & (ok0 | ok1) & spheres.active[None, :]
    return jnp.where(hit, root, BIG)


def _sphere_record(spheres, o, d, time, t, idx):
    """Reconstruct point/normal/uv for the winning sphere per ray
    (src/cpu_raytrace/Sphere.cpp:28-43)."""
    c0 = spheres.center0[idx]
    disp = spheres.displacement[idx]
    rad = spheres.radius[idx]
    center = c0 + time[:, None] * disp
    point = o + t[:, None] * d
    # Padded rows have radius 0; they never win a valid hit but the record is
    # computed unconditionally — keep the division finite.
    outward = (point - center) / jnp.where(rad != 0.0, rad, 1.0)[:, None]
    front = jnp.sum(d * outward, -1) < 0.0
    normal = jnp.where(front[:, None], outward, -outward)
    # GetUV (Sphere.cpp:39-43): p is the outward unit normal.
    theta = jnp.arccos(jnp.clip(-outward[:, 1], -1.0, 1.0))
    phi = jnp.arctan2(-outward[:, 2], outward[:, 0]) + jnp.pi
    uv = jnp.stack([phi / (2.0 * jnp.pi), theta / jnp.pi], -1)
    return point, normal, front, uv, spheres.material[idx]


# --------------------------------------------------------------------------
# Ellipsoids (spheres under non-similarity affines)
# --------------------------------------------------------------------------


def _ellipsoid_rays(ell, o, d):
    """Model-space rays per (ray, ellipsoid): om/dm [N,E,3]. The direction
    is NOT renormalized, so the model-space hit parameter equals the
    world-space t (affine maps preserve the ray parameter) — see
    schema.Ellipsoids for the convention vs the reference's
    model-units t (Transform.cpp:17)."""
    inv = ell.inv_model  # [E,3,4]
    a = inv[:, :, :3]
    b = inv[:, :, 3]
    om = jnp.einsum("nj,eij->nei", o, a, precision=_HI) + b[None]
    dm = jnp.einsum("nj,eij->nei", d, a, precision=_HI)
    return om, dm


def _ellipsoid_ts(ell, o, d, time, t_min, t_max):
    """Per-(ray, ellipsoid) accepted hit t, BIG where miss. Shapes [N,E].
    The model-space solve is the reference sphere quadratic
    (Sphere.cpp:7-26) against the moving model-space center."""
    om, dm = _ellipsoid_rays(ell, o, d)
    c = ell.center0[None] + time[:, None, None] * ell.displacement[None]
    oc = c - om
    a = jnp.sum(dm * dm, -1)
    h = jnp.sum(dm * oc, -1)
    cc = jnp.sum(oc * oc, -1) - (ell.radius * ell.radius)[None]
    disc = h * h - a * cc
    has_root = disc >= 0.0
    sq = jnp.sqrt(jnp.where(has_root, disc, 1.0))
    a_safe = jnp.where(a > 0.0, a, 1.0)
    root0 = (h - sq) / a_safe
    root1 = (h + sq) / a_safe
    tmin = t_min[:, None] if t_min.ndim else t_min
    tmax = t_max[:, None]
    ok0 = (root0 > tmin) & (root0 < tmax)
    ok1 = (root1 > tmin) & (root1 < tmax)
    root = jnp.where(ok0, root0, root1)
    hit = has_root & (ok0 | ok1) & ell.active[None, :] & (a > 0.0)
    return jnp.where(hit, root, BIG)


def _ellipsoid_record(ell, o, d, time, t, idx):
    """Point/normal/uv for the winning ellipsoid per ray: model-space
    sphere record mapped back — normal via the inverse-transpose linear
    part, normalized (Transform.cpp:38,87); UV from the model-space
    outward normal (the reference's GetUV runs in model space)."""
    inv = ell.inv_model[idx]  # [N,3,4]
    om = jnp.einsum("nj,nij->ni", o, inv[:, :, :3], precision=_HI) + inv[:, :, 3]
    dm = jnp.einsum("nj,nij->ni", d, inv[:, :, :3], precision=_HI)
    c = ell.center0[idx] + time[:, None] * ell.displacement[idx]
    rad = ell.radius[idx]
    pm = om + t[:, None] * dm
    outward_m = (pm - c) / jnp.where(rad != 0.0, rad, 1.0)[:, None]
    n_raw = jnp.einsum("nj,nij->ni", outward_m, ell.inv_t[idx], precision=_HI)
    n_len = jnp.sqrt(jnp.maximum(jnp.sum(n_raw * n_raw, -1), 1e-24))
    outward = n_raw / n_len[:, None]
    point = o + t[:, None] * d
    front = jnp.sum(d * outward, -1) < 0.0
    normal = jnp.where(front[:, None], outward, -outward)
    theta = jnp.arccos(jnp.clip(-outward_m[:, 1], -1.0, 1.0))
    phi = jnp.arctan2(-outward_m[:, 2], outward_m[:, 0]) + jnp.pi
    uv = jnp.stack([phi / (2.0 * jnp.pi), theta / jnp.pi], -1)
    return point, normal, front, uv, ell.material[idx]


# --------------------------------------------------------------------------
# Quads
# --------------------------------------------------------------------------


def _quad_ts(quads, o, d, t_min, t_max):
    """Per-(ray, quad) accepted hit t, BIG where miss. Shapes [N,Q].

    alpha/beta use the triple-product identity: alpha = (p-q)·(v×w),
    beta = (p-q)·(w×u), algebraically equal to the reference's
    w·((p-q)×v) / w·(u×(p-q)) (src/cpu_raytrace/Quad.cpp:30-34).
    """
    n, q, w = quads.normal, quads.q, quads.w
    a_alpha = jnp.cross(quads.v, w)   # [Q,3]
    a_beta = jnp.cross(w, quads.u)    # [Q,3]

    nd = _mm(d, n.T)                       # [N,Q]
    no = _mm(o, n.T)
    # Safe divide: parallel rays (|nd| < eps) are culled below; a literal /0
    # makes inf/NaN flow into the masked select's VJP.
    not_parallel = jnp.abs(nd) >= defs.QUAD_EPS
    t = (quads.d[None, :] - no) / jnp.where(not_parallel, nd, 1.0)
    # p·A = o·A + t (d·A); subtract q·A.
    o_aa = _mm(o, a_alpha.T)
    d_aa = _mm(d, a_alpha.T)
    o_ab = _mm(o, a_beta.T)
    d_ab = _mm(d, a_beta.T)
    q_aa = jnp.sum(q * a_alpha, -1)
    q_ab = jnp.sum(q * a_beta, -1)
    alpha = o_aa + t * d_aa - q_aa[None, :]
    beta = o_ab + t * d_ab - q_ab[None, :]

    tmin = t_min[:, None] if t_min.ndim else t_min
    tmax = t_max[:, None]
    hit = (
        not_parallel                             # parallel cull (Quad.cpp:22)
        & (t >= tmin) & (t <= tmax)              # Interval::Contains — closed
        & (alpha >= 0.0) & (alpha <= 1.0)
        & (beta >= 0.0) & (beta <= 1.0)          # IsInterior (Quad.cpp:8-17)
        & quads.active[None, :]
    )
    return jnp.where(hit, t, BIG)


def _quad_record(quads, o, d, t, idx):
    """Point/normal/uv for the winning quad (src/cpu_raytrace/Quad.cpp:36-42)."""
    n = quads.normal[idx]
    q = quads.q[idx]
    w = quads.w[idx]
    point = o + t[:, None] * d
    pq = point - q
    alpha = jnp.sum(w * jnp.cross(pq, quads.v[idx]), -1)
    beta = jnp.sum(w * jnp.cross(quads.u[idx], pq), -1)
    front = jnp.sum(d * n, -1) < 0.0
    normal = jnp.where(front[:, None], n, -n)
    return point, normal, front, jnp.stack([alpha, beta], -1), quads.material[idx]


# --------------------------------------------------------------------------
# Constant media
# --------------------------------------------------------------------------


def _boundary_interval(media, om, dm, time):
    """Entry/exit ts of the model-space ray against each medium boundary over
    the universe interval (ConstantMedium.cpp:17-26 uses Interval::kUniverse
    then [t1+1e-4, inf)). Returns (t0, t1, valid) with shapes [N,M]."""
    # Sphere boundary: p0 = center0, p1.x = radius; moving via displacement.
    center = media.p0[None, :, :] + time[:, None, None] * media.displacement[None, :, :]
    oc = center - om                                       # [N,M,3]
    a = jnp.sum(dm * dm, -1)
    h = jnp.sum(dm * oc, -1)
    c = jnp.sum(oc * oc, -1) - media.p1[None, :, 0] ** 2
    disc = h * h - a * c
    s_valid = disc > 0.0
    sq = jnp.sqrt(jnp.where(s_valid, disc, 1.0))  # safe sqrt (see _sphere_ts)
    s_t0 = (h - sq) / a
    s_t1 = (h + sq) / a

    # Box boundary: slab test between p0 (min) and p1 (max), AABB::Hit
    # semantics (src/cpu_raytrace/AABB.hpp:34-47). Safe reciprocal: axis-
    # parallel rays keep the slab semantics through the huge-but-finite
    # bound; literal inf would NaN the masked-select VJP.
    dm_safe = jnp.where(jnp.abs(dm) < 1e-12, jnp.where(dm < 0, -1e-12, 1e-12), dm)
    inv = 1.0 / dm_safe
    lo = (media.p0[None, :, :] - om) * inv
    hi = (media.p1[None, :, :] - om) * inv
    b_t0 = jnp.max(jnp.minimum(lo, hi), -1)
    b_t1 = jnp.min(jnp.maximum(lo, hi), -1)
    b_valid = b_t0 < b_t1

    is_sphere = (media.btype == defs.MEDIUM_SPHERE)[None, :]
    t0 = jnp.where(is_sphere, s_t0, b_t0)
    t1 = jnp.where(is_sphere, s_t1, b_t1)
    valid = jnp.where(is_sphere, s_valid, b_valid)
    # Reference requires a *second* hit after t0 + 1e-4 (ConstantMedium.cpp:22).
    valid &= t1 > t0 + defs.MEDIUM_EPS
    return t0, t1, valid


def _media_ts(media, o, d, time, t_min, t_max, u):
    """Per-(ray, medium) stochastic scatter t, BIG where no scatter event.

    ``u`` — [N,M] uniforms for the free-path draw
    (ConstantMedium.cpp:40-48). World rays are pulled into each boundary's
    model space by the baked inverse affine; model direction is renormalized
    exactly like TransformedHittable does (src/cpu_raytrace/Transform.cpp:17),
    and the scatter t is expressed in world units via the model→world length
    ratio (identity for the rigid transforms the corpus uses).
    """
    A = media.inv_model[:, :, :3]                       # [M,3,3]
    b = media.inv_model[:, :, 3]                        # [M,3]
    om = jnp.einsum("mij,nj->nmi", A, o, precision=_HI) + b[None]  # [N,M,3]
    dm_raw = jnp.einsum("mij,nj->nmi", A, d, precision=_HI)
    dm_len = jnp.linalg.norm(dm_raw, axis=-1).clip(1e-12)
    dm = dm_raw / dm_len[..., None]

    t0, t1, valid = _boundary_interval(media, om, dm, time)

    # World t per unit model t: |d| world units advance |dm_raw| model units,
    # i.e. model distance s corresponds to world t = s / |dm_raw| (for unit
    # world dirs). Rigid transforms give scale 1.
    d_len = jnp.linalg.norm(d, axis=-1).clip(1e-12)[:, None]    # [N,1]
    scale = dm_len / d_len                                      # model units per world t
    tmin = t_min[:, None] if t_min.ndim else t_min
    tmax = t_max[:, None]
    # Clamp to the query interval, in model units (ConstantMedium.cpp:28-38).
    e0 = jnp.maximum(jnp.maximum(t0, tmin * scale), 0.0)
    e1 = jnp.minimum(t1, tmax * scale)
    valid &= e0 < e1

    dist_inside = e1 - e0                                # model-space distance
    hit_dist = media.neg_inv_density[None, :] * jnp.log(u.clip(1e-12))
    valid &= hit_dist <= dist_inside
    valid &= media.active[None, :]
    t_model = e0 + hit_dist
    t_world = t_model / scale
    return jnp.where(valid, t_world, BIG)


def _media_record(media, o, d, t, idx):
    """Medium scatter record: arbitrary fixed normal, front_face=true
    (ConstantMedium.cpp:50-55)."""
    point = o + t[:, None] * d
    n = jnp.zeros_like(point).at[:, 0].set(1.0)
    front = jnp.ones(t.shape, bool)
    uv = jnp.zeros((t.shape[0], 2), point.dtype)
    return point, n, front, uv, media.material[idx]


# --------------------------------------------------------------------------
# Combined closest hit
# --------------------------------------------------------------------------


def _sphere_best_bvh(scene, o, d, time, t_min, t_max, max_depth: int,
                     skip_sph):
    """Per-ray best (t, sphere index) via the flattened BVH
    (ops/bvh_traverse.py) — the sublinear path for large scenes on the
    XLA/CPU backend. Same accepted-root semantics as _sphere_ts
    (src/cpu_raytrace/Sphere.cpp:7-26, strict Interval::Surrounds)."""
    from raytrace2.ops import bvh_traverse

    sp = scene.spheres

    def one(oo, dd, tt, lo0, hi0, skip):
        def leaf_fn(prim, lo, hi):
            c = sp.center0[prim] + tt * sp.displacement[prim]
            oc = c - oo
            a = jnp.dot(dd, dd, precision=_HI)
            h = jnp.dot(dd, oc, precision=_HI)
            cc = jnp.dot(oc, oc, precision=_HI) - sp.radius[prim] * sp.radius[prim]
            disc = h * h - a * cc
            has = disc >= 0.0
            sq = jnp.sqrt(jnp.where(has, disc, 0.0))
            r0 = (h - sq) / a
            r1 = (h + sq) / a
            ok0 = (r0 > lo) & (r0 < hi)
            ok1 = (r1 > lo) & (r1 < hi)
            root = jnp.where(ok0, r0, r1)
            return jnp.where(has & (ok0 | ok1) & (prim != skip), root, BIG)

        return bvh_traverse.traverse_one(
            scene.sphere_bvh, leaf_fn, oo, dd, lo0, hi0, max_depth
        )

    bt, bp = jax.vmap(one)(o, d, time, t_min, t_max, skip_sph)
    miss = bp < 0
    return jnp.where(miss, BIG, bt), jnp.where(miss, 0, bp)


def _skip_mask(skip, fam, count):
    """[N, count] True where a ray must not hit record ``i`` of family
    ``fam`` (the surface it is leaving; see closest_hit)."""
    skip_fam, skip_prim = skip
    return (skip_fam == fam)[:, None] & (
        jnp.arange(count, dtype=jnp.int32)[None, :] == skip_prim[:, None])


def closest_hit(scene, o, d, time, u_media=None, t_min=None, t_max=None,
                features=None, skip=None) -> Hit:
    """Closest hit of N rays against the whole scene.

    Args:
      scene: schema.FlatScene.
      o, d: [N,3] origins / directions.
      time: [N] shutter times.
      u_media: [N,M] uniforms for the stochastic constant-medium free path,
          derived per-ray from pixel keys (never from batch position) so the
          result is invariant to sharding layout. None → media treated as
          transparent (only valid when the scene has no active media).
      t_min/t_max: interval; defaults [1e-3, BIG] (RayTracer.cpp:25).
      features: static feature dict (FlatScene feature gates); when
          'has_media' is False the media family is skipped entirely.
      skip: ([N] family, [N] index) of the surface each ray leaves (family
          -1: none; see integrator._make_step), which that ray cannot hit.
          A ray leaving a plane cannot meet it again, nor one leaving a
          convex surface outward; but its f32 origin can land a rounding
          error behind the surface, and t_min alone (the reference's guard)
          does not stop the re-hit of a grazing ray, whose outcome then
          hangs on the last bit of the origin.
    Returns a Hit SoA.
    """
    n = o.shape[0]
    features = features or {}
    if t_min is None:
        t_min = jnp.full((n,), defs.T_MIN)
    if t_max is None:
        t_max = jnp.full((n,), BIG)
    if skip is None:
        skip = (jnp.full((n,), -1, jnp.int32), jnp.zeros((n,), jnp.int32))

    if (
        features.get("use_bvh_spheres", False)
        and getattr(scene, "sphere_bvh", None) is not None
    ):
        bt_s, bi_s = _sphere_best_bvh(
            scene, o, d, time, t_min, t_max,
            int(features["bvh_depth"]),
            jnp.where(skip[0] == 0, skip[1], -1),
        )
    else:
        ts_s = _sphere_ts(scene.spheres, o, d, time, t_min, t_max)
        ts_s = jnp.where(_skip_mask(skip, 0, ts_s.shape[1]), BIG, ts_s)
        bt_s = jnp.min(ts_s, -1)
        bi_s = jnp.argmin(ts_s, -1)
    ts_q = _quad_ts(scene.quads, o, d, t_min, t_max)
    ts_q = jnp.where(_skip_mask(skip, 1, ts_q.shape[1]), BIG, ts_q)
    bt_q = jnp.min(ts_q, -1)
    bi_q = jnp.argmin(ts_q, -1)

    if features.get("has_media", True) and u_media is not None:
        ts_m = _media_ts(scene.media, o, d, time, t_min, t_max, u_media)
    else:
        m = scene.media.btype.shape[0]
        ts_m = jnp.full((n, m), BIG)
    bt_m = jnp.min(ts_m, -1)
    bi_m = jnp.argmin(ts_m, -1)

    has_ell = (features.get("has_ellipsoids", False)
               and getattr(scene, "ellipsoids", None) is not None)
    if has_ell:
        ts_e = _ellipsoid_ts(scene.ellipsoids, o, d, time, t_min, t_max)
        ts_e = jnp.where(_skip_mask(skip, 3, ts_e.shape[1]), BIG, ts_e)
        bt_e = jnp.min(ts_e, -1)
        bi_e = jnp.argmin(ts_e, -1)
    else:
        bt_e = jnp.full((n,), BIG)
        bi_e = jnp.zeros((n,), jnp.int32)

    fam_ts = jnp.stack([bt_s, bt_q, bt_m, bt_e], -1)      # [N,4]
    fam = jnp.argmin(fam_ts, -1).astype(jnp.int32)        # winning family
    t = jnp.min(fam_ts, -1)
    valid = t < BIG

    rec_s = _sphere_record(scene.spheres, o, d, time, bt_s, bi_s)
    rec_q = _quad_record(scene.quads, o, d, bt_q, bi_q)
    rec_m = _media_record(scene.media, o, d, bt_m, bi_m)
    rec_e = (_ellipsoid_record(scene.ellipsoids, o, d, time, bt_e, bi_e)
             if has_ell else rec_s)

    def pick(i):
        def sel(f, a, b):
            return jnp.where(f[(...,) + (None,) * (a.ndim - 1)], a, b)

        return tuple(
            sel(fam == 0, s, sel(fam == 1, q_, sel(fam == 2, m_, e_)))
            for s, q_, m_, e_ in zip(rec_s, rec_q, rec_m, rec_e)
        )[i]

    point, normal, front, uv, mat = (pick(i) for i in range(5))
    # Sanitize missed rays: their record is never *used* (masked by `valid`)
    # but it IS computed through shading — t=BIG points overflow texture
    # math (e.g. turbulence doubles coordinates, ConstantMedium-scale
    # transforms) into inf/NaN that would poison masked-select VJPs.
    v3 = valid[:, None]
    point = jnp.where(v3, point, 0.0)
    normal = jnp.where(v3, normal, jnp.zeros_like(normal).at[:, 2].set(1.0))
    uv = jnp.where(v3, uv, 0.0)
    mat = jnp.where(valid, mat, 0)
    prim = jnp.stack([bi_s, bi_q, bi_m, bi_e], -1).astype(jnp.int32)
    prim = jnp.take_along_axis(prim, fam[:, None], -1)[:, 0]
    return Hit(valid=valid, t=t, point=point, normal=normal,
               front_face=front, uv=uv, material=mat,
               fam=jnp.where(valid, fam, -1), prim=prim)
