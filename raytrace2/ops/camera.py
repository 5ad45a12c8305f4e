"""Differentiable camera: ray generation for a pixel grid.

Reimplements the reference camera (src/cpu_raytrace/Camera.hpp:16-67) as a
pure function: derived quantities (orthonormal basis, viewport, pixel deltas,
defocus disk) are recomputed from the raw ``CameraParams`` pytree each trace —
they are a handful of scalars, and deriving them inside the traced function
keeps the whole camera differentiable (no dirty-flag caching state).

Rays for a whole (H, W) grid and one stratified sample index are produced at
once as SoA arrays [N,3]; stratification follows the reference exactly: sample
``s`` maps to the cell ``(s % √spp, (s / √spp) % √spp)`` of a √spp×√spp grid
(src/cpu_raytrace/RayTracer.cpp:57-60), jittered uniformly within the cell
(Camera.hpp:52-58), with defocus-disk origin sampling (Camera.hpp:61,133-136)
and a uniform shutter time in [0,1) for motion blur (Camera.hpp:63).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from raytrace2 import defs

from raytrace2.ops import rng


def _normalize(v):
    return v / jnp.linalg.norm(v, axis=-1, keepdims=True).clip(1e-12)


def camera_frame(cam, width: int, height: int):
    """Derived camera quantities (Camera::Update, Camera.hpp:16-48).

    Returns a dict of scalars/vec3s: pixel00, pixel_delta_u/v, center,
    defocus_disk_u/v, defocus_angle.
    """
    theta = jnp.radians(cam.vfov)
    h = jnp.tan(theta / 2.0)
    w = _normalize(cam.center - cam.look_at)
    u = _normalize(jnp.cross(cam.vup, w))
    v = jnp.cross(w, u)

    viewport_height = 2.0 * h * cam.focus_dist
    viewport_width = viewport_height * (width / height)
    viewport_u = viewport_width * u
    viewport_v = viewport_height * v
    pixel_delta_u = viewport_u / width
    pixel_delta_v = viewport_v / height
    upper_left = cam.center - w * cam.focus_dist - viewport_u / 2.0 - viewport_v / 2.0
    pixel00 = upper_left + 0.5 * (pixel_delta_u + pixel_delta_v)

    defocus_radius = cam.focus_dist * jnp.tan(jnp.radians(cam.defocus_angle / 2.0))
    return {
        "center": cam.center,
        "pixel00": pixel00,
        "pixel_delta_u": pixel_delta_u,
        "pixel_delta_v": pixel_delta_v,
        "defocus_disk_u": u * defocus_radius,
        "defocus_disk_v": v * defocus_radius,
        "defocus_angle": cam.defocus_angle,
    }


def stratum(sample_idx, sqrt_spp):
    """Stratum cell for progressive sample ``sample_idx``
    (src/cpu_raytrace/RayTracer.cpp:57-60)."""
    s_i = sample_idx % sqrt_spp
    s_j = (sample_idx // sqrt_spp) % sqrt_spp
    return s_i, s_j


def generate_rays(cam, width: int, height: int, sample_idx, sqrt_spp, keys,
                  pixel_ids=None, uniforms=None):
    """Rays for a set of pixels at one stratified sample.

    Args:
      cam: schema.CameraParams pytree.
      sample_idx: traced int32 — progressive sample number.
      sqrt_spp: static int — stratification grid side (int(sqrt(spp))).
      keys: [N] base rng keys, one per pixel (row-major flat id y*W+x).
      pixel_ids: [N] i32 flat pixel ids; defaults to the full grid. Passing
        an explicit subset is how sharded renderers give each device its
        pixel tile while keys/jitter stay a pure function of pixel identity.

    Returns (origins[N,3], dirs[N,3], times[N]). Directions are normalized
    (Camera.hpp:66).
    """
    frame = camera_frame(cam, width, height)
    if pixel_ids is None:
        pixel_ids = jnp.arange(width * height, dtype=jnp.int32)
    xs = (pixel_ids % width).astype(defs.REAL)
    ys = (pixel_ids // width).astype(defs.REAL)

    s_i, s_j = stratum(sample_idx, sqrt_spp)
    if uniforms is None:
        # One threefry draw per ray covers jitter(2) + defocus disk(2) +
        # time(1). Camera draw id 0x7FFFFFFF is disjoint from bounce ids.
        u = jax.vmap(
            lambda k: rng.draw_uniforms(jax.random.fold_in(k, 0x7FFFFFFF), 5)
        )(keys)
    else:
        u = uniforms  # [N,5] from the caller's (cheaper) generator
    # Stratified jitter inside the (s_i, s_j) cell (Camera.hpp:52-58).
    recip = 1.0 / sqrt_spp
    px = (s_i + u[:, 0]) * recip - 0.5
    py = (s_j + u[:, 1]) * recip - 0.5

    pixel_center = (
        frame["pixel00"][None, :]
        + (xs + px)[:, None] * frame["pixel_delta_u"][None, :]
        + (ys + py)[:, None] * frame["pixel_delta_v"][None, :]
    )

    disk = rng.disk_from_uniforms(u[:, 2], u[:, 3])
    defocus_origin = (
        frame["center"][None, :]
        + disk[:, 0:1] * frame["defocus_disk_u"][None, :]
        + disk[:, 1:2] * frame["defocus_disk_v"][None, :]
    )
    origins = jnp.where(frame["defocus_angle"] > 0.0, defocus_origin, frame["center"][None, :])

    dirs = _normalize(pixel_center - origins)

    times = u[:, 4]
    return origins, dirs, times
