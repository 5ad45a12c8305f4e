"""Material shading: emission + scatter for a batch of hits.

The reference dispatches a ``std::variant`` per bounce with CRTP
Scatter/Emit (src/cpu_raytrace/Material.hpp:12-29, RayTracer.cpp:32-40).
Batched form: gather the material row per ray, compute each branch's
(cheap, elementwise) result, and combine with masked selects — no
divergence. Distributions match the reference samplers exactly
(analytic replacements, see ops/rng.py).
"""

from __future__ import annotations

from typing import NamedTuple

import jax.numpy as jnp

from raytrace2 import defs
from raytrace2.ops import textures as tex_ops


class Scatter(NamedTuple):
    emitted: jnp.ndarray      # [N,3] emission at the hit (DiffuseLight::Emit)
    did_scatter: jnp.ndarray  # [N] bool
    direction: jnp.ndarray    # [N,3] next ray direction (NOT normalized,
                              #        matching the reference's conventions)
    attenuation: jnp.ndarray  # [N,3]


def reflect(v, n):
    """math::Reflect (src/cpu_raytrace/Math.hpp:66)."""
    return v - 2.0 * jnp.sum(v * n, -1, keepdims=True) * n


def refract(uv, n, etai_over_etat):
    """math::Refract (src/cpu_raytrace/Math.hpp:68-73); ``uv`` unit."""
    cos_theta = jnp.minimum(jnp.sum(-uv * n, -1, keepdims=True), 1.0)
    r_out_perp = etai_over_etat * (uv + cos_theta * n)
    k = 1.0 - jnp.sum(r_out_perp * r_out_perp, -1, keepdims=True)
    r_out_parallel = -jnp.sqrt(jnp.abs(k)) * n
    return r_out_perp + r_out_parallel


def schlick(cosine, refraction_index):
    """Schlick reflectance approximation (src/cpu_raytrace/Material.cpp:21-25)."""
    r0 = (1.0 - refraction_index) / (1.0 + refraction_index)
    r0 = r0 * r0
    return r0 + (1.0 - r0) * (1.0 - cosine) ** 5


def _normalize(v):
    return v / jnp.linalg.norm(v, axis=-1, keepdims=True).clip(1e-12)


def shade(scene, features, hit, d_in, u_vec, u_frsn) -> Scatter:
    """Emission + scatter for every ray's hit record.

    Args:
      scene: FlatScene; features: static feature dict.
      hit: intersect.Hit SoA; d_in: [N,3] incoming directions.
      u_vec: [N,3] unit-sphere directions (shared by lambertian fuzz/metal/
        isotropic — mutually exclusive per ray); u_frsn: [N] uniforms for the
        dielectric reflect/refract choice. Both come from the integrator's
        single per-bounce draw (ops/rng.bounce_uniforms).
    """
    mats = scene.materials
    mtype = mats.mtype[hit.material]
    albedo = mats.albedo[hit.material]
    param = mats.param[hit.material]
    tex_idx = mats.tex[hit.material]

    texval = tex_ops.texture_value(scene.textures, tex_idx, hit.uv, hit.point, features)

    # Lambertian / texture-lambertian: dir = normal + unit vec, degenerate →
    # normal (Material.cpp:47-56, 58-69).
    lamb_dir = hit.normal + u_vec
    degenerate = jnp.all(jnp.abs(lamb_dir) < defs.NEAR_ZERO_EPS, -1, keepdims=True)
    lamb_dir = jnp.where(degenerate, hit.normal, lamb_dir)

    # Metal: normalize(reflect) + fuzz · unit vec (Material.cpp:10-17).
    metal_dir = _normalize(reflect(d_in, hit.normal)) + param[:, None] * u_vec

    # Dielectric (Material.cpp:29-45). param is the refraction index only on
    # dielectric rows; guard the reciprocal for the others (masked out below).
    param_safe = jnp.where(param > 0.0, param, 1.0)
    ri = jnp.where(hit.front_face, 1.0 / param_safe, param_safe)
    unit_d = _normalize(d_in)
    cos_t = jnp.minimum(jnp.sum(-unit_d * hit.normal, -1), 1.0)
    sin_t = jnp.sqrt(jnp.maximum(1.0 - cos_t * cos_t, 0.0))
    cannot_refract = ri * sin_t > 1.0
    reflect_choice = cannot_refract | (schlick(cos_t, ri) > u_frsn)
    diel_dir = jnp.where(
        reflect_choice[:, None],
        reflect(unit_d, hit.normal),
        refract(unit_d, hit.normal, ri[:, None]),
    )

    # Isotropic (volume scattering): uniform sphere dir (Material.cpp:76-83).
    iso_dir = u_vec

    is_lamb = (mtype == defs.MAT_LAMBERTIAN) | (mtype == defs.MAT_TEXTURE)
    is_metal = mtype == defs.MAT_METAL
    is_diel = mtype == defs.MAT_DIELECTRIC
    is_iso = mtype == defs.MAT_ISOTROPIC
    is_light = mtype == defs.MAT_DIFFUSE_LIGHT

    direction = jnp.where(
        is_lamb[:, None], lamb_dir,
        jnp.where(is_metal[:, None], metal_dir,
                  jnp.where(is_diel[:, None], diel_dir, iso_dir)),
    )
    uses_tex = (mtype == defs.MAT_TEXTURE) | is_iso
    attenuation = jnp.where(
        is_diel[:, None], jnp.ones_like(albedo),
        jnp.where(uses_tex[:, None], texval, albedo),
    )
    emitted = jnp.where(is_light[:, None], texval, jnp.zeros_like(texval))
    did_scatter = ~is_light
    return Scatter(emitted=emitted, did_scatter=did_scatter,
                   direction=direction, attenuation=attenuation)
