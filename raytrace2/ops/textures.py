"""Texture evaluation over SoA texture tables.

The reference dispatches a ``std::variant`` per lookup with recursive checker
children (src/cpu_raytrace/Texture.cpp:7-22). Here every ray evaluates the
type-selected value with masked selects; checker children resolve
recursively to the scene's actual nesting depth (features["has_checker"]
carries it; the loader rejects cyclic checker graphs). Perlin/turbulence use the per-texture
permutation + gradient tables baked by the scene compiler
(src/cpu_raytrace/PerlinNoiseGen.cpp:66-103 semantics, validated against the
NumPy oracle in scene/perlin.py).
"""

from __future__ import annotations

import jax.numpy as jnp

from raytrace2 import defs


def perlin_noise(perm, grad, tex_idx, p):
    """Reference Perlin evaluation (PerlinNoiseGen.cpp:66-88 + PerlinInterp
    :10-26) for a batch of points.

    Args:
      perm: [L,3,256] i32 permutation tables; grad: [L,256,3] f32 gradients.
      tex_idx: [N] i32 texture row per point; p: [N,3] sample points.
    Returns [N] noise in [-1, 1].
    """
    pf = jnp.floor(p)
    uvw = p - pf
    ijk = pf.astype(jnp.int32)
    u, v, w = uvw[:, 0], uvw[:, 1], uvw[:, 2]
    # Hermite smoothing of the interpolation weights (PerlinInterp :11-13).
    uu = u * u * (3.0 - 2.0 * u)
    vv = v * v * (3.0 - 2.0 * v)
    ww = w * w * (3.0 - 2.0 * w)

    accum = jnp.zeros(p.shape[0], p.dtype)
    for di in range(2):
        for dj in range(2):
            for dk in range(2):
                px = perm[tex_idx, 0, (ijk[:, 0] + di) & 255]
                py = perm[tex_idx, 1, (ijk[:, 1] + dj) & 255]
                pz = perm[tex_idx, 2, (ijk[:, 2] + dk) & 255]
                g = grad[tex_idx, px ^ py ^ pz]              # [N,3]
                weight = uvw - jnp.array([di, dj, dk], p.dtype)
                wt = (
                    (di * uu + (1 - di) * (1.0 - uu))
                    * (dj * vv + (1 - dj) * (1.0 - vv))
                    * (dk * ww + (1 - dk) * (1.0 - ww))
                )
                accum = accum + wt * jnp.sum(g * weight, -1)
    return accum


def turbulence(perm, grad, tex_idx, p, depth: int = 7):
    """|sum_k 0.5^k noise(2^k p)| (PerlinNoiseGen.cpp:52-64)."""
    accum = jnp.zeros(p.shape[0], p.dtype)
    temp = p
    weight = 1.0
    for _ in range(depth):
        accum = accum + weight * perlin_noise(perm, grad, tex_idx, temp)
        weight *= 0.5
        temp = temp * 2.0
    return jnp.abs(accum)


def _noise_value(textures, idx, p):
    """Noise texture value (Texture.cpp:13-22)."""
    albedo = textures.albedo[idx]
    scale = textures.scale[idx][:, None]
    marble = 0.5 * (
        1.0 + jnp.sin(scale[:, 0] * p[:, 2] + 10.0 * turbulence(textures.perm, textures.grad, idx, p))
    )
    perl = 0.5 * (1.0 + perlin_noise(textures.perm, textures.grad, idx, scale * p))
    val = jnp.where(
        (textures.noise_type[idx] == defs.NOISE_MARBLE)[:, None],
        marble[:, None],
        perl[:, None],
    )
    return albedo * val


def _leaf_value(textures, idx, p, features):
    """Texture value assuming ``idx`` rows are solid or noise."""
    solid = textures.albedo[idx]
    if not features.get("has_noise", True):
        return solid
    ttype = textures.ttype[idx]
    noise = _noise_value(textures, idx, p)
    return jnp.where((ttype == defs.TEX_NOISE)[:, None], noise, solid)


def texture_value(textures, tex_idx, uv, p, features):
    """Full texture dispatch for a batch of shading points.

    ``features`` is a static dict (from scene.features()) gating whole
    texture classes out of the trace when the scene doesn't use them.
    ``uv`` is accepted for interface parity; no corpus texture samples it.
    """
    del uv
    depth = int(features.get("has_checker", 1))  # checker nesting depth
    if not depth:
        return _leaf_value(textures, tex_idx, p, features)
    idx = tex_idx
    for _ in range(depth):
        ttype = textures.ttype[idx]
        # Checker parity on floor(inv_scale * p) (Texture.cpp:7-11). C++
        # ``%`` keeps the sign of the dividend, so (x+y+z) % 2 == 0 accepts
        # -2, 0, ...; test parity of the absolute value instead. Checkers
        # recurse to arbitrary finite depth like the reference's
        # variant dispatch (cycles are rejected at load).
        i3 = jnp.floor(textures.inv_scale[idx][:, None] * p).astype(jnp.int32)
        even = (jnp.abs(i3[:, 0] + i3[:, 1] + i3[:, 2]) % 2) == 0
        child = jnp.where(even, textures.even[idx], textures.odd[idx])
        idx = jnp.where(ttype == defs.TEX_CHECKER, child, idx)
    return _leaf_value(textures, idx, p, features)
