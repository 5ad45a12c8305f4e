"""Counter-based RNG and analytic samplers.

The reference uses a stateful ``thread_local std::minstd_rand`` seeded from
``random_device`` (src/cpu_raytrace/Math.hpp:9-13) and rejection-sampled unit
sphere/disk draws (Math.hpp:26-41). Neither shape works under jit: state
breaks purity and rejection loops break static tracing. Here every random draw comes
from a threefry key that is a **pure function of (seed, pixel, sample,
bounce)** — never of device id — so an N-chip render equals a 1-chip render in
distribution regardless of sharding layout (SURVEY.md §7 "RNG
reproducibility"). Rejection loops are replaced by exact analytic samplers of
the same distributions.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from raytrace2 import defs


def pixel_sample_key(seed, pixel_flat, sample_idx):
    """Base key for one (pixel, sample) pair.

    ``pixel_flat`` / ``sample_idx`` may be traced arrays; the construction is
    a pure function of its inputs (replaces thread_local seeding,
    src/cpu_raytrace/Math.hpp:11).
    """
    key = jax.random.key(seed)
    key = jax.random.fold_in(key, sample_idx)
    return jax.random.fold_in(key, pixel_flat)


def bounce_key(base_key, bounce_idx):
    """Per-bounce subkey derivation."""
    return jax.random.fold_in(base_key, bounce_idx)


def uniform(key, shape=()):
    """U[0,1) — analog of math::RandReal (src/cpu_raytrace/Math.hpp:15-24)."""
    return jax.random.uniform(key, shape)


def unit_vec3(key, shape=()):
    """Uniform direction on the unit sphere.

    Replaces the rejection loop ``RandUnitVec3`` (src/cpu_raytrace/
    Math.hpp:43) with the exact gaussian-normalize construction.
    Returns shape ``shape + (3,)``.
    """
    g = jax.random.normal(key, shape + (3,))
    return g / jnp.linalg.norm(g, axis=-1, keepdims=True).clip(1e-12)


def in_unit_sphere(key, shape=()):
    """Uniform point inside the unit sphere (replaces the rejection loop
    ``RandInUnitSphere``, src/cpu_raytrace/Math.hpp:26-32): direction uniform
    on the sphere scaled by U^(1/3)."""
    k1, k2 = jax.random.split(key)
    d = unit_vec3(k1, shape)
    r = jax.random.uniform(k2, shape + (1,)) ** (1.0 / 3.0)
    return d * r


def in_unit_disk(key, shape=()):
    """Uniform point in the unit disk, z=0 (replaces ``RandInUnitDisk``,
    src/cpu_raytrace/Math.hpp:34-41) via the polar map r=sqrt(U)."""
    k1, k2 = jax.random.split(key)
    r = jnp.sqrt(jax.random.uniform(k1, shape))
    theta = 2.0 * jnp.pi * jax.random.uniform(k2, shape)
    return jnp.stack([r * jnp.cos(theta), r * jnp.sin(theta), jnp.zeros_like(r)], axis=-1)


def unit_vec3_from_uniforms(u1, u2):
    """Exact uniform sphere direction from two uniforms: z = 1-2u,
    φ = 2πu — one threefry draw instead of three gaussians. Shapes broadcast;
    returns [..., 3]. (1e-12 floor matches the megakernel's NaN-safe form —
    sqrt'(0)=inf would poison reverse-mode cotangents at z=±1.)"""
    z = 1.0 - 2.0 * u1
    phi = (2.0 * jnp.pi) * u2
    r = jnp.sqrt(jnp.maximum(1.0 - z * z, 1e-12))
    return jnp.stack([r * jnp.cos(phi), r * jnp.sin(phi), z], axis=-1)


def disk_from_uniforms(u1, u2):
    """Uniform unit-disk point (z=0) from two uniforms via the polar map."""
    r = jnp.sqrt(u1)
    theta = (2.0 * jnp.pi) * u2
    return jnp.stack([r * jnp.cos(theta), r * jnp.sin(theta), jnp.zeros_like(r)], axis=-1)


def bounce_uniforms(keys, bounce_idx, n_draws: int):
    """One threefry draw per ray for a whole bounce: [N, n_draws] uniforms
    from fold_in(key, bounce). This is THE per-bounce RNG entry point — two
    hash invocations per ray per bounce (fold + draw) instead of one per
    consumed random number."""
    return jax.vmap(
        lambda k: draw_uniforms(jax.random.fold_in(k, bounce_idx), n_draws)
    )(keys)


def draw_uniforms(key, n: int):
    """[n] U[0,1) from one key: float32 draws, in the working precision
    (defs.REAL) — the float64 verification mode then traces the same
    random numbers as float32 (a float64 draw consumes other bits)."""
    return jax.random.uniform(key, (n,), jnp.float32).astype(defs.REAL)


def murmur_mix(x):
    """murmur3 fmix32 (vectorized uint32) — the cheap counter-hash used by
    the megakernel path; ~10 integer ops vs ~40+ rounds for threefry."""
    x = x ^ (x >> jnp.uint32(16))
    x = x * jnp.uint32(0x85EBCA6B)
    x = x ^ (x >> jnp.uint32(13))
    x = x * jnp.uint32(0xC2B2AE35)
    x = x ^ (x >> jnp.uint32(16))
    return x


def murmur_uniforms(mega_seed, pixel_ids, ctrs):
    """U[0,1) draws from the megakernel's counter-hash family: a pure
    function of (seed·sample, pixel id, counter) — layout-invariant like the
    threefry path, at a fraction of the cost.

    Args:
      mega_seed: traced i32 scalar (seed·1000003 + sample).
      pixel_ids: [N] i32; ctrs: tuple of static ints (draw counters).
    Returns [N, len(ctrs)] f32.
    """
    # Delegate to the traced-counter form: the construction is parity-
    # critical with the kernel (megakernel.sample_key/_uniform) and must live in
    # exactly one place. `c.astype(uint32)` of a static int equals
    # `jnp.uint32(c)` bit-for-bit.
    return murmur_uniforms_at(mega_seed, pixel_ids, ctrs)


def murmur_uniforms_at(mega_seed, pixel_ids, ctrs):
    """murmur_uniforms with TRACED counters (e.g. ``bounce*draws_pb + k``
    inside the XLA bounce loop): the exact per-draw stream of the
    megakernel, usable from the XLA path for matched-RNG cross-backend
    goldens (features["rng_impl"]="murmur").

    Args: ctrs: sequence of traced/static i32 scalars. Returns [N, len].
    """
    slot = pixel_ids.astype(jnp.uint32)
    key = murmur_mix(
        slot * jnp.uint32(0x9E3779B9)
        ^ murmur_mix(jnp.asarray(mega_seed).astype(jnp.uint32))
    )
    cols = []
    for c in ctrs:
        cu = jnp.asarray(c).astype(jnp.uint32)
        bits = murmur_mix(
            key ^ murmur_mix(cu * jnp.uint32(0x9E3779B9) + jnp.uint32(1))
        )
        cols.append((bits >> jnp.uint32(8)).astype(jnp.float32) * (1.0 / (1 << 24)))
    return jnp.stack(cols, axis=-1)


# Camera draws use counters far above any bounce counter
# (bounce·draws_pb + k stays < ~2^16 for max_depth 50).
CAMERA_CTR_BASE = 0x40000000


def on_hemisphere(key, normal):
    """Uniform direction on the hemisphere around ``normal``
    (src/cpu_raytrace/Math.hpp:45-51)."""
    d = unit_vec3(key, normal.shape[:-1])
    return jnp.where(jnp.sum(d * normal, -1, keepdims=True) > 0.0, d, -d)
