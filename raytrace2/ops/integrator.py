"""Wavefront path integrator: iterative bounce loop over SoA ray state.

Replaces the reference's recursive ``RayColor``
(src/cpu_raytrace/RayTracer.cpp:20-45) with the iterative
radiance/throughput form the reference author sketched for the GPU
(src/shaders/rtiow.fs.glsl:264-290), generalized with emission:

    radiance   += throughput * emitted
    throughput *= attenuation

advanced under ``lax.while_loop`` (early exit when every ray has terminated)
or ``lax.scan`` (differentiable; fixed trip count) over at most ``max_depth``
bounces. Semantics match the recursion exactly: a miss adds
``throughput * background`` (RayTracer.cpp:23-26); a ray that survives
``max_depth`` scatters contributes nothing further (depth cap,
RayTracer.cpp:21-22).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp

from raytrace2 import defs
from raytrace2.ops import camera as camera_ops
from raytrace2.ops import intersect, materials, rng


# Per-bounce uniform layout: [0:2] unit-sphere dir, [2] fresnel choice,
# [3:3+M] media free-path draws — all from ONE threefry draw per ray
# (rng.bounce_uniforms); a pure function of (pixel, sample, bounce), never of
# batch position (SURVEY.md §7 RNG reproducibility).


def _make_step(scene, features, background, mega_seed=None):
    """Build the per-bounce transition for a (possibly compacted) ray set.

    The step closes over nothing ray-indexed: keys/time ride inside the
    state so compaction can gather them along with the rays.

    ``features["rng_impl"]=="murmur"`` (requires ``mega_seed``): draw from
    the megakernel's exact counter-hash streams — ``st["keys"]`` then
    holds i32 PIXEL IDS instead of threefry keys. With identical streams
    the two backends compute the same paths, so cross-backend goldens
    measure f32 arithmetic divergence, not MC noise.
    """
    num_media = scene.media.btype.shape[0]
    has_media = features.get("has_media", True)
    use_murmur = features.get("rng_impl") == "murmur" and mega_seed is not None
    # The kernel's per-bounce counter stride: 3 scatter draws + one per
    # ACTIVE medium (megakernel.py draws_pb).
    n_med_active = (features.get("mega_sizes") or (0,) * 6)[4]

    def step(st):
        if use_murmur:
            draws_pb = 3 + (n_med_active if has_media else 0)
            pixel_ids = st["keys"]
            bctr = st["bounce"] * draws_pb
            ctrs = [bctr, bctr + 1, bctr + 2] + (
                [bctr + 3 + m for m in range(n_med_active)] if has_media else []
            )
            u = rng.murmur_uniforms_at(mega_seed, pixel_ids, ctrs)
            if has_media and num_media > n_med_active:
                # Padded (inactive) media rows still consume a lane in the
                # dense sweep; give them a dead draw.
                u = jnp.concatenate(
                    [u, jnp.full((u.shape[0], num_media - n_med_active), 0.5)],
                    axis=-1,
                )
        else:
            n_draws = 3 + (num_media if has_media else 0)
            u = rng.bounce_uniforms(st["keys"], st["bounce"], n_draws)
        u_media = u[:, 3:] if has_media else None
        hit = intersect.closest_hit(
            scene, st["o"], st["d"], st["time"], u_media, features=features,
            skip=(st["skip_fam"], st["skip_prim"]),
        )
        u_vec = rng.unit_vec3_from_uniforms(u[:, 0], u[:, 1])
        sc = materials.shade(scene, features, hit, st["d"], u_vec, u[:, 2])

        miss = st["alive"] & ~hit.valid
        hit_live = st["alive"] & hit.valid
        scatter_live = hit_live & sc.did_scatter

        radiance = st["radiance"]
        radiance = radiance + jnp.where(
            miss[:, None], st["throughput"] * background[None, :], 0.0
        )
        radiance = radiance + jnp.where(
            hit_live[:, None], st["throughput"] * sc.emitted, 0.0
        )
        throughput = jnp.where(
            scatter_live[:, None], st["throughput"] * sc.attenuation, st["throughput"]
        )
        o_new = jnp.where(scatter_live[:, None], hit.point, st["o"])
        d_new = jnp.where(scatter_live[:, None], sc.direction, st["d"])
        # The surface the next ray leaves, which it cannot hit (see
        # intersect.closest_hit): a plane always; a sphere or ellipsoid
        # when the ray leaves it outward.
        outward = jnp.where(hit.front_face[:, None], hit.normal, -hit.normal)
        leaves_out = jnp.sum(jax.lax.stop_gradient(sc.direction * outward), -1) > 0.0
        skip = scatter_live & ((hit.fam == 1) | (
            ((hit.fam == 0) | (hit.fam == 3)) & leaves_out))
        return dict(
            st,
            o=o_new,
            d=d_new,
            throughput=throughput,
            radiance=radiance,
            alive=scatter_live,
            bounce=st["bounce"] + 1,
            skip_fam=jnp.where(skip, hit.fam, -1),
            skip_prim=hit.prim,
        )

    return step


def trace_rays(scene, features, o, d, time, keys, max_depth: int,
               differentiable: bool = False, mega_seed=None):
    """Trace N rays to completion; returns radiance [N,3].

    Args:
      scene: FlatScene on device; features: static gate dict.
      o, d, time: ray SoA ([N,3], [N,3], [N]).
      keys: [N] per-(pixel,sample) base keys.
      max_depth: static bounce cap (AppSettings.max_depth, Settings.hpp:9).
      differentiable: use a scan (reverse-mode differentiable) instead of the
        compacting while-loop fast path.

    Fast path = **phased wavefront compaction**. The lockstep loop's cost is
    (iterations until the LAST ray dies) × full width, but Cornell's alive
    fraction decays fast (mean path ≈ 6.7 bounces vs a 50-bounce cap →
    ~13% lane efficiency). Each phase runs the masked loop only while the
    alive count exceeds the next phase's capacity, then gathers the
    survivors (with their keys — RNG streams are untouched, results are
    bitwise identical) into a buffer `compaction_ratio`× smaller and
    continues. Work drops from depth·N to ≈ Σ phase_len·phase_width.
    """
    if differentiable:
        # The BVH walk (while_loop) is not reverse-differentiable; gradients
        # take the dense sweep. Discrete hit SELECTION is detached either way
        # (see grad.py), so the estimator is unchanged.
        features = dict(features)
        features.pop("use_bvh_spheres", None)

    n = o.shape[0]
    background = scene.background
    step = _make_step(scene, features, background, mega_seed=mega_seed)

    state = dict(
        o=o,
        d=d,
        time=time,
        keys=keys,
        throughput=jnp.ones((n, 3), o.dtype),
        radiance=jnp.zeros((n, 3), o.dtype),
        alive=jnp.ones((n,), bool),
        bounce=jnp.int32(0),
        skip_fam=jnp.full((n,), -1, jnp.int32),
        skip_prim=jnp.zeros((n,), jnp.int32),
    )

    if differentiable:
        def scan_body(st, _):
            return step(st), None
        state, _ = jax.lax.scan(scan_body, state, None, length=max_depth)
        return state["radiance"]

    compaction_ratio = int(features.get("compaction_ratio", 8))
    num_phases = int(features.get("compaction_phases", 3))

    radiance_full = jnp.zeros((n, 3), o.dtype)
    idx_map = jnp.arange(n, dtype=jnp.int32)
    width = n
    for phase in range(num_phases):
        last = phase == num_phases - 1 or width // compaction_ratio < 256
        cap_next = 0 if last else width // compaction_ratio

        state = jax.lax.while_loop(
            lambda st, cap=cap_next: (st["bounce"] < max_depth)
            & (jnp.sum(st["alive"]) > cap),
            step,
            state,
        )
        radiance_full = radiance_full.at[idx_map].add(state["radiance"])
        if last:
            break
        # Compact: stable-partition alive rays to the front; dead slots that
        # ride along have alive=False and contribute nothing further.
        order = jnp.argsort(~state["alive"], stable=True)[:cap_next]
        idx_map = idx_map[order]
        state = dict(
            o=state["o"][order],
            d=state["d"][order],
            time=state["time"][order],
            keys=state["keys"][order],
            throughput=state["throughput"][order],
            radiance=jnp.zeros((cap_next, 3), o.dtype),
            alive=state["alive"][order],
            bounce=state["bounce"],
            skip_fam=state["skip_fam"][order],
            skip_prim=state["skip_prim"][order],
        )
        width = cap_next
    return radiance_full


def render_sample(scene, features, width: int, height: int, sample_idx, seed,
                  max_depth: int, sqrt_spp: int, chunk_size: int | None = None,
                  differentiable: bool = False):
    """One progressive stratified sample for every pixel → [H,W,3] radiance.

    The direct analog of RayTracer::Update (src/cpu_raytrace/
    RayTracer.cpp:55-70), minus accumulation (the caller owns the
    accumulator). Rays are processed in chunks under ``lax.map`` to bound the
    [chunk, P] intersection intermediates resident at once.
    """
    n = width * height
    pixel_ids = jnp.arange(n, dtype=jnp.int32)

    # Counter-hash seed of this (seed, sample): the megakernel's streams.
    mega_seed = jnp.int32(seed) * jnp.int32(1000003) + jnp.asarray(sample_idx, jnp.int32)
    if features.get("rng_impl") == "murmur":
        # XLA bounce loop on the megakernel's exact RNG streams (the plain
        # reference the kernel is checked against; see _make_step). Keys
        # carry pixel ids.
        cam_u = rng.murmur_uniforms(
            mega_seed, pixel_ids,
            tuple(rng.CAMERA_CTR_BASE + k for k in range(5)),
        )
        keys = pixel_ids
        o, d, time = camera_ops.generate_rays(
            scene.camera, width, height, sample_idx, sqrt_spp, None,
            uniforms=cam_u,
        )
    else:
        keys = jax.vmap(lambda p: rng.pixel_sample_key(seed, p, sample_idx))(pixel_ids)
        o, d, time = camera_ops.generate_rays(
            scene.camera, width, height, sample_idx, sqrt_spp, keys
        )

    tracer = functools.partial(
        trace_rays, scene, features, max_depth=max_depth,
        differentiable=differentiable, mega_seed=mega_seed,
    )
    if chunk_size is None or chunk_size >= n:
        radiance = tracer(o, d, time, keys)
    else:
        if n % chunk_size:
            pad = chunk_size - n % chunk_size
            o = jnp.pad(o, ((0, pad), (0, 0)))
            d = jnp.pad(d, ((0, pad), (0, 0)), constant_values=1.0)
            time = jnp.pad(time, (0, pad))
            keys = jnp.concatenate([keys, keys[:pad]])
        chunks = o.shape[0] // chunk_size

        def chunked(args):
            return tracer(*args)

        radiance = jax.lax.map(
            chunked,
            (
                o.reshape(chunks, chunk_size, 3),
                d.reshape(chunks, chunk_size, 3),
                time.reshape(chunks, chunk_size),
                keys.reshape(chunks, chunk_size),
            ),
        ).reshape(-1, 3)[:n]
    return radiance.reshape(height, width, 3)


def _render_batch_megakernel(scene, features, width, height, sample0,
                             n_samples, seed, max_depth, sqrt_spp):
    """Radiance SUM over ``n_samples`` progressive samples, [H,W,3], from
    one launch of the path-regeneration kernel (ops/pallas/megakernel.py):
    every lane owns a pixel and regenerates its next sample in-kernel."""
    from raytrace2.ops.pallas import megakernel as mk

    n = width * height
    sizes = tuple(features["mega_sizes"])
    table = mk.pack_table(scene, sizes, mk.header(
        scene, width, height, sample0, n_samples, sqrt_spp))
    radiance = mk.render_slots(
        table, seed, n_slots=mk.n_slots_for(n), sizes=sizes,
        max_depth=max_depth, has_checker=int(features.get("has_checker", 0)),
        interpret=bool(features.get("mega_interpret", False)),
    )
    return radiance[:n].reshape(height, width, 3)


def render_progressive(scene, features, width: int, height: int, sample0,
                       n_samples, seed, max_depth: int, sqrt_spp: int,
                       chunk_size: int | None = None,
                       differentiable: bool = False):
    """Accumulate ``n_samples`` consecutive progressive samples in ONE traced
    computation (single device dispatch).

    The reference dispatches one Update per sample from the host loop
    (App.cpp:244-247); here that would cost a host→device round-trip per
    sample. Folding the sample loop into the program amortizes dispatch to
    zero. ``n_samples`` may be traced (the
    loop lowers to a while), so one compilation serves every batch size.
    """
    if not differentiable and features.get("use_megakernel", False):
        return _render_batch_megakernel(
            scene, features, width, height, sample0, n_samples, seed,
            max_depth, sqrt_spp,
        )

    def body(i, acc):
        return acc + render_sample(
            scene, features, width, height, sample0 + i, seed, max_depth,
            sqrt_spp, chunk_size, differentiable,
        )

    init = jnp.zeros((height, width, 3), defs.REAL)
    return jax.lax.fori_loop(0, n_samples, body, init)
