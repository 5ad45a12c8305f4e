"""Multi-device rendering: pixel-DP × sample-SP over a jax.sharding.Mesh.

The reference's only parallelism is shared-memory per-pixel fan-out within
one frame (``std::for_each(std::execution::par)``,
src/cpu_raytrace/RayTracer.cpp:69). Across devices (SURVEY.md §2.12) this
module uses a 2-D device mesh:

* axis ``dp`` — pixel tiles: the ray batch's leading axis is sharded; each
  device traces its own pixels. Scene/BVH arrays are replicated.
* axis ``sp`` — sample batches: devices on this axis trace *different
  progressive sample indices* for the same pixels; their radiance is summed
  with ``psum`` (NCCL on GPUs).

RNG keys are a pure function of (seed, pixel, sample) — never of device id —
so any mesh layout produces the same accumulated image in distribution
(bitwise identical given the same (pixel, sample) set; SURVEY.md §7). The
cards of one host reach each other all to all, so the mesh shape follows
the algorithm alone.

Multi-host: the same code runs under ``jax.distributed.initialize`` (see
parallel/distributed.py); the mesh then spans all hosts' devices.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, PartitionSpec as P

from raytrace2.ops import camera as camera_ops
from raytrace2.ops import integrator, rng


def make_mesh(sp: int = 1, dp: int | None = None, devices=None) -> Mesh:
    """Build an ('sp', 'dp') mesh. Defaults: all devices on the dp axis."""
    devices = np.asarray(devices if devices is not None else jax.devices())
    total = devices.size
    if dp is None:
        dp = total // sp
    if sp * dp != total:
        raise ValueError(f"sp*dp = {sp * dp} != device count {total}")
    return Mesh(devices.reshape(sp, dp), ("sp", "dp"))


def _trace_tile(scene, features, width, height, pixel_ids, sample_idx, seed,
                max_depth, sqrt_spp):
    """Trace one device's pixel tile at one sample index (local compute)."""
    keys = jax.vmap(lambda p: rng.pixel_sample_key(seed, p, sample_idx))(pixel_ids)
    o, d, time = camera_ops.generate_rays(
        scene.camera, width, height, sample_idx, sqrt_spp, keys, pixel_ids
    )
    return integrator.trace_rays(scene, features, o, d, time, keys, max_depth)


@functools.partial(
    jax.jit,
    static_argnames=("features", "width", "height", "max_depth", "sqrt_spp",
                     "samples_per_device", "mesh"),
)
def render_samples_sharded(scene, features, sample0, seed, *, width, height,
                           max_depth, sqrt_spp, samples_per_device, mesh):
    """Render ``samples_per_device * mesh.shape['sp']`` progressive samples,
    summed into one [H,W,3] radiance batch.

    Device (i, j) of the ('sp','dp') mesh traces samples
    ``sample0 + i*samples_per_device + [0..spd)`` for pixel tile j; the sp
    axis is reduced with psum. Output is dp-sharded by pixel rows (pixel
    count must divide evenly; the renderer pads the grid).
    """
    features = dict(features)
    n = width * height
    dp = mesh.shape["dp"]
    sp = mesh.shape["sp"]
    pad = (-n) % dp
    pixel_ids = jnp.arange(n + pad, dtype=jnp.int32) % n  # pad wraps (discarded later)
    sp_ids = jnp.arange(sp, dtype=jnp.int32)

    @functools.partial(
        jax.shard_map,
        mesh=mesh,
        in_specs=(P(), P("sp"), P("dp")),
        out_specs=P(None, "dp"),
        # The integrator's while_loop carry is initialized from constants
        # (unvarying) and becomes device-varying after the first bounce;
        # varying-manual-axes checking rejects that even though each device's
        # loop is independent and correct — disable it.
        check_vma=False,
    )
    def go(scene, my_sp, my_pixels):
        def body(s, acc):
            sample_idx = sample0 + my_sp[0] * samples_per_device + s
            return acc + _trace_tile(
                scene, features, width, height, my_pixels, sample_idx, seed,
                max_depth, sqrt_spp,
            )

        local = jax.lax.fori_loop(
            0, samples_per_device,
            body,
            jnp.zeros((my_pixels.shape[0], 3), jnp.float32),
        )
        return jax.lax.psum(local, "sp")[None]

    out = go(scene, sp_ids, pixel_ids)[0]
    return out[:n].reshape(height, width, 3)


@functools.partial(
    jax.jit,
    static_argnames=("features", "width", "height", "max_depth", "sqrt_spp",
                     "samples_per_device", "mesh"),
)
def render_samples_sharded_mega(scene, features, sample0, seed, *, width,
                                height, max_depth, sqrt_spp,
                                samples_per_device, mesh):
    """Distributed megakernel render: 'dp' splits the pixel slots into
    equal block-aligned ranges (each device's kernel gets its range's first
    slot, so RNG streams and strata are those of a single-device render),
    'sp' renders different sample blocks and psums. Returns the radiance
    sum [H,W,3] over sp·samples_per_device samples."""
    from raytrace2.ops.pallas import megakernel as mk

    features = dict(features)
    n = width * height
    dp = mesh.shape["dp"]
    sizes = tuple(features["mega_sizes"])
    chunk = mk.n_slots_for(n, parts=dp)
    slot0 = jnp.arange(dp, dtype=jnp.int32) * chunk
    sp_ids = jnp.arange(mesh.shape["sp"], dtype=jnp.int32)

    @functools.partial(
        jax.shard_map,
        mesh=mesh,
        in_specs=(P(), P("sp"), P("dp")),
        out_specs=P(None, "dp"),
        check_vma=False,
    )
    def go(scene, my_sp, my_slot0):
        table = mk.pack_table(scene, sizes, mk.header(
            scene, width, height, sample0 + my_sp[0] * samples_per_device,
            samples_per_device, sqrt_spp, slot0=my_slot0[0]))
        r = mk.render_slots(
            table, seed, n_slots=chunk, sizes=sizes, max_depth=max_depth,
            has_checker=int(features.get("has_checker", 0)),
            interpret=bool(features.get("mega_interpret", False)),
        )
        return jax.lax.psum(r, "sp")[None]

    out = go(scene, sp_ids, slot0)[0]
    return out[:n].reshape(height, width, 3)


@functools.partial(
    jax.jit,
    static_argnames=("features", "width", "height", "max_depth", "sqrt_spp",
                     "n_samples", "mesh"),
)
def render_grad_sharded(scene, features, target, seed, *, width, height,
                        max_depth, sqrt_spp, n_samples, mesh):
    """Distributed differentiable render: L2 loss against ``target`` and
    d loss/d scene, pixel-sharded over the mesh's 'dp' axis with the
    gradient all-reduced by psum — the renderer's data-parallel training
    step (SURVEY.md §2.12 'gradient parallelism').

    Every device renders its pixel tile with the scan-based differentiable
    integrator, computes its partial loss and scene-gradient, and psums
    both; scene (and its gradient) are replicated, mirroring
    gradient-all-reduce data parallelism in NN training.
    """
    features = dict(features)
    n = width * height
    total = mesh.shape["dp"] * mesh.shape["sp"]  # both axes shard pixels here
    pad = (-n) % total
    pixel_ids = jnp.arange(n + pad, dtype=jnp.int32) % n
    # Pad rows wrap onto pixels 0..pad-1; weight them out of the loss so
    # every pixel contributes exactly once regardless of mesh size.
    weights = (jnp.arange(n + pad) < n).astype(jnp.float32)
    tgt_flat = target.reshape(n, 3)
    tgt_flat = jnp.concatenate([tgt_flat, tgt_flat[:pad]]) if pad else tgt_flat

    @functools.partial(
        jax.shard_map,
        mesh=mesh,
        in_specs=(P(), P(("sp", "dp")), P(("sp", "dp")), P(("sp", "dp"))),
        out_specs=(P(), P()),
        check_vma=False,
    )
    def go(scene, my_pixels, my_target, my_weights):
        def local_loss(scene):
            acc = jnp.zeros((my_pixels.shape[0], 3), jnp.float32)
            for s in range(n_samples):
                keys = jax.vmap(
                    lambda p: rng.pixel_sample_key(seed, p, jnp.int32(s))
                )(my_pixels)
                o, d, time = camera_ops.generate_rays(
                    scene.camera, width, height, jnp.int32(s), sqrt_spp,
                    keys, my_pixels,
                )
                acc = acc + integrator.trace_rays(
                    scene, features, o, d, time, keys, max_depth,
                    differentiable=True,
                )
            img = acc / n_samples
            return jnp.sum(my_weights[:, None] * (img - my_target) ** 2)

        loss, g = jax.value_and_grad(local_loss, allow_int=True)(scene)
        loss = jax.lax.psum(loss, ("sp", "dp"))

        def reduce_leaf(x):
            # Integer leaves (type ids, indices) carry float0 cotangents —
            # nothing to reduce.
            if hasattr(x, "dtype") and jnp.issubdtype(x.dtype, jnp.floating):
                return jax.lax.psum(x, ("sp", "dp"))
            return x

        g = jax.tree_util.tree_map(reduce_leaf, g)
        return loss, g

    return go(scene, pixel_ids, tgt_flat, weights)


def train_step_analog(scene, features, state, seed, *, width, height, max_depth,
                      sqrt_spp, samples_per_device, mesh):
    """One distributed accumulation step: the renderer's 'training step'.

    Adds sp·spd samples to the accumulator (the renderer's parameters-analog)
    and bumps frame_idx accordingly."""
    radiance = render_samples_sharded(
        scene, features, state.frame_idx, seed,
        width=width, height=height, max_depth=max_depth, sqrt_spp=sqrt_spp,
        samples_per_device=samples_per_device, mesh=mesh,
    )
    from raytrace2 import render as render_mod

    total = samples_per_device * mesh.shape["sp"]
    return render_mod.RenderState(
        accum=state.accum + radiance,
        frame_idx=state.frame_idx + jnp.int32(total),
    )
