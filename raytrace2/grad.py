"""Differentiable rendering.

The scene is a pytree (schema.FlatScene), so ``jax.grad`` composes directly
with the integrator; this module provides the supported entry point and
documents the estimator's semantics.

What differentiates (SURVEY.md §7 "Differentiability"):
* geometry — sphere centers/radii/displacements, quad q/u/v (through the
  intersection *solve*: t, point, normal), camera parameters (through ray
  generation), material/texture parameters (albedos, fuzz, refraction index,
  emission, background).
* discrete events are detached: WHICH primitive is hit (argmin index), the
  dielectric reflect/refract branch, the checker cell choice, medium
  scatter-or-not — the VJP flows through the continuous quantities
  conditioned on those choices. This is the standard "detached sampling"
  path-gradient estimator: exact for continuous integrands in expectation,
  ignoring the motion of visibility discontinuities (no edge/silhouette
  term).
* random draws use fixed keys (pixel, sample, bounce): gradients are taken
  at fixed random primal — the estimator is deterministic given (seed, spp).

Russian roulette does not exist in the reference (fixed depth cap), which
keeps throughput weights differentiable.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp

from raytrace2.ops import integrator


@functools.partial(
    jax.jit,
    static_argnames=("features", "width", "height", "n_samples", "max_depth",
                     "sqrt_spp", "chunk_size"),
)
def render_image(scene, features, seed, *, width, height, n_samples,
                 max_depth, sqrt_spp, chunk_size=None):
    """Differentiable n-sample render → mean radiance [H,W,3].

    The scan-based XLA bounce loop (reverse-mode differentiable; the
    while-loop fast path is not) inside a ``scan`` over the samples, so the
    whole computation is one reverse-differentiable graph whose size does
    not grow with ``n_samples`` (each sample's residuals do). Uses the
    detached-selection estimator of the module docstring.
    """
    def body(acc, s):
        return acc + integrator.render_sample(
            scene, dict(features), width, height, s, seed, max_depth,
            sqrt_spp, chunk_size, differentiable=True,
        ), None

    acc, _ = jax.lax.scan(body, jnp.zeros((height, width, 3), jnp.float32),
                          jnp.arange(n_samples, dtype=jnp.int32))
    return acc / n_samples


def value_and_grad_scene(loss_fn, scene, features, seed, **render_kw):
    """(loss, d loss / d scene) for ``loss_fn(image) -> scalar``.

    The returned gradient is a FlatScene pytree; integer index/type leaves
    get zero cotangents.
    """

    def wrapped(s):
        return loss_fn(render_image(s, features, seed, **render_kw))

    # Integer leaves (material ids, texture types, ...) are non-differentiable;
    # jax.grad with allow_int returns float0 for them.
    return jax.value_and_grad(wrapped, allow_int=True)(scene)
