"""Inverse rendering: recover scene parameters by gradient descent on the
differentiable renderer.

The reference has no gradients at all — this is north-star surface
(ROADMAP.md: differentiable end-to-end w.r.t. geometry, material, and
camera parameters). The tool renders a TARGET image from a scene file,
perturbs chosen parameters, then optimizes them back with Adam on an L2
image loss through `grad.render_image` (the XLA scan bounce loop).

Usage:
    python tools/optimize_scene.py SCENE.json \
        --leaves materials.albedo camera.vfov \
        --steps 60 --width 64 --height 64 --samples 4 --depth 6

Prints one JSON line per step (loss, relative parameter error) and a final
summary — consumable by the same telemetry a training loop would use.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import sys

import jax.numpy as jnp
import numpy as np

from raytrace2 import grad as grad_mod
from raytrace2.scene import loader, schema

# leaf path -> (getter, setter) over the FlatScene pytree
_LEAVES = {
    "materials.albedo": (
        lambda s: s.materials.albedo,
        lambda s, v: dataclasses.replace(
            s, materials=dataclasses.replace(s.materials, albedo=v)),
    ),
    "materials.param": (
        lambda s: s.materials.param,
        lambda s, v: dataclasses.replace(
            s, materials=dataclasses.replace(s.materials, param=v)),
    ),
    "background": (
        lambda s: s.background,
        lambda s, v: dataclasses.replace(s, background=v),
    ),
    "camera.vfov": (
        lambda s: s.camera.vfov,
        lambda s, v: dataclasses.replace(
            s, camera=dataclasses.replace(s.camera, vfov=v)),
    ),
    "camera.center": (
        lambda s: s.camera.center,
        lambda s, v: dataclasses.replace(
            s, camera=dataclasses.replace(s.camera, center=v)),
    ),
    "spheres.center0": (
        lambda s: s.spheres.center0,
        lambda s, v: dataclasses.replace(
            s, spheres=dataclasses.replace(s.spheres, center0=v)),
    ),
}


def optimize(scene, features, leaves, *, steps, lr, render_kw, seed=0,
             perturb_rel=0.15, log=print, rng=None):
    """Perturb ``leaves`` of ``scene``, then recover them against the clean
    render. Returns (recovered scene, per-step records)."""
    rng = rng or np.random.RandomState(0)
    target = grad_mod.render_image(scene, features, seed, **render_kw)

    truth = {k: jnp.asarray(_LEAVES[k][0](scene)) for k in leaves}
    cur = dict(scene=scene)
    for k in leaves:
        t = truth[k]
        bump = jnp.asarray(
            rng.uniform(-perturb_rel, perturb_rel, np.shape(t)),
            jnp.float32) * (jnp.abs(t) + 0.3)
        cur["scene"] = _LEAVES[k][1](cur["scene"], t + bump)

    # Adam on the selected leaves only (simple explicit state: no optax
    # dependency needed for a handful of tensors).
    m = {k: jnp.zeros_like(truth[k]) for k in leaves}
    v = {k: jnp.zeros_like(truth[k]) for k in leaves}
    b1, b2, eps = 0.9, 0.999, 1e-8

    def loss_fn(img):
        return jnp.mean((img - target) ** 2)

    records = []
    for step in range(1, steps + 1):
        loss, g = grad_mod.value_and_grad_scene(
            loss_fn, cur["scene"], features, seed, **render_kw)
        rec = {"step": step, "loss": float(loss)}
        for k in leaves:
            gk = jnp.asarray(_LEAVES[k][0](g), jnp.float32)
            m[k] = b1 * m[k] + (1 - b1) * gk
            v[k] = b2 * v[k] + (1 - b2) * gk * gk
            mh = m[k] / (1 - b1 ** step)
            vh = v[k] / (1 - b2 ** step)
            new = _LEAVES[k][0](cur["scene"]) - lr * mh / (jnp.sqrt(vh) + eps)
            cur["scene"] = _LEAVES[k][1](cur["scene"], new)
            err = float(jnp.linalg.norm(new - truth[k])
                        / (jnp.linalg.norm(truth[k]) + 1e-8))
            rec[f"rel_err[{k}]"] = round(err, 5)
        rec["loss"] = round(rec["loss"], 8)
        records.append(rec)
        log(json.dumps(rec))
    return cur["scene"], records


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("scene")
    p.add_argument("--leaves", nargs="+", default=["materials.albedo"],
                   choices=sorted(_LEAVES))
    p.add_argument("--steps", type=int, default=40)
    p.add_argument("--lr", type=float, default=2e-2)
    p.add_argument("--width", type=int, default=64)
    p.add_argument("--height", type=int, default=64)
    p.add_argument("--samples", type=int, default=4)
    p.add_argument("--depth", type=int, default=6)
    p.add_argument("--seed", type=int, default=0)
    args = p.parse_args(argv)

    scene_host, _ = loader.load_scene(args.scene, seed=args.seed)
    feat = scene_host.features()
    features = tuple(sorted(feat.items()))
    scene = schema.to_device(scene_host)
    render_kw = dict(width=args.width, height=args.height,
                     n_samples=args.samples, max_depth=args.depth,
                     sqrt_spp=max(int(args.samples ** 0.5), 1))
    _, records = optimize(
        scene, features, args.leaves, steps=args.steps, lr=args.lr,
        render_kw=render_kw, seed=args.seed)
    first, last = records[0], records[-1]
    print(json.dumps({
        "event": "done", "steps": args.steps,
        "loss_first": first["loss"], "loss_last": last["loss"],
        "improvement": round(first["loss"] / max(last["loss"], 1e-12), 2),
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
