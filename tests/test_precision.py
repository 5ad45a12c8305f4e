"""Intersection arithmetic stays in full float32 on every backend: a float32
dot may run at reduced precision (TF32 on a GPU's tensor cores), which
moves hit distances enough to darken a render. Every dot_general that
``closest_hit`` traces must therefore ask for HIGHEST precision."""

import json

import jax
import jax.numpy as jnp
import pytest
from jax.extend import core

from raytrace2.ops import intersect
from raytrace2.scene import bvh as bvh_mod
from raytrace2.scene import loader, schema


def _scene(tmp_path):
    """Spheres, a quad, a rotated medium box, and an ellipsoid."""
    j = {
        "background_color": [0.5, 0.6, 0.8],
        "camera": {"fov": 50, "center": [0, 1, 6], "look_at": [0, 0.5, 0]},
        "materials": [{"type": "lambertian", "albedo": [0.7, 0.3, 0.3]},
                      {"type": "diffuse_light", "albedo": [4, 4, 4]}],
        "primitives": [
            {"type": "sphere", "center": [0, 0.5, 0], "radius": 1.0,
             "material": 0},
            {"type": "sphere", "center": [2, 0.5, 0], "radius": 0.5,
             "material": 0},
            {"type": "quad", "q": [-1, 3, -1], "u": [2, 0, 0],
             "v": [0, 0, 2], "material": 1},
            {"type": "box", "a": [0, 0, 0], "b": [1, 1, 1], "material": 0,
             "constant_medium": {"density": 0.5, "albedo": [1, 1, 1]}},
        ],
        "scene": [
            {"primitive": 0,
             "transform": {"scale": [1.0, 2.0, 0.5],
                           "rotation": [30, 0, 1, 0]}},
            {"primitive": 1}, {"primitive": 2},
            {"primitive": 3,
             "transform": {"translation": [-2, 0, 0],
                           "rotation": [20, 0, 1, 0]}},
        ],
    }
    p = tmp_path / "precision.json"
    p.write_text(json.dumps(j))
    scene, _ = loader.load_scene(str(p))
    return scene


def _dots(jaxpr):
    """Every dot_general equation in a jaxpr, recursing into sub-jaxprs."""
    for eqn in jaxpr.eqns:
        if eqn.primitive.name == "dot_general":
            yield eqn
        for v in eqn.params.values():
            for sub in (v if isinstance(v, (tuple, list)) else (v,)):
                if isinstance(sub, core.ClosedJaxpr):
                    yield from _dots(sub.jaxpr)
                elif isinstance(sub, core.Jaxpr):
                    yield from _dots(sub)


@pytest.mark.parametrize("sphere_bvh", [False, True])
def test_closest_hit_dots_are_highest_precision(tmp_path, sphere_bvh):
    host = _scene(tmp_path)
    feat = host.features()
    assert feat["has_media"] and feat["has_ellipsoids"]
    if sphere_bvh:
        tree, depth = bvh_mod.build_sphere_bvh(host.spheres)
        host = schema.FlatScene(**{**host.__dict__, "sphere_bvh": tree})
        feat.update(use_bvh_spheres=True, bvh_depth=depth)
    scene = schema.to_device(host)
    n = 8
    o = jnp.zeros((n, 3))
    d = jnp.tile(jnp.array([[0.0, 0.0, -1.0]]), (n, 1))
    t = jnp.zeros((n,))
    u = jnp.full((n, scene.media.btype.shape[0]), 0.5)
    jaxpr = jax.make_jaxpr(
        lambda s, o, d, t, u: intersect.closest_hit(s, o, d, t, u,
                                                    features=feat)
    )(scene, o, d, t, u)
    dots = list(_dots(jaxpr.jaxpr))
    assert dots, "the scene should trace some contractions"
    highest = jax.lax.Precision.HIGHEST
    low = [e for e in dots if tuple(e.params["precision"] or ()) != (highest, highest)]
    assert not low, f"dot_general below HIGHEST: {[e.params['precision'] for e in low]}"
