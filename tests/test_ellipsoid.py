"""Ellipsoids: spheres under NON-similarity transforms (VERDICT r4
missing #3). The reference's TransformedHittable applies any mat4 to any
hittable (src/cpu_raytrace/Transform.cpp:75-88), and make_scene's node
scales are vec3 — so non-uniformly-scaled spheres ARE authorable.
They load as a first-class family and render on the XLA path (features()
withholds mega_sizes).

Convention note: this port reports TRUE world-space t (the model
direction is not renormalized; affine maps preserve the ray parameter) —
consistent with its baked similarity spheres. The reference leaves t in
model units after a scaled transform (a known scaled-instance quirk of
the book's design)."""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from raytrace2 import defs
from raytrace2.ops import integrator, intersect
from raytrace2.scene import loader, schema


def _scene_json(scale, rotate_deg=0.0):
    return {
        "background_color": [0.5, 0.6, 0.8],
        "camera": {"fov": 50, "center": [0, 1, 6], "look_at": [0, 0.5, 0]},
        "materials": [{"type": "lambertian", "albedo": [0.7, 0.3, 0.3]},
                      {"type": "diffuse_light", "albedo": [4, 4, 4]}],
        "primitives": [
            {"type": "sphere", "center": [0, 0.5, 0], "radius": 1.0,
             "material": 0},
            {"type": "quad", "q": [-1, 3, -1], "u": [2, 0, 0],
             "v": [0, 0, 2], "material": 1},
        ],
        "scene": [
            {"primitive": 0,
             "transform": {"scale": scale,
                           "rotation": [rotate_deg, 0, 1, 0]}},
            {"primitive": 1},
        ],
    }


def _load(tmp_path, j, name="e.json"):
    p = tmp_path / name
    p.write_text(json.dumps(j))
    return loader.load_scene(str(p))


def test_nonuniform_scale_loads_as_ellipsoid(tmp_path):
    scene, _ = _load(tmp_path, _scene_json([1.0, 2.0, 0.5], 30.0))
    assert scene.ellipsoids is not None
    assert int(scene.ellipsoids.active.sum()) == 1
    assert int(scene.spheres.active.sum()) == 0
    feat = scene.features()
    assert feat["has_ellipsoids"]
    assert feat["mega_sizes"] is None  # routes to the XLA path


def test_uniform_scale_still_bakes_to_sphere(tmp_path):
    scene, _ = _load(tmp_path, _scene_json([2.0, 2.0, 2.0], 30.0))
    assert scene.ellipsoids is None
    assert int(scene.spheres.active.sum()) == 1
    assert scene.features()["mega_sizes"] is not None


def test_ellipsoid_ts_matches_numpy_closed_form(tmp_path):
    """Property test: random affines + random rays; the family's t equals
    the closed-form smallest valid root of |invA(o+td) + b - c| = r."""
    rng = np.random.default_rng(7)
    n_e, n_r = 5, 64
    c0 = rng.uniform(-2, 2, (n_e, 3))
    disp = rng.uniform(-0.3, 0.3, (n_e, 3))
    rad = rng.uniform(0.5, 1.5, n_e)
    mats = []
    for _ in range(n_e):
        while True:
            m = np.eye(4)
            m[:3, :3] = rng.uniform(-1.2, 1.2, (3, 3))
            m[:3, 3] = rng.uniform(-1, 1, 3)
            if abs(np.linalg.det(m[:3, :3])) > 0.2:
                break
        mats.append(m)
    inv34 = np.stack([np.linalg.inv(m)[:3] for m in mats])
    invt = np.stack([np.linalg.inv(m[:3, :3]).T for m in mats])
    ell = schema.make_ellipsoids(c0, disp, rad, inv34, invt,
                                 np.zeros(n_e, np.int32))
    o = rng.uniform(-4, 4, (n_r, 3)).astype(np.float32)
    d = rng.normal(size=(n_r, 3)).astype(np.float32)
    time = rng.uniform(0, 1, n_r).astype(np.float32)
    t_min = np.full(n_r, 1e-3, np.float32)
    t_max = np.full(n_r, 1e30, np.float32)
    ts = np.asarray(_jit_ts(ell, o, d, time, t_min, t_max))
    for e in range(n_e):
        a3 = inv34[e, :, :3]
        b3 = inv34[e, :, 3]
        for r in range(n_r):
            om = a3 @ o[r] + b3
            dm = a3 @ d[r]
            c = c0[e] + time[r] * disp[e]
            oc = c - om
            A = dm @ dm
            h = dm @ oc
            C = oc @ oc - rad[e] ** 2
            disc = h * h - A * C
            want = np.inf
            if disc >= 0:
                sq = np.sqrt(disc)
                for root in ((h - sq) / A, (h + sq) / A):
                    if 1e-3 < root < 1e30:
                        want = root
                        break
            got = ts[r, e]
            if want is np.inf or want > 1e29:
                assert got >= intersect.BIG * 0.99, (e, r, got)
            else:
                np.testing.assert_allclose(got, want, rtol=2e-4,
                                           err_msg=f"{e},{r}")


@jax.jit
def _jit_ts(ell, o, d, time, t_min, t_max):
    return intersect._ellipsoid_ts(ell, o, d, time, t_min, t_max)


def test_ellipsoid_normal_matches_implicit_gradient(tmp_path):
    """Axis-scaled ellipsoid (x/a)²+(y/b)²+(z/c)² = r²: the shading
    normal must align with the implicit-surface gradient
    (x/a², y/b², z/c²)."""
    a, b, c = 1.0, 2.0, 0.5
    m = np.diag([a, b, c, 1.0])
    inv34 = np.linalg.inv(m)[:3][None]
    invt = np.linalg.inv(m[:3, :3]).T[None]
    ell = schema.make_ellipsoids(
        np.zeros((1, 3)), np.zeros((1, 3)), np.ones(1), inv34, invt,
        np.zeros(1, np.int32))
    o = np.array([[3.0, 1.0, 0.3]], np.float32)
    d = -o / np.linalg.norm(o)
    time = np.zeros(1, np.float32)
    ts = np.asarray(_jit_ts(ell, o, d.astype(np.float32), time,
                            np.full(1, 1e-3, np.float32),
                            np.full(1, 1e30, np.float32)))
    t = ts[0, 0]
    assert t < 1e29
    _, normal, front, _, _ = jax.jit(intersect._ellipsoid_record)(
        ell, jnp.asarray(o), jnp.asarray(d, jnp.float32),
        jnp.asarray(time), jnp.asarray([t]), jnp.zeros(1, jnp.int32))
    p = o[0] + t * d[0]
    grad = np.array([p[0] / a**2, p[1] / b**2, p[2] / c**2])
    grad /= np.linalg.norm(grad)
    got = np.asarray(normal)[0]
    assert front[0]
    np.testing.assert_allclose(got, grad, atol=1e-4)
    # the surface point satisfies the implicit equation
    val = (p[0] / a) ** 2 + (p[1] / b) ** 2 + (p[2] / c) ** 2
    np.testing.assert_allclose(val, 1.0, rtol=1e-4)


def test_ellipsoid_scene_renders_and_differentiates(tmp_path):
    scene, _ = _load(tmp_path, _scene_json([1.0, 2.0, 0.5], 20.0))
    feat = tuple(sorted(scene.features().items()))
    dev = schema.to_device(scene)

    img = integrator.render_progressive(
        dev, dict(feat), 24, 16, jnp.int32(0), jnp.int32(2), 0, 4, 1)
    arr = np.asarray(img)
    assert np.isfinite(arr).all() and arr.mean() > 0.0

    from raytrace2 import grad as grad_mod

    def loss(im):
        return jnp.mean(im)

    _, g = grad_mod.value_and_grad_scene(
        loss, dev, feat, 0, width=16, height=12, n_samples=1,
        max_depth=3, sqrt_spp=1)
    e_g = g.ellipsoids
    for leaf in (e_g.center0, e_g.radius, e_g.inv_model):
        assert np.isfinite(np.asarray(leaf)).all()
