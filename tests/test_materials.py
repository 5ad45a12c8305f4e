"""Material scatter/emit tests vs. closed-form optics
(src/cpu_raytrace/Material.cpp, Math.hpp:66-73)."""

import jax
import jax.numpy as jnp
import numpy as np

from raytrace2 import defs
from raytrace2.scene import schema
from raytrace2.ops import intersect, materials
import pytest

pytestmark = pytest.mark.tier0


def _scene_with_materials(mtype, albedo=None, param=None, tex=None, background=(0, 0, 0)):
    k = len(mtype)
    mats = schema.Materials(
        mtype=np.asarray(mtype, defs.INDEX),
        albedo=np.asarray(albedo if albedo is not None else np.ones((k, 3)), defs.REAL),
        param=np.asarray(param if param is not None else np.zeros(k), defs.REAL),
        tex=np.asarray(tex if tex is not None else np.zeros(k), defs.INDEX),
    )
    textures = schema.Textures(
        ttype=np.zeros(1, defs.INDEX), albedo=np.full((1, 3), 0.25, defs.REAL),
        inv_scale=np.ones(1, defs.REAL), scale=np.ones(1, defs.REAL),
        even=np.zeros(1, defs.INDEX), odd=np.zeros(1, defs.INDEX),
        noise_type=np.zeros(1, defs.INDEX),
        perm=np.zeros((1, 3, 256), defs.INDEX), grad=np.zeros((1, 256, 3), defs.REAL),
    )
    spheres = schema.make_spheres(np.zeros((0, 3)), np.zeros((0, 3)), np.zeros(0), np.zeros(0, np.int64))
    quads = schema.make_quads(np.zeros((0, 3)), np.zeros((0, 3)), np.zeros((0, 3)), np.zeros(0, np.int64))
    cam = schema.CameraParams(
        center=np.zeros(3, defs.REAL), look_at=np.array([0, 0, -1], defs.REAL),
        vup=np.array([0, 1, 0], defs.REAL), vfov=defs.REAL(90),
        defocus_angle=defs.REAL(0), focus_dist=defs.REAL(1),
    )
    return schema.FlatScene(
        spheres=spheres, quads=quads, boxes=schema.empty_boxes(),
        media=schema.empty_media(), materials=mats,
        textures=textures, camera=cam, background=np.asarray(background, defs.REAL),
    )


FEAT = {"has_media": False, "has_noise": False, "has_checker": False}


def _shade(scene, mat_idx, normal, d_in, n=1024, front=True):
    hit = intersect.Hit(
        valid=jnp.ones(n, bool),
        t=jnp.ones(n),
        point=jnp.zeros((n, 3)),
        normal=jnp.tile(jnp.asarray(normal, jnp.float32), (n, 1)),
        front_face=jnp.full(n, front),
        uv=jnp.zeros((n, 2)),
        material=jnp.full(n, mat_idx, jnp.int32),
    )
    keys = jax.random.split(jax.random.key(0), n)
    u = jax.jit(jax.vmap(lambda k: jax.random.uniform(k, (3,))))(keys)
    d_in = jnp.tile(jnp.asarray(d_in, jnp.float32), (n, 1))
    from raytrace2.ops import rng as rng_ops

    u_vec = rng_ops.unit_vec3_from_uniforms(u[:, 0], u[:, 1])
    return jax.jit(
        lambda s, h, d, uv, uf: materials.shade(s, FEAT, h, d, uv, uf)
    )(schema.to_device(scene), hit, d_in, u_vec, u[:, 2])


def test_reflect_refract_closed_form():
    v = jnp.array([[1.0, -1.0, 0.0]])
    n = jnp.array([[0.0, 1.0, 0.0]])
    np.testing.assert_allclose(
        np.asarray(materials.reflect(v, n))[0], [1.0, 1.0, 0.0], atol=1e-6
    )
    # Refraction at normal incidence: direction unchanged.
    uv = jnp.array([[0.0, -1.0, 0.0]])
    out = np.asarray(materials.refract(uv, n, 1.0 / 1.5))[0]
    np.testing.assert_allclose(out, [0.0, -1.0, 0.0], atol=1e-6)
    # Snell: 45° incidence air→glass (η=1/1.5): sin θ_t = sin45/1.5.
    uv = jnp.array([[np.sqrt(0.5), -np.sqrt(0.5), 0.0]])
    out = np.asarray(materials.refract(uv, n, np.float32(1 / 1.5)))[0]
    sin_t = out[0] / np.linalg.norm(out)
    np.testing.assert_allclose(sin_t, np.sqrt(0.5) / 1.5, atol=1e-6)


def test_schlick_limits():
    assert abs(float(materials.schlick(1.0, 1.5)) - ((0.5 / 2.5) ** 2)) < 1e-6
    assert abs(float(materials.schlick(0.0, 1.5)) - 1.0) < 1e-6


def test_lambertian_distribution():
    scene = _scene_with_materials([defs.MAT_LAMBERTIAN], albedo=[[0.5, 0.6, 0.7]])
    sc = _shade(scene, 0, [0, 1, 0], [0, -1, 0])
    d = np.asarray(sc.direction)
    # dir = normal + unit vec → y-component mean 1, x/z mean 0.
    np.testing.assert_allclose(d.mean(0), [0, 1, 0], atol=0.06)
    assert bool(np.all(np.asarray(sc.did_scatter)))
    np.testing.assert_allclose(np.asarray(sc.attenuation)[0], [0.5, 0.6, 0.7], atol=1e-6)
    np.testing.assert_allclose(np.asarray(sc.emitted), 0.0)


def test_metal_perfect_mirror():
    scene = _scene_with_materials([defs.MAT_METAL], albedo=[[0.9, 0.9, 0.9]], param=[0.0])
    d_in = np.array([1.0, -1.0, 0.0]) / np.sqrt(2)
    sc = _shade(scene, 0, [0, 1, 0], d_in)
    d = np.asarray(sc.direction)
    expected = np.array([1.0, 1.0, 0.0]) / np.sqrt(2)
    np.testing.assert_allclose(d, np.tile(expected, (d.shape[0], 1)), atol=1e-6)


def test_metal_fuzz_spreads():
    scene = _scene_with_materials([defs.MAT_METAL], param=[0.3])
    sc = _shade(scene, 0, [0, 1, 0], np.array([1.0, -1.0, 0.0]) / np.sqrt(2))
    d = np.asarray(sc.direction)
    assert d.std(0).max() > 0.1


def test_dielectric_total_internal_reflection():
    # From inside glass (front_face False → η = 1.5), grazing 45° > critical
    # angle (41.8°) → always reflect.
    scene = _scene_with_materials([defs.MAT_DIELECTRIC], param=[1.5])
    d_in = np.array([1.0, -1.0, 0.0]) / np.sqrt(2)
    sc = _shade(scene, 0, [0, 1, 0], d_in, front=False)
    d = np.asarray(sc.direction)
    expected = np.array([1.0, 1.0, 0.0]) / np.sqrt(2)
    np.testing.assert_allclose(d, np.tile(expected, (d.shape[0], 1)), atol=1e-5)
    np.testing.assert_allclose(np.asarray(sc.attenuation), 1.0)


def test_dielectric_mixes_reflect_refract():
    scene = _scene_with_materials([defs.MAT_DIELECTRIC], param=[1.5])
    d_in = np.array([1.0, -1.0, 0.0]) / np.sqrt(2)
    sc = _shade(scene, 0, [0, 1, 0], d_in)  # air → glass at 45°
    d = np.asarray(sc.direction)
    up = d[:, 1] > 0
    frac_reflect = up.mean()
    # Schlick at cos=cos45°, η=1.5 ≈ 0.05.
    assert 0.01 < frac_reflect < 0.12


def test_diffuse_light_emits_and_stops():
    scene = _scene_with_materials([defs.MAT_DIFFUSE_LIGHT], tex=[0])
    sc = _shade(scene, 0, [0, 1, 0], [0, -1, 0])
    assert not bool(np.any(np.asarray(sc.did_scatter)))
    np.testing.assert_allclose(np.asarray(sc.emitted), 0.25, atol=1e-6)


def test_isotropic_uniform_sphere():
    scene = _scene_with_materials([defs.MAT_ISOTROPIC], tex=[0])
    sc = _shade(scene, 0, [0, 1, 0], [0, -1, 0])
    d = np.asarray(sc.direction)
    np.testing.assert_allclose(np.linalg.norm(d, axis=-1), 1.0, atol=1e-5)
    assert np.abs(d.mean(0)).max() < 0.07
    np.testing.assert_allclose(np.asarray(sc.attenuation), 0.25, atol=1e-6)
