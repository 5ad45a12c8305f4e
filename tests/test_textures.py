"""Texture evaluation tests: jnp Perlin/turbulence vs. the NumPy oracle
(scene/perlin.py, itself a direct transcription of
src/cpu_raytrace/PerlinNoiseGen.cpp:10-26, 52-88), checker parity, and
dispatch gating."""

import jax
import jax.numpy as jnp
import numpy as np

from raytrace2 import defs
from raytrace2.scene import perlin
from raytrace2.ops import textures as tex_ops
from raytrace2.scene import schema
import pytest

pytestmark = pytest.mark.tier0


def _tex_tables(n_tex=2, seed=3):
    perms, grads = [], []
    for i in range(n_tex):
        p, g = perlin.make_tables(seed, i)
        perms.append(p)
        grads.append(g)
    return jnp.asarray(np.stack(perms)), jnp.asarray(np.stack(grads))


def test_perlin_matches_oracle():
    perm, grad = _tex_tables()
    rs = np.random.RandomState(0)
    pts = rs.uniform(-20, 20, (64, 3)).astype(np.float32)
    for tex in range(2):
        got = np.asarray(
            jax.jit(tex_ops.perlin_noise)(
                perm, grad, jnp.full(64, tex, jnp.int32), jnp.asarray(pts)
            )
        )
        want = np.array(
            [perlin.noise_ref(np.asarray(perm[tex]), np.asarray(grad[tex]), p) for p in pts]
        )
        np.testing.assert_allclose(got, want, rtol=2e-4, atol=2e-5)


def test_turbulence_matches_oracle():
    perm, grad = _tex_tables(1)
    rs = np.random.RandomState(1)
    pts = rs.uniform(-5, 5, (32, 3)).astype(np.float32)
    got = np.asarray(
        jax.jit(tex_ops.turbulence)(perm, grad, jnp.zeros(32, jnp.int32), jnp.asarray(pts))
    )
    want = np.array(
        [perlin.turb_ref(np.asarray(perm[0]), np.asarray(grad[0]), p) for p in pts]
    )
    np.testing.assert_allclose(got, want, rtol=2e-3, atol=2e-4)


def _textures_soa():
    """rows: 0 solid red, 1 solid blue, 2 checker(0,1) scale 2, 3 marble, 4 perlin."""
    perm0, grad0 = perlin.make_tables(0, 3)
    L = 5
    perm = np.tile(perlin.identity_tables()[0], (L, 1, 1))
    grad = np.zeros((L, 256, 3), defs.REAL)
    perm[3], grad[3] = perm0, grad0
    perm[4], grad[4] = perlin.make_tables(0, 4)
    return schema.Textures(
        ttype=np.array([defs.TEX_SOLID, defs.TEX_SOLID, defs.TEX_CHECKER,
                        defs.TEX_NOISE, defs.TEX_NOISE], defs.INDEX),
        albedo=np.array([[1, 0, 0], [0, 0, 1], [1, 1, 1], [0.5, 0.5, 0.5], [1, 1, 1]], defs.REAL),
        inv_scale=np.array([1, 1, 0.5, 1, 1], defs.REAL),
        scale=np.array([1, 1, 1, 4.0, 2.0], defs.REAL),
        even=np.array([0, 0, 0, 0, 0], defs.INDEX),
        odd=np.array([0, 0, 1, 0, 0], defs.INDEX),
        noise_type=np.array([0, 0, 0, defs.NOISE_MARBLE, defs.NOISE_PERLIN], defs.INDEX),
        perm=perm.astype(defs.INDEX),
        grad=grad.astype(defs.REAL),
    )


FEAT = {"has_noise": True, "has_checker": True}


def _value(tex, idx, pts, features=FEAT):
    return np.asarray(
        jax.jit(lambda t, i, p: tex_ops.texture_value(t, i, None, p, features))(
            jax.tree_util.tree_map(jnp.asarray, tex),
            jnp.asarray(idx, jnp.int32),
            jnp.asarray(pts, jnp.float32),
        )
    )


def test_solid_and_checker_parity():
    tex = _textures_soa()
    # Checker with inv_scale 0.5: floor(0.5*p) parity (Texture.cpp:7-11).
    pts = np.array([
        [0.0, 0.0, 0.0],    # floors (0,0,0) sum 0 → even → red
        [2.1, 0.0, 0.0],    # floors (1,0,0) sum 1 → odd → blue
        [2.1, 2.1, 0.0],    # sum 2 → even
        [-0.1, 0.0, 0.0],   # floor(-0.05)= -1 → odd
    ])
    v = _value(tex, [2, 2, 2, 2], pts)
    np.testing.assert_allclose(v[0], [1, 0, 0], atol=1e-6)
    np.testing.assert_allclose(v[1], [0, 0, 1], atol=1e-6)
    np.testing.assert_allclose(v[2], [1, 0, 0], atol=1e-6)
    np.testing.assert_allclose(v[3], [0, 0, 1], atol=1e-6)


def test_marble_matches_reference_formula():
    tex = _textures_soa()
    pts = np.random.RandomState(2).uniform(-3, 3, (16, 3)).astype(np.float32)
    v = _value(tex, [3] * 16, pts)
    perm, grad = np.asarray(tex.perm[3]), np.asarray(tex.grad[3])
    for i, p in enumerate(pts):
        want = 0.5 * (1 + np.sin(4.0 * p[2] + 10 * perlin.turb_ref(perm, grad, p)))
        np.testing.assert_allclose(v[i], 0.5 * want, rtol=1e-3, atol=1e-4)


def test_perlin_texture_value():
    tex = _textures_soa()
    pts = np.random.RandomState(3).uniform(-3, 3, (16, 3)).astype(np.float32)
    v = _value(tex, [4] * 16, pts)
    perm, grad = np.asarray(tex.perm[4]), np.asarray(tex.grad[4])
    for i, p in enumerate(pts):
        want = 0.5 * (1.0 + perlin.noise_ref(perm, grad, 2.0 * p))
        np.testing.assert_allclose(v[i], [want] * 3, rtol=1e-3, atol=1e-4)


def test_feature_gating_consistency():
    """Gating out unused classes must not change values for used ones."""
    tex = _textures_soa()
    pts = np.random.RandomState(4).uniform(-3, 3, (8, 3))
    a = _value(tex, [0] * 8, pts, {"has_noise": True, "has_checker": True})
    b = _value(tex, [0] * 8, pts, {"has_noise": False, "has_checker": False})
    np.testing.assert_allclose(a, b)


def test_nested_checker_two_levels():
    """Checker-of-checker (reference recursion, Texture.cpp:7-11):
    features["has_checker"] carries the nesting depth; two levels resolve
    to exact leaf albedos."""
    L = 4
    perm = np.tile(perlin.identity_tables()[0], (L, 1, 1))
    grad = np.zeros((L, 256, 3), defs.REAL)
    tex = schema.Textures(
        # 0 red, 1 blue, 2 inner checker(0,1) cell 1, 3 outer
        # checker(even=2 inner, odd=1 blue) cell 4 (inv 0.25)
        ttype=np.array([defs.TEX_SOLID, defs.TEX_SOLID, defs.TEX_CHECKER,
                        defs.TEX_CHECKER], defs.INDEX),
        albedo=np.array([[1, 0, 0], [0, 0, 1], [1, 1, 1], [1, 1, 1]],
                        defs.REAL),
        inv_scale=np.array([1, 1, 1.0, 0.25], defs.REAL),
        scale=np.ones(L, defs.REAL),
        even=np.array([0, 0, 0, 2], defs.INDEX),
        odd=np.array([0, 0, 1, 1], defs.INDEX),
        noise_type=np.zeros(L, defs.INDEX),
        perm=perm.astype(defs.INDEX),
        grad=grad.astype(defs.REAL),
    )
    feat = {"has_noise": False, "has_checker": 2}
    pts = np.array([
        [0.5, 0.5, 0.5],   # outer cell (0,0,0) even -> inner; inner cell (0,0,0) even -> red
        [1.5, 0.5, 0.5],   # outer even; inner cell (1,0,0) odd -> blue
        [4.5, 0.5, 0.5],   # outer cell (1,0,0) odd -> blue directly
    ], np.float32)
    v = _value(tex, [3, 3, 3], pts, feat)
    np.testing.assert_allclose(v[0], [1, 0, 0], atol=1e-6)
    np.testing.assert_allclose(v[1], [0, 0, 1], atol=1e-6)
    np.testing.assert_allclose(v[2], [0, 0, 1], atol=1e-6)
