"""Distribution tests for the analytic replacements of the reference's
rejection samplers (src/cpu_raytrace/Math.hpp:26-51)."""

import jax
import jax.numpy as jnp
import numpy as np

from raytrace2.ops import rng
import pytest

pytestmark = pytest.mark.tier0


def _keys(n, seed=0):
    return jax.random.split(jax.random.key(seed), n)


def test_unit_vec3_on_sphere():
    v = np.asarray(jax.jit(jax.vmap(rng.unit_vec3))(_keys(4096)))
    np.testing.assert_allclose(np.linalg.norm(v, axis=-1), 1.0, atol=1e-5)
    # Uniform on the sphere: mean ~ 0, E[x^2] = 1/3.
    assert np.abs(v.mean(0)).max() < 0.05
    np.testing.assert_allclose((v**2).mean(0), 1 / 3, atol=0.02)


def test_in_unit_disk():
    p = np.asarray(jax.jit(jax.vmap(rng.in_unit_disk))(_keys(4096)))
    r = np.linalg.norm(p[:, :2], axis=-1)
    assert np.all(p[:, 2] == 0)
    assert np.all(r <= 1.0)
    # Uniform area → E[r^2] = 1/2.
    np.testing.assert_allclose((r**2).mean(), 0.5, atol=0.03)


def test_in_unit_sphere():
    p = np.asarray(jax.jit(jax.vmap(rng.in_unit_sphere))(_keys(4096)))
    r = np.linalg.norm(p, axis=-1)
    assert np.all(r <= 1.0 + 1e-6)
    # Uniform volume → E[r^3] = 1/2.
    np.testing.assert_allclose((r**3).mean(), 0.5, atol=0.03)


def test_on_hemisphere():
    normal = jnp.tile(jnp.array([0.0, 1.0, 0.0]), (2048, 1))
    v = np.asarray(
        jax.jit(lambda k, n: jax.vmap(rng.on_hemisphere)(k, n))(_keys(2048), normal)
    )
    assert np.all(v[:, 1] > 0)
    np.testing.assert_allclose(np.linalg.norm(v, axis=-1), 1.0, atol=1e-5)


def test_murmur_uniforms_distribution_and_purity():
    ids = jnp.arange(8192, dtype=jnp.int32)
    u = np.asarray(jax.jit(
        lambda s: rng.murmur_uniforms(s, ids, (0, 1, 2))
    )(jnp.int32(12345)))
    assert u.shape == (8192, 3)
    assert np.all((u >= 0) & (u < 1))
    np.testing.assert_allclose(u.mean(0), 0.5, atol=0.02)
    np.testing.assert_allclose(u.var(0), 1 / 12, atol=0.01)
    # Columns (counters) are decorrelated.
    c = np.corrcoef(u.T)
    assert np.abs(c[0, 1]) < 0.05 and np.abs(c[0, 2]) < 0.05
    # Pure function of (seed, id, ctr).
    u2 = np.asarray(rng.murmur_uniforms(jnp.int32(12345), ids, (0, 1, 2)))
    np.testing.assert_array_equal(u, u2)
    u3 = np.asarray(rng.murmur_uniforms(jnp.int32(12346), ids, (0, 1, 2)))
    assert not np.array_equal(u, u3)


def test_key_derivation_is_pure():
    k1 = rng.pixel_sample_key(7, jnp.int32(11), jnp.int32(3))
    k2 = rng.pixel_sample_key(7, jnp.int32(11), jnp.int32(3))
    assert jnp.all(jax.random.key_data(k1) == jax.random.key_data(k2))
    k3 = rng.pixel_sample_key(7, jnp.int32(12), jnp.int32(3))
    assert not jnp.all(jax.random.key_data(k1) == jax.random.key_data(k3))
