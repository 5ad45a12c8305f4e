"""Camera ray-generation tests vs. the reference math
(src/cpu_raytrace/Camera.hpp:16-67)."""

import jax
import jax.numpy as jnp
import numpy as np

from raytrace2 import defs
from raytrace2.scene import schema
from raytrace2.ops import camera as cam_ops, rng


def _cam(center=(0, 0, 0), look_at=(0, 0, -1), vfov=90.0, defocus=0.0, focus=1.0):
    return schema.CameraParams(
        center=np.asarray(center, defs.REAL),
        look_at=np.asarray(look_at, defs.REAL),
        vup=np.array([0, 1, 0], defs.REAL),
        vfov=defs.REAL(vfov),
        defocus_angle=defs.REAL(defocus),
        focus_dist=defs.REAL(focus),
    )


import functools
import pytest

pytestmark = pytest.mark.tier0


@functools.partial(jax.jit, static_argnames=("w", "h", "sqrt_spp"))
def _rays_impl(cam, w, h, sample, sqrt_spp, seed):
    keys = jax.vmap(lambda p: rng.pixel_sample_key(seed, p, sample))(
        jnp.arange(w * h, dtype=jnp.int32)
    )
    return cam_ops.generate_rays(cam, w, h, sample, sqrt_spp, keys)


def _rays(cam, w, h, sample=0, sqrt_spp=1, seed=0):
    return _rays_impl(cam, w, h, jnp.int32(sample), sqrt_spp, jnp.int32(seed))


def test_rays_normalized_and_from_center():
    o, d, t = _rays(_cam(), 16, 16)
    np.testing.assert_allclose(np.linalg.norm(np.asarray(d), axis=-1), 1.0, atol=1e-6)
    np.testing.assert_allclose(np.asarray(o), 0.0, atol=1e-7)
    tt = np.asarray(t)
    assert np.all((tt >= 0) & (tt < 1))


def test_fov_bounds():
    # vfov 90°, focus 1 → viewport height 2; edge rays' vertical slope ±~1.
    w = h = 64
    o, d, t = _rays(_cam(), w, h)
    d = np.asarray(d).reshape(h, w, 3)
    slope_up = d[:, w // 2, 1] / -d[:, w // 2, 2]
    assert abs(abs(slope_up[0]) - 1.0) < 0.05
    assert abs(abs(slope_up[-1]) - 1.0) < 0.05


def test_center_pixel_points_at_lookat():
    cam = _cam(center=(1, 2, 3), look_at=(4, 5, 6))
    w = h = 63  # odd → true center pixel
    o, d, t = _rays(cam, w, h)
    d = np.asarray(d).reshape(h, w, 3)
    fwd = np.array([3.0, 3.0, 3.0]) / np.linalg.norm([3.0, 3.0, 3.0])
    assert np.dot(d[h // 2, w // 2], fwd) > 0.999


def test_stratification_covers_cell():
    """Sample s of spp=4 jitters within its (s_i, s_j) half-pixel cell
    (Camera.hpp:52-58, RayTracer.cpp:57-60)."""
    cam = _cam()
    w = h = 1
    offsets = []
    for s in range(4):
        pts = []
        for seed in range(200):
            o, d, t = _rays(cam, w, h, sample=s, sqrt_spp=2, seed=seed)
            dd = np.asarray(d)[0]
            pts.append(dd[:2] / -dd[2])
        offsets.append(np.array(pts))
    # Strata means should sit in distinct quadrants around the pixel center.
    m = [p.mean(0) for p in offsets]
    assert m[0][0] < m[1][0]  # s_i=0 left of s_i=1
    assert m[0][1] < m[2][1]  # s_j=0 below s_j=1
    # And all samples stay within the pixel footprint (viewport h 2/1px → |x|<=1).
    for p in offsets:
        assert np.all(np.abs(p) <= 1.0 + 1e-5)


def test_defocus_disk_spreads_origins():
    cam = _cam(defocus=10.0, focus=5.0)
    o, d, t = _rays(cam, 32, 32)
    o = np.asarray(o)
    assert o.std(0).max() > 0.01  # origins sampled on the aperture disk
    # Rays still converge at the focal plane: o + t*d at t≈|focus| along -z
    # hits a tight spot for the center pixel — check focal point variance is
    # much smaller than origin variance for a single pixel's many samples.
    pts = []
    w = h = 9
    center = (h // 2) * w + (w // 2)
    for seed in range(64):
        oo, dd, _ = _rays(_cam(defocus=10.0, focus=5.0), w, h, seed=seed)
        oo, dd = np.asarray(oo)[center], np.asarray(dd)[center]
        s = 5.0 / -dd[2]  # reach z=-5 plane
        pts.append(oo + s * dd)
    pts = np.array(pts)
    # Converged spread ≈ one pixel footprint at the focal plane
    # (viewport 10 units / 9 px ≈ 1.1) — far below the no-convergence spread
    # (aperture radius 5·tan5° ≈ 0.44 *plus* pixel jitter).
    assert pts.std(0).max() < 0.6
    assert np.array([p for p in pts]).std(0).max() > 0.0
