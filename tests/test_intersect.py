"""Closed-form intersection tests (SURVEY.md §4 unit tier): sphere/quad/AABB
math vs. hand-computed geometry; reference semantics from
src/cpu_raytrace/Sphere.cpp, Quad.cpp, ConstantMedium.cpp."""

import jax
import jax.numpy as jnp
import numpy as np

from raytrace2 import defs
from raytrace2.scene import schema
from raytrace2.ops import intersect
import pytest

pytestmark = pytest.mark.tier0


def _ray(o, d, n=1):
    o = jnp.tile(jnp.asarray(o, jnp.float32), (n, 1))
    d = jnp.tile(jnp.asarray(d, jnp.float32), (n, 1))
    t = jnp.zeros(n, jnp.float32)
    return o, d, t


def _scene(spheres=None, quads=None, media=None):
    if spheres is None:
        spheres = schema.make_spheres(
            np.zeros((0, 3)), np.zeros((0, 3)), np.zeros(0), np.zeros(0, np.int64)
        )
    if quads is None:
        quads = schema.make_quads(
            np.zeros((0, 3)), np.zeros((0, 3)), np.zeros((0, 3)), np.zeros(0, np.int64)
        )
    if media is None:
        media = schema.empty_media()
    materials = schema.Materials(
        mtype=np.zeros(2, defs.INDEX),
        albedo=np.ones((2, 3), defs.REAL),
        param=np.zeros(2, defs.REAL),
        tex=np.zeros(2, defs.INDEX),
    )
    textures = schema.Textures(
        ttype=np.zeros(1, defs.INDEX), albedo=np.ones((1, 3), defs.REAL),
        inv_scale=np.ones(1, defs.REAL), scale=np.ones(1, defs.REAL),
        even=np.zeros(1, defs.INDEX), odd=np.zeros(1, defs.INDEX),
        noise_type=np.zeros(1, defs.INDEX),
        perm=np.zeros((1, 3, 256), defs.INDEX), grad=np.zeros((1, 256, 3), defs.REAL),
    )
    cam = schema.CameraParams(
        center=np.zeros(3, defs.REAL), look_at=np.array([0, 0, -1], defs.REAL),
        vup=np.array([0, 1, 0], defs.REAL), vfov=defs.REAL(90),
        defocus_angle=defs.REAL(0), focus_dist=defs.REAL(1),
    )
    return schema.FlatScene(
        spheres=spheres, quads=quads, boxes=schema.empty_boxes(), media=media,
        materials=materials,
        textures=textures, camera=cam, background=np.zeros(3, defs.REAL),
    )


def _hit(scene, o, d, t, u_media=None, **kw):
    fn = jax.jit(
        lambda s, o, d, t, u: intersect.closest_hit(s, o, d, t, u, **kw)
    )
    return fn(schema.to_device(scene), o, d, t, u_media)


def test_sphere_head_on():
    sp = schema.make_spheres([[0, 0, -5]], [[0, 0, 0]], [1.0], [0])
    scene = _scene(spheres=sp)
    o, d, t = _ray([0, 0, 0], [0, 0, -1])
    hit = _hit(scene, o, d, t)
    assert bool(hit.valid[0])
    np.testing.assert_allclose(hit.t[0], 4.0, rtol=1e-6)
    np.testing.assert_allclose(hit.point[0], [0, 0, -4], atol=1e-6)
    np.testing.assert_allclose(hit.normal[0], [0, 0, 1], atol=1e-6)
    assert bool(hit.front_face[0])
    # UV at the +z-facing point: outward normal (0,0,1) → phi = atan2(-1,0)+π
    # = π/2, theta = acos(0) = π/2 → uv = (0.25, 0.5) (Sphere.cpp:39-43).
    np.testing.assert_allclose(hit.uv[0], [0.25, 0.5], atol=1e-6)


def test_sphere_inside_back_face():
    sp = schema.make_spheres([[0, 0, 0]], [[0, 0, 0]], [2.0], [0])
    scene = _scene(spheres=sp)
    o, d, t = _ray([0, 0, 0], [1, 0, 0])
    hit = _hit(scene, o, d, t)
    assert bool(hit.valid[0])
    np.testing.assert_allclose(hit.t[0], 2.0, rtol=1e-6)
    assert not bool(hit.front_face[0])  # hit from inside
    np.testing.assert_allclose(hit.normal[0], [-1, 0, 0], atol=1e-6)  # flipped


def test_moving_sphere_lerps_center():
    # center0 = (0,0,-5), displacement (0,0,-5): at time 1 center = (0,0,-10)
    # (Sphere.cpp:8, center stored as a Ray evaluated at r.time).
    sp = schema.make_spheres([[0, 0, -5]], [[0, 0, -5]], [1.0], [0])
    scene = _scene(spheres=sp)
    o = jnp.zeros((2, 3)); d = jnp.tile(jnp.array([0.0, 0.0, -1.0]), (2, 1))
    t = jnp.array([0.0, 1.0])
    hit = _hit(scene, o, d, t)
    np.testing.assert_allclose(hit.t, [4.0, 9.0], rtol=1e-6)


def test_sphere_t_interval_strict():
    sp = schema.make_spheres([[0, 0, -5]], [[0, 0, 0]], [1.0], [0])
    scene = _scene(spheres=sp)
    o, d, t = _ray([0, 0, 0], [0, 0, -1])
    # Entry root exactly at t_max → Surrounds is strict → takes far root?
    # far root 6 > t_max → miss entirely.
    hit = _hit(scene, o, d, t, t_max=jnp.array([4.0]))
    assert not bool(hit.valid[0])
    # Ray starting inside t interval excluding near root picks far root.
    hit = _hit(scene, o, d, t, t_min=jnp.array([4.5]))
    assert bool(hit.valid[0])
    np.testing.assert_allclose(hit.t[0], 6.0, rtol=1e-6)


def test_quad_hit_and_uv():
    q = schema.make_quads([[-1, -1, -2]], [[2, 0, 0]], [[0, 2, 0]], [0])
    scene = _scene(quads=q)
    o, d, t = _ray([-0.5, 0.5, 0], [0, 0, -1])
    hit = _hit(scene, o, d, t)
    assert bool(hit.valid[0])
    np.testing.assert_allclose(hit.t[0], 2.0, rtol=1e-6)
    # planar coords: (p - q)/2 → alpha=(−0.5+1)/2=0.25, beta=(0.5+1)/2=0.75
    np.testing.assert_allclose(hit.uv[0], [0.25, 0.75], atol=1e-5)
    np.testing.assert_allclose(hit.normal[0], [0, 0, 1], atol=1e-6)


def test_quad_miss_outside():
    q = schema.make_quads([[-1, -1, -2]], [[2, 0, 0]], [[0, 2, 0]], [0])
    scene = _scene(quads=q)
    o, d, t = _ray([1.5, 0, 0], [0, 0, -1])  # beyond +u edge
    hit = _hit(scene, o, d, t)
    assert not bool(hit.valid[0])


def test_quad_parallel_ray():
    q = schema.make_quads([[-1, -1, -2]], [[2, 0, 0]], [[0, 2, 0]], [0])
    scene = _scene(quads=q)
    o, d, t = _ray([0, 0, 0], [1, 0, 0])  # parallel to plane
    hit = _hit(scene, o, d, t)
    assert not bool(hit.valid[0])


def test_closest_of_two_families():
    sp = schema.make_spheres([[0, 0, -3]], [[0, 0, 0]], [1.0], [0])
    q = schema.make_quads([[-5, -5, -6]], [[10, 0, 0]], [[0, 10, 0]], [1])
    scene = _scene(spheres=sp, quads=q)
    o, d, t = _ray([0, 0, 0], [0, 0, -1])
    hit = _hit(scene, o, d, t)
    np.testing.assert_allclose(hit.t[0], 2.0, rtol=1e-6)  # sphere in front
    assert int(hit.material[0]) == 0
    # Offset ray misses sphere, hits quad behind.
    o, d, t = _ray([3, 0, 0], [0, 0, -1])
    hit = _hit(scene, o, d, t)
    np.testing.assert_allclose(hit.t[0], 6.0, rtol=1e-6)
    assert int(hit.material[0]) == 1


def test_medium_free_path_distribution():
    """Exponential free-path sampling inside a box medium
    (ConstantMedium.cpp:40-48): with density ρ and chord length L, the hit
    probability is 1 - exp(-ρL)."""
    density = 0.5
    media = schema.Media(
        btype=np.array([defs.MEDIUM_BOX], defs.INDEX),
        p0=np.array([[-1, -1, -4]], defs.REAL),
        p1=np.array([[1, 1, -2]], defs.REAL),
        displacement=np.zeros((1, 3), defs.REAL),
        inv_model=np.tile(np.hstack([np.eye(3), np.zeros((3, 1))]), (1, 1, 1)).astype(defs.REAL),
        neg_inv_density=np.array([-1.0 / density], defs.REAL),
        material=np.zeros(1, defs.INDEX),
        active=np.ones(1, bool),
    )
    scene = _scene(media=media)
    n = 4096
    o, d, t = _ray([0, 0, 0], [0, 0, -1], n)
    u = jax.random.uniform(jax.random.key(0), (n, 1))
    hit = _hit(scene, o, d, t, u_media=u)
    frac = float(np.asarray(hit.valid).mean())
    expected = 1.0 - np.exp(-density * 2.0)  # chord L=2
    assert abs(frac - expected) < 0.03
    ts = np.asarray(hit.t)[np.asarray(hit.valid)]
    assert np.all(ts >= 2.0) and np.all(ts <= 4.0)


def test_medium_inactive_is_transparent():
    scene = _scene()  # empty_media: inactive row
    o, d, t = _ray([0, 0, 0], [0, 0, -1])
    u = jnp.ones((1, 1)) * 1e-9  # would always scatter if active
    hit = _hit(scene, o, d, t, u_media=u)
    assert not bool(hit.valid[0])


def test_inactive_padding_never_hits():
    sp = schema.make_spheres([[0, 0, -5]], [[0, 0, 0]], [1.0], [0], pad_to=8)
    scene = _scene(spheres=sp)
    o, d, t = _ray([10, 10, 10], [0, 0, 1])  # away from everything
    hit = _hit(scene, o, d, t)
    assert not bool(hit.valid[0])
