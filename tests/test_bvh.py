"""BVH tests (SURVEY.md §4 property tier): builder invariants, native ≡
NumPy builder, and traversal ≡ brute force (the reference's HittableList
linear loop, HittableList.cpp:8-22, is the oracle)."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from raytrace2.scene import bvh as bvh_mod
from raytrace2.ops import bvh_traverse

pytestmark = pytest.mark.tier0


def _random_aabbs(n, seed=0):
    rs = np.random.RandomState(seed)
    centers = rs.uniform(-50, 50, (n, 3))
    half = rs.uniform(0.1, 5.0, (n, 3))
    return (centers - half).astype(np.float32), (centers + half).astype(np.float32)


@pytest.mark.parametrize("n", [1, 2, 3, 7, 64, 257])
def test_builder_invariants(n):
    mn, mx = _random_aabbs(n, seed=n)
    t = bvh_mod.build(mn, mx, use_native=False)
    m = 2 * n - 1
    assert t.left.shape == (m,)
    leaves = t.prim >= 0
    assert leaves.sum() == n
    assert sorted(t.prim[leaves].tolist()) == list(range(n))
    # Every node's AABB contains its children's/leaf's AABBs.
    for i in range(m):
        if t.prim[i] >= 0:
            p = t.prim[i]
            assert np.all(t.aabb_min[i] <= mn[p] + 1e-5)
            assert np.all(t.aabb_max[i] >= mx[p] - 1e-5)
        else:
            for c in (t.left[i], t.right[i]):
                assert np.all(t.aabb_min[i] <= t.aabb_min[c] + 1e-5)
                assert np.all(t.aabb_max[i] >= t.aabb_max[c] - 1e-5)


@pytest.mark.parametrize("n", [1, 2, 5, 100, 1023])
def test_native_matches_numpy(n):
    if bvh_mod._native_lib() is None:
        pytest.skip("native builder not built")
    mn, mx = _random_aabbs(n, seed=100 + n)
    a = bvh_mod.build(mn, mx, use_native=False)
    b = bvh_mod.build(mn, mx, use_native=True)
    np.testing.assert_array_equal(a.left, b.left)
    np.testing.assert_array_equal(a.right, b.right)
    np.testing.assert_array_equal(a.prim, b.prim)
    np.testing.assert_allclose(a.aabb_min, b.aabb_min)
    np.testing.assert_allclose(a.aabb_max, b.aabb_max)


def _sphere_leaf_fn(centers, radii):
    def leaf(prim, t_min, t_max):
        c = centers[prim]
        r = radii[prim]
        return prim, c, r, t_min, t_max

    def leaf_t(o, d):
        def fn(prim, t_min, t_max):
            c = centers[prim]
            r = radii[prim]
            oc = c - o
            a = jnp.dot(d, d)
            h = jnp.dot(d, oc)
            cc = jnp.dot(oc, oc) - r * r
            disc = h * h - a * cc
            sq = jnp.sqrt(jnp.maximum(disc, 0.0))
            r0 = (h - sq) / a
            r1 = (h + sq) / a
            ok0 = (r0 > t_min) & (r0 < t_max)
            ok1 = (r1 > t_min) & (r1 < t_max)
            root = jnp.where(ok0, r0, r1)
            return jnp.where((disc >= 0) & (ok0 | ok1), root, bvh_traverse.BIG)
        return fn

    return leaf_t


def _brute_force(centers, radii, o, d, t_min, t_max):
    """Oracle: linear closest-hit loop (HittableList.cpp:8-22 semantics).

    Computed in float64: the traversal runs in f32 and XLA:CPU fuses the
    quadratic's multiply-adds into FMAs, so an f32 NumPy oracle differs from
    it by order-of-operations alone (observed rel ~1.4e-5 > f32 eps·100 on
    grazing hits). A f64 oracle makes the comparison one-sided: the only
    error left is the traversal's own f32 rounding.
    """
    centers, radii = centers.astype(np.float64), radii.astype(np.float64)
    o, d = o.astype(np.float64), d.astype(np.float64)
    t_min, t_max = t_min.astype(np.float64), t_max.astype(np.float64)
    oc = centers[None] - o[:, None]                      # [N,S,3]
    a = np.sum(d * d, -1)[:, None]
    h = np.sum(d[:, None] * oc, -1)
    cc = np.sum(oc * oc, -1) - radii[None] ** 2
    disc = h * h - a * cc
    sq = np.sqrt(np.maximum(disc, 0))
    r0 = (h - sq) / a
    r1 = (h + sq) / a
    ok0 = (r0 > t_min[:, None]) & (r0 < t_max[:, None])
    ok1 = (r1 > t_min[:, None]) & (r1 < t_max[:, None])
    root = np.where(ok0, r0, r1)
    valid = (disc >= 0) & (ok0 | ok1)
    ts = np.where(valid, root, np.inf)
    best = ts.min(1)
    prim = np.where(np.isfinite(best), ts.argmin(1), -1)
    return best, prim


@pytest.mark.parametrize("n_prims,n_rays,seed", [(1, 64, 0), (13, 128, 1), (200, 256, 2)])
def test_traversal_matches_brute_force(n_prims, n_rays, seed):
    rs = np.random.RandomState(seed)
    centers = rs.uniform(-20, 20, (n_prims, 3)).astype(np.float32)
    radii = rs.uniform(0.2, 3.0, n_prims).astype(np.float32)
    tree = bvh_mod.build(centers - radii[:, None], centers + radii[:, None], use_native=False)
    md = bvh_mod.depth(tree)

    o = rs.uniform(-30, 30, (n_rays, 3)).astype(np.float32)
    d = rs.normal(size=(n_rays, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    t_min = np.full(n_rays, 1e-3, np.float32)
    t_max = np.full(n_rays, 1e9, np.float32)

    cj = jnp.asarray(centers)
    rj = jnp.asarray(radii)
    tree_j = jax.tree_util.tree_map(jnp.asarray, tree)
    leaf_factory = _sphere_leaf_fn(cj, rj)

    @jax.jit
    def run(o, d, t0, t1):
        def one(oo, dd, a, b):
            return bvh_traverse.traverse_one(
                tree_j, leaf_factory(oo, dd), oo, dd, a, b, md
            )
        return jax.vmap(one)(o, d, t0, t1)

    got_t, got_p = map(np.asarray, run(o, d, t_min, t_max))
    want_t, want_p = _brute_force(centers, radii, o, d, t_min, t_max)

    miss = want_p < 0
    np.testing.assert_array_equal(got_p[miss], -1)
    hit = ~miss
    # rtol 1e-4: the traversal solves the quadratic in f32 (with FMA
    # contraction under XLA); against the f64 oracle the worst case is the
    # f32 cancellation error of (h - sqrt(disc)) on grazing hits.
    np.testing.assert_allclose(got_t[hit], want_t[hit], rtol=1e-4, atol=1e-5)
    np.testing.assert_array_equal(got_p[hit], want_p[hit])


def test_depth_reasonable():
    mn, mx = _random_aabbs(1024, seed=9)
    t = bvh_mod.build(mn, mx, use_native=False)
    d = bvh_mod.depth(t)
    assert 10 <= d <= 64  # median split on 1024 prims ≈ balanced (10) but allow slack


# ---------------------------------------------------------------------------
# Production integration: the BVH sphere path in closest_hit / Renderer
# ---------------------------------------------------------------------------


def test_closest_hit_bvh_matches_dense():
    """_sphere_best_bvh ≡ the dense sweep through the full closest_hit,
    including moving spheres (motion-inclusive AABBs)."""
    import dataclasses

    from raytrace2 import defs
    from raytrace2.ops import intersect
    from raytrace2.scene import schema

    rs = np.random.RandomState(11)
    n = 300
    centers = rs.uniform(-20, 20, (n, 3)).astype(np.float32)
    disp = np.zeros((n, 3), np.float32)
    disp[: n // 4] = rs.uniform(-1, 1, (n // 4, 3))  # some moving spheres
    radii = rs.uniform(0.2, 2.0, n).astype(np.float32)
    spheres = schema.make_spheres(centers, disp, radii, np.zeros(n), pad_to=n + 12)
    quads = schema.make_quads(
        np.zeros((0, 3)), np.zeros((0, 3)), np.zeros((0, 3)), np.zeros(0)
    )
    mats = schema.Materials(
        mtype=np.zeros(1, defs.INDEX), albedo=np.ones((1, 3), defs.REAL),
        param=np.zeros(1, defs.REAL), tex=np.zeros(1, defs.INDEX),
    )
    texs = schema.Textures(
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
    scene = schema.FlatScene(
        spheres=spheres, quads=quads, boxes=schema.empty_boxes(),
        media=schema.empty_media(), materials=mats, textures=texs,
        camera=cam, background=np.zeros(3, defs.REAL),
    )
    tree, md = bvh_mod.build_sphere_bvh(scene.spheres)
    scene_bvh = dataclasses.replace(scene, sphere_bvh=tree)
    dev_dense = schema.to_device(scene)
    dev_bvh = schema.to_device(scene_bvh)

    n_rays = 512
    o = jnp.asarray(rs.uniform(-30, 30, (n_rays, 3)), jnp.float32)
    d = rs.normal(size=(n_rays, 3)).astype(np.float32)
    d = jnp.asarray(d / np.linalg.norm(d, axis=-1, keepdims=True))
    time = jnp.asarray(rs.uniform(0, 1, n_rays), jnp.float32)

    feat_d = {"has_media": False}
    feat_b = {"has_media": False, "use_bvh_spheres": True, "bvh_depth": md}
    hd = jax.jit(functools.partial(intersect.closest_hit, features=feat_d))(
        dev_dense, o, d, time
    )
    hb = jax.jit(functools.partial(intersect.closest_hit, features=feat_b))(
        dev_bvh, o, d, time
    )
    np.testing.assert_array_equal(np.asarray(hd.valid), np.asarray(hb.valid))
    hit = np.asarray(hd.valid)
    # rtol 2e-4: the dense sweep expands oc·oc algebraically into
    # contractions (c0·c0 + 2t c0·disp + ... − 2 o·c0 + o·o), while the BVH
    # leaf computes oc = c−o directly — mathematically identical, different
    # f32 rounding (observed max rel ≈ 7e-5 over 300 spheres).
    np.testing.assert_allclose(
        np.asarray(hd.t)[hit], np.asarray(hb.t)[hit], rtol=2e-4, atol=1e-4
    )
    np.testing.assert_array_equal(
        np.asarray(hd.material)[hit], np.asarray(hb.material)[hit]
    )


def test_renderer_bvh_backend_matches_dense(data_dir):
    """End-to-end production caller: Renderer(backend='bvh') on book1 (486
    spheres) must render the same image as the dense XLA path — same RNG
    streams, same hits, sublinear sweep."""
    from raytrace2 import render as render_mod
    from raytrace2.scene import loader

    scene, _ = loader.load_scene(f"{data_dir}/book1_final.json")
    kw = dict(width=24, height=16, num_samples=4, max_depth=6, seed=0,
              chunk_size=None)
    r_dense = render_mod.Renderer(scene=scene, backend="xla", **kw)
    assert not dict(r_dense._features).get("use_bvh_spheres", False) or \
        dict(r_dense._features)["use_bvh_spheres"]  # auto may enable it
    r_bvh = render_mod.Renderer(scene=scene, backend="bvh", **kw)
    assert dict(r_bvh._features)["use_bvh_spheres"]
    img_d = r_dense.render(batch=4)
    img_b = r_bvh.render(batch=4)
    np.testing.assert_allclose(img_b, img_d, rtol=1e-4, atol=1e-5)


def test_scenes_beyond_record_limit_use_bvh_fallback(monkeypatch):
    """Past megakernel.MAX_RECORDS (4096) a 5,000-sphere scene is outside
    the kernel's scope even on a GPU, so 'auto' routes to the XLA path with
    the sphere BVH enabled — sublinear like the reference's App-level BVH
    wrap (src/App.cpp:126) — and renders the same image as the
    forced-dense sweep."""
    import dataclasses

    from raytrace2 import render as render_mod
    from raytrace2.ops.pallas import megakernel as mk
    from raytrace2.scene import perlin, schema

    rs = np.random.RandomState(7)
    n = mk.MAX_RECORDS + 904  # 5,000
    # Non-overlapping grid (spacing 1.5 > 2*max radius): overlapping random
    # spheres would legitimately flip closest-hit winners between the BVH
    # and dense sweeps on f32 ties, which is not what this test gates.
    side = int(np.ceil(np.sqrt(n)))
    gx, gz = np.meshgrid(np.arange(side), np.arange(side))
    centers = np.stack([
        (gx.reshape(-1)[:n] - side / 2) * 1.5,
        rs.uniform(0.5, 4.0, n),
        (gz.reshape(-1)[:n] - side / 2) * 1.5,
    ], axis=-1)
    scene = schema.FlatScene(
        spheres=schema.make_spheres(
            centers, np.zeros((n, 3)), rs.uniform(0.2, 0.5, n),
            np.zeros(n, np.int32)),
        quads=schema.make_quads(
            [[-50, 0, -50]], [[100, 0, 0]], [[0, 0, 100]], [0]),
        boxes=schema.empty_boxes(),
        media=schema.empty_media(),
        materials=schema.Materials(
            mtype=np.array([0], np.int32),
            albedo=np.array([[0.6, 0.6, 0.6]], np.float32),
            param=np.zeros(1, np.float32), tex=np.zeros(1, np.int32)),
        textures=schema.Textures(
            ttype=np.zeros(1, np.int32),
            albedo=np.array([[0.5, 0.5, 0.5]], np.float32),
            inv_scale=np.ones(1, np.float32), scale=np.ones(1, np.float32),
            even=np.zeros(1, np.int32), odd=np.zeros(1, np.int32),
            noise_type=np.zeros(1, np.int32),
            perm=np.tile(perlin.identity_tables()[0], (1, 1, 1)),
            grad=np.zeros((1, 256, 3), np.float32)),
        camera=schema.CameraParams(
            center=np.array([0.0, 6.0, 60.0], np.float32),
            look_at=np.zeros(3, np.float32),
            vup=np.array([0.0, 1.0, 0.0], np.float32),
            vfov=np.float32(30.0), defocus_angle=np.float32(0.0),
            focus_dist=np.float32(10.0)),
        background=np.array([0.7, 0.8, 1.0], np.float32),
    )
    kw = dict(width=16, height=12, num_samples=1, max_depth=4, seed=0,
              chunk_size=None)
    monkeypatch.setattr(render_mod.jax, "default_backend", lambda: "gpu")
    r_auto = render_mod.Renderer(scene=scene, backend="auto", **kw)
    monkeypatch.undo()
    feats = dict(r_auto._features)
    assert not feats["use_megakernel"], "5k records exceed the kernel's scope"
    assert feats["use_bvh_spheres"], "auto must enable the BVH fallback"
    r_dense = render_mod.Renderer(
        scene=dataclasses.replace(scene), backend="xla", **kw)
    r_dense._features = tuple(sorted(
        {**dict(r_dense._features), "use_bvh_spheres": False}.items()))
    img_a = np.asarray(r_auto.render(batch=1))
    img_d = np.asarray(r_dense.render(batch=1))
    # At this resolution every ray grazes several tiny spheres, so a few
    # marginal hits legitimately flip on the traversal's f32 AABB slab
    # rounding (same class as test_traversal_matches_brute_force's
    # tolerance). Gate: almost all pixels agree tightly, and the agreeing
    # ones are exact-path identical.
    per_px = np.abs(img_a - img_d).max(-1)
    flipped = per_px > 1e-4
    assert flipped.mean() < 0.05, f"{flipped.sum()} flipped pixels"
    np.testing.assert_allclose(
        img_a[~flipped], img_d[~flipped], rtol=1e-4, atol=1e-5)
    assert abs(img_a.mean() - img_d.mean()) < 0.01


def test_gpu_auto_routes_cornell_to_megakernel(data_dir, monkeypatch):
    """On a GPU 'auto' takes the kernel for a scene it supports (compiled,
    never interpreted); on the CPU it takes XLA; 'mega' forces the kernel,
    interpreted on the CPU."""
    from raytrace2 import render as render_mod
    from raytrace2.scene import loader

    scene, _ = loader.load_scene(f"{data_dir}/cornell_box_original.json")
    kw = dict(width=16, height=12, num_samples=1, max_depth=4, seed=0)
    cpu = dict(render_mod.Renderer(scene=scene, backend="auto", **kw)._features)
    assert not cpu["use_megakernel"]
    forced = dict(render_mod.Renderer(scene=scene, backend="mega", **kw)._features)
    assert forced["use_megakernel"] and forced["mega_interpret"]
    monkeypatch.setattr(render_mod.jax, "default_backend", lambda: "gpu")
    gpu = dict(render_mod.Renderer(scene=scene, backend="auto", **kw)._features)
    assert gpu["use_megakernel"] and not gpu["mega_interpret"]
