"""Gradient correctness (SURVEY.md §4 tier 4): reverse-mode pixel gradients
vs. central finite differences on scene parameters, at fixed RNG keys."""

import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from raytrace2 import grad as grad_mod
from raytrace2.scene import loader, schema


def _scene(tmp_path):
    j = {
        "background_color": [0.6, 0.7, 0.9],
        "camera": {"fov": 50, "center": [0, 1.5, 4], "look_at": [0, 0.5, 0]},
        "materials": [
            {"type": "lambertian", "albedo": [0.7, 0.3, 0.3]},
            {"type": "metal", "albedo": [0.8, 0.8, 0.8], "fuzz": 0.2},
            {"type": "diffuse_light", "albedo": [4, 4, 4]},
        ],
        "primitives": [
            {"type": "sphere", "center": [0, 0.5, 0], "radius": 0.8, "material": 0},
            {"type": "sphere", "center": [1.4, 0.4, 0.6], "radius": 0.4, "material": 1},
            {"type": "quad", "q": [-30, 0, -30], "u": [60, 0, 0], "v": [0, 0, 60], "material": 0},
            {"type": "quad", "q": [-1, 3, -1], "u": [2, 0, 0], "v": [0, 0, 2], "material": 2},
        ],
    }
    p = tmp_path / "g.json"
    p.write_text(json.dumps(j))
    scene, _ = loader.load_scene(str(p))
    return schema.to_device(scene), tuple(sorted(scene.features().items()))


KW = dict(width=12, height=12, n_samples=4, max_depth=5, sqrt_spp=2)


def _loss(img):
    # Weighted mean so the gradient isn't spatially uniform.
    h, w, _ = img.shape
    wgt = jnp.linspace(0.5, 1.5, h)[:, None, None]
    return jnp.mean(img * wgt)


def _fd(f, x0, eps):
    return (f(x0 + eps) - f(x0 - eps)) / (2 * eps)


@pytest.mark.parametrize(
    "leaf,idx,eps,tol",
    [
        # Parameters with *continuous* influence on radiance: the detached
        # estimator's gradient matches finite differences. Geometry params
        # with solid materials influence radiance only through silhouette
        # motion (zero a.e. interior gradient) — those are covered by the
        # solve-level tests and the textured-scene test below.
        ("materials.albedo", (0, 0), 1e-3, 5e-3),     # lambertian red channel
        ("materials.param", (1,), 1e-3, 5e-2),        # metal fuzz
        ("background", (1,), 1e-3, 5e-3),
    ],
)
def test_grad_matches_finite_difference(tmp_path, leaf, idx, eps, tol):
    scene, features = _scene(tmp_path)

    def set_leaf(scene, delta):
        parts = leaf.split(".")
        if len(parts) == 1:
            obj = scene
            arr = getattr(obj, parts[0])
            new = arr.at[idx].add(delta) if idx else arr + delta
            return dataclasses.replace(obj, **{parts[0]: new})
        sub = getattr(scene, parts[0])
        arr = getattr(sub, parts[1])
        new = arr.at[idx].add(delta) if idx != () else arr + delta
        return dataclasses.replace(
            scene, **{parts[0]: dataclasses.replace(sub, **{parts[1]: new})}
        )

    def f(delta):
        img = grad_mod.render_image(set_leaf(scene, delta), features, 0, **KW)
        return float(_loss(img))

    loss, g = grad_mod.value_and_grad_scene(_loss, scene, features, 0, **KW)
    parts = leaf.split(".")
    gleaf = getattr(g, parts[0]) if len(parts) == 1 else getattr(getattr(g, parts[0]), parts[1])
    got = float(gleaf[idx]) if idx != () else float(jnp.sum(gleaf))

    want = _fd(f, 0.0, eps)
    assert np.isfinite(got)
    if abs(want) < 1e-6 and abs(got) < 1e-6:
        return
    assert got == pytest.approx(want, rel=tol, abs=1e-5), f"{leaf}{idx}: ad={got} fd={want}"


def test_intersection_solve_gradients(tmp_path):
    """Unit-level geometry gradients: d t / d radius and d t / d center of
    the hit *solve* vs. closed form. Ray from the origin along -z, sphere
    center (0,0,cz), radius r: near surface at z = cz + r → t = -(cz + r),
    so dt/dr = -1 and dt/dcz = -1."""
    from raytrace2.ops import intersect
    from raytrace2.scene import schema as sch
    import numpy as np_

    def make(r, cz):
        # Build the pytree with jnp directly (make_spheres is host-only).
        return sch.Spheres(
            center0=jnp.stack([jnp.zeros(()), jnp.zeros(()), cz])[None],
            displacement=jnp.zeros((1, 3)),
            radius=jnp.asarray(r)[None],
            material=jnp.zeros(1, jnp.int32),
            active=jnp.ones(1, bool),
        )

    o = jnp.array([[0.0, 0.0, 0.0]])
    d = jnp.array([[0.0, 0.0, -1.0]])
    t0 = jnp.zeros(1)
    tmin = jnp.full(1, 1e-3)
    tmax = jnp.full(1, 1e9)

    def t_of(r, cz):
        ts = intersect._sphere_ts(make(r, cz), o, d, t0, tmin, tmax)
        return ts.min()

    g_r = float(jax.grad(t_of, argnums=0)(0.8, -5.0))
    g_c = float(jax.grad(t_of, argnums=1)(0.8, -5.0))
    assert g_r == pytest.approx(-1.0, abs=1e-4)
    assert g_c == pytest.approx(-1.0, abs=1e-4)
    del np_


def test_geometry_gradient_through_noise_texture(tmp_path):
    """With a Perlin-marble floor, moving a mirror sphere shifts which floor
    points are shaded → radiance depends *continuously* on geometry; AD must
    track FD."""
    j = {
        "background_color": [0.8, 0.8, 0.8],
        "camera": {"fov": 45, "center": [0, 2, 5], "look_at": [0, 0.5, 0]},
        "textures": [{"type": "noise", "albedo": [0.9, 0.9, 0.9], "scale": 0.7,
                      "noise_type": 0}],
        "materials": [
            {"type": "texture", "tex_idx": 0},
            {"type": "metal", "albedo": [0.9, 0.9, 0.9], "fuzz": 0.0},
        ],
        "primitives": [
            {"type": "quad", "q": [-30, 0, -30], "u": [60, 0, 0], "v": [0, 0, 60], "material": 0},
            {"type": "sphere", "center": [0, 1.0, 0], "radius": 0.9, "material": 1},
        ],
    }
    p = tmp_path / "n.json"
    p.write_text(json.dumps(j))
    scene_host, _ = loader.load_scene(str(p))
    features = tuple(sorted(scene_host.features().items()))
    scene = schema.to_device(scene_host)

    def f(dz):
        moved = dataclasses.replace(
            scene,
            spheres=dataclasses.replace(
                scene.spheres, center0=scene.spheres.center0.at[0, 2].add(dz)
            ),
        )
        img = grad_mod.render_image(moved, features, 0, width=10, height=10,
                                    n_samples=2, max_depth=4, sqrt_spp=1)
        return jnp.mean(img)

    got = float(jax.grad(f)(0.0))
    want = float((f(5e-3) - f(-5e-3)) / 1e-2)
    assert np.isfinite(got) and got != 0.0
    # FD additionally measures the silhouette term (which detached sampling
    # deliberately omits) plus O(1) discrete-event flips at this spp, so only
    # sign and order of magnitude are comparable.
    assert np.sign(got) == np.sign(want)
    assert 0.2 < abs(got / want) < 5.0


def test_gradients_finite_everywhere(tmp_path):
    scene, features = _scene(tmp_path)
    _, g = grad_mod.value_and_grad_scene(_loss, scene, features, 0, **KW)
    for path, leaf in jax.tree_util.tree_leaves_with_path(g):
        if hasattr(leaf, "dtype") and jnp.issubdtype(leaf.dtype, jnp.floating):
            assert np.isfinite(np.asarray(leaf)).all(), f"non-finite grad at {path}"


def test_light_brightness_gradient_positive(tmp_path):
    """Turning up the light's emission must not darken the image."""
    scene, features = _scene(tmp_path)

    def loss(img):
        return jnp.mean(img)

    _, g = grad_mod.value_and_grad_scene(loss, scene, features, 0, **KW)
    # Light is material 2; emission comes from its auto-registered solid
    # texture's albedo.
    light_tex = int(scene.materials.tex[2])
    assert float(jnp.sum(g.textures.albedo[light_tex])) > 0.0


# ---------------------------------------------------------------------------
# Camera + quad-geometry FD rigor (VERDICT r1 #5): every differentiable
# CameraParams leaf and the floor quad's q/u/v, through the full render.
# A Perlin-marble floor makes radiance depend continuously on where rays
# land (Texture.cpp:13-22 noise), so the detached estimator's gradient is
# the exact derivative of the fixed-RNG primal and FD must match TIGHTLY
# (same deterministic function) — not just the 0.2–5x band of the
# silhouette-confounded tests above.
# ---------------------------------------------------------------------------


def _noise_scene(tmp_path):
    j = {
        "background_color": [0.7, 0.75, 0.8],
        "camera": {"fov": 42, "center": [0, 2, 5], "look_at": [0, 0.5, 0],
                   "defocus_angle": 1.5, "focus_dist": 5.2},
        "textures": [{"type": "noise", "albedo": [0.85, 0.8, 0.75],
                      "scale": 0.6, "noise_type": 0}],
        "materials": [
            {"type": "texture", "tex_idx": 0},
            {"type": "metal", "albedo": [0.9, 0.9, 0.9], "fuzz": 0.05},
        ],
        "primitives": [
            {"type": "quad", "q": [-30, 0, -30], "u": [60, 0, 0],
             "v": [0, 0, 60], "material": 0},
            {"type": "sphere", "center": [0, 1.0, 0], "radius": 0.9,
             "material": 1},
        ],
    }
    p = tmp_path / "cam_geo.json"
    p.write_text(json.dumps(j))
    scene, _ = loader.load_scene(str(p))
    return schema.to_device(scene), tuple(sorted(scene.features().items()))


CAM_KW = dict(width=10, height=10, n_samples=2, max_depth=4, sqrt_spp=1)


def _masked_fd_check(f_img, eps, label, rel=5e-2, min_keep=0.6):
    """AD vs central FD on the CONTINUOUS part of the render.

    The detached-selection estimator differentiates the radiance at fixed
    discrete structure (which primitive wins, reflect/refract branch, …);
    the a.e.-correct derivative excludes silhouette jumps. A plain FD of
    the mean at ±eps does NOT: one edge crossing a pixel contributes
    Δradiance/(2·eps·n_pix) — at eps=2e-3 that's ~0.4, swamping O(0.05)
    continuous gradients. So mask per pixel-channel by the SECOND central
    difference: continuous pixels have |f(+e)+f(-e)-2f(0)| = O(f''·e²) ≲
    1e-4, a branch flip shows the jump itself (≳1e-2). Compare AD against
    FD of the masked mean, tightly — on that subset both are derivatives
    of the same deterministic fixed-RNG f32 function.

    ``f_img(delta) -> [H,W,3]`` must be AD-traceable in delta.
    """
    img_p = np.asarray(f_img(+eps))
    img_m = np.asarray(f_img(-eps))
    img_0 = np.asarray(f_img(0.0))
    curv = np.abs(img_p + img_m - 2.0 * img_0)
    mask = jnp.asarray((curv < 1e-3).astype(np.float32))
    kept = float(mask.mean())
    assert kept >= min_keep, f"{label}: only {kept:.0%} pixels branch-stable"

    denom = float(mask.sum())
    want = float(((img_p - img_m) * np.asarray(mask)).sum() / (2 * eps) / denom)
    got = float(jax.grad(
        lambda d: jnp.sum(f_img(d) * mask) / denom)(0.0))
    assert np.isfinite(got), f"{label}: non-finite AD"
    if abs(want) < 5e-5 and abs(got) < 5e-5:
        return
    assert got == pytest.approx(want, rel=rel, abs=5e-5), (
        f"{label}: ad={got} fd={want} (kept={kept:.0%})")


@pytest.mark.parametrize(
    "leaf,idx,eps",
    [
        ("vfov", (), 2e-2),
        ("center", (0,), 2e-3),
        ("center", (2,), 2e-3),
        ("look_at", (1,), 2e-3),
        ("vup", (0,), 2e-3),
        ("defocus_angle", (), 2e-2),
        ("focus_dist", (), 2e-3),
    ],
)
def test_camera_gradients_match_fd(tmp_path, leaf, idx, eps):
    scene, features = _noise_scene(tmp_path)

    def f_img(delta):
        arr = getattr(scene.camera, leaf)
        new = arr.at[idx].add(delta) if idx != () else arr + delta
        moved = dataclasses.replace(
            scene, camera=dataclasses.replace(scene.camera, **{leaf: new}))
        return grad_mod.render_image(moved, features, 0, **CAM_KW)

    _masked_fd_check(f_img, eps, f"camera.{leaf}{idx}")


@pytest.mark.parametrize(
    "field,idx,eps",
    [
        ("q", (0, 1), 2e-3),   # floor height: every diffuse bounce shifts
        ("u", (0, 0), 2e-3),   # texture-space stretch
        ("v", (0, 2), 2e-3),
    ],
)
def test_quad_geometry_gradients_match_fd(tmp_path, field, idx, eps):
    scene, features = _noise_scene(tmp_path)

    def f_img(delta):
        arr = getattr(scene.quads, field)
        moved_q = dataclasses.replace(scene.quads, **{field: arr.at[idx].add(delta)})
        # Re-derive the packed plane rows the intersector actually reads
        # (normal/d/w are functions of q/u/v — loader._pack_quads).
        moved = dataclasses.replace(
            scene, quads=schema.derive_quad_plane(moved_q))
        return grad_mod.render_image(moved, features, 0, **CAM_KW)

    _masked_fd_check(f_img, eps, f"quad.{field}{idx}")
