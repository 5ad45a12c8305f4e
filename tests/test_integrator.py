"""Integrator tests: exact 'furnace' scenes with closed-form radiance, plus
semantics of the depth cap and background (src/cpu_raytrace/RayTracer.cpp:20-45)."""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from raytrace2.scene import loader, schema
from raytrace2.ops import integrator
from raytrace2 import render as render_mod


def _build(scene_json: dict, tmp_path, name="s.json"):
    p = tmp_path / name
    p.write_text(json.dumps(scene_json))
    scene, dims = loader.load_scene(str(p))
    return scene


def _render(scene, w=8, h=8, spp=64, depth=8, seed=0):
    features = tuple(sorted(scene.features().items()))
    scene = schema.to_device(scene)
    state = render_mod.init_state(w, h)
    for _ in range(spp):
        state = render_mod.render_step(
            scene, features, state, seed, width=w, height=h,
            max_depth=depth, sqrt_spp=max(int(np.sqrt(spp)), 1), chunk_size=None,
        )
    return np.asarray(render_mod.linear_image(state))


def test_emissive_enclosure_exact(tmp_path):
    """Camera inside an emissive sphere: every ray hits the light at bounce 0
    → radiance exactly the emitted value, zero variance."""
    scene = _build(
        {
            "background_color": [0, 0, 0],
            "camera": {"fov": 90, "center": [0, 0, 0], "look_at": [0, 0, -1]},
            "materials": [{"type": "diffuse_light", "albedo": [2.0, 3.0, 4.0]}],
            "primitives": [{"type": "sphere", "center": [0, 0, 0], "radius": 10.0, "material": 0}],
        },
        tmp_path,
    )
    img = _render(scene, spp=4)
    np.testing.assert_allclose(img, np.broadcast_to([2.0, 3.0, 4.0], img.shape), rtol=1e-5)


def test_background_only(tmp_path):
    scene = _build(
        {
            "background_color": [0.2, 0.4, 0.6],
            "camera": {"fov": 90, "center": [0, 0, 0], "look_at": [0, 0, -1]},
            "materials": [{"type": "lambertian", "albedo": [1, 1, 1]}],
            "primitives": [],
        },
        tmp_path,
    )
    img = _render(scene, spp=2)
    np.testing.assert_allclose(img, np.broadcast_to([0.2, 0.4, 0.6], img.shape), rtol=1e-5)


def test_absorbing_enclosure_terminates_black(tmp_path):
    """Camera inside a lambertian sphere with no lights and black background:
    paths bounce until the depth cap and contribute nothing."""
    scene = _build(
        {
            "background_color": [0, 0, 0],
            "camera": {"fov": 90, "center": [0, 0, 0], "look_at": [0, 0, -1]},
            "materials": [{"type": "lambertian", "albedo": [0.9, 0.9, 0.9]}],
            "primitives": [{"type": "sphere", "center": [0, 0, 0], "radius": 5.0, "material": 0}],
        },
        tmp_path,
    )
    img = _render(scene, spp=4, depth=6)
    np.testing.assert_allclose(img, 0.0, atol=1e-7)


def test_lambertian_plane_under_sky_exact(tmp_path):
    """Every camera ray hits an infinite-ish lambertian floor; every scatter
    ray escapes to the background. Radiance = albedo * background exactly for
    every sample (no Monte Carlo variance in the *value*)."""
    albedo = [0.3, 0.5, 0.7]
    bg = [1.0, 0.8, 0.6]
    scene = _build(
        {
            "background_color": bg,
            "camera": {"fov": 40, "center": [0, 5, 0], "look_at": [0, 0, -10]},
            "materials": [{"type": "lambertian", "albedo": albedo}],
            "primitives": [
                {"type": "quad", "q": [-1000, 0, -1000], "u": [2000, 0, 0], "v": [0, 0, 2000], "material": 0}
            ],
        },
        tmp_path,
    )
    img = _render(scene, spp=8, depth=4)
    np.testing.assert_allclose(
        img, np.broadcast_to(np.array(albedo) * np.array(bg), img.shape), rtol=1e-4
    )


def test_depth_one_kills_indirect(tmp_path):
    """max_depth=1: floor scatter is traced but the scattered ray is never
    continued → contribution 0 (reference: depth-1 recursion returns black,
    RayTracer.cpp:21-22)."""
    scene = _build(
        {
            "background_color": [1, 1, 1],
            "camera": {"fov": 40, "center": [0, 5, 0], "look_at": [0, 0, -10]},
            "materials": [{"type": "lambertian", "albedo": [0.5, 0.5, 0.5]}],
            "primitives": [
                {"type": "quad", "q": [-1000, 0, -1000], "u": [2000, 0, 0], "v": [0, 0, 2000], "material": 0}
            ],
        },
        tmp_path,
    )
    img = _render(scene, spp=4, depth=1)
    np.testing.assert_allclose(img, 0.0, atol=1e-7)


def test_differentiable_matches_while_loop(tmp_path):
    scene = _build(
        {
            "background_color": [0.9, 0.9, 0.9],
            "camera": {"fov": 60, "center": [0, 1, 3], "look_at": [0, 0, 0]},
            "materials": [
                {"type": "lambertian", "albedo": [0.6, 0.2, 0.2]},
                {"type": "metal", "albedo": [0.9, 0.9, 0.9], "fuzz": 0.1},
            ],
            "primitives": [
                {"type": "sphere", "center": [0, 0, 0], "radius": 1.0, "material": 0},
                {"type": "quad", "q": [-50, -1, -50], "u": [100, 0, 0], "v": [0, 0, 100], "material": 1},
            ],
        },
        tmp_path,
    )
    features = tuple(sorted(scene.features().items()))
    dev = schema.to_device(scene)

    def go(differentiable):
        return np.asarray(
            jax.jit(
                lambda s: integrator.render_sample(
                    s, dict(features), 8, 8, jnp.int32(0), 0, 6, 2,
                    differentiable=differentiable,
                )
            )(dev)
        )

    np.testing.assert_allclose(go(False), go(True), rtol=1e-5, atol=1e-6)


def test_chunked_matches_unchunked(tmp_path):
    scene = _build(
        {
            "background_color": [0.5, 0.6, 0.7],
            "camera": {"fov": 60, "center": [0, 1, 3], "look_at": [0, 0, 0]},
            "materials": [{"type": "lambertian", "albedo": [0.6, 0.2, 0.2]}],
            "primitives": [{"type": "sphere", "center": [0, 0, 0], "radius": 1.0, "material": 0}],
        },
        tmp_path,
    )
    features = tuple(sorted(scene.features().items()))
    dev = schema.to_device(scene)

    def go(chunk):
        return np.asarray(
            jax.jit(
                lambda s: integrator.render_sample(
                    s, dict(features), 16, 8, jnp.int32(0), 0, 4, 1,
                    chunk_size=chunk,
                )
            )(dev)
        )

    # 128 rays; chunk 48 forces padding of the last chunk.
    np.testing.assert_allclose(go(None), go(48), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(go(None), go(32), rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("scene_name", ["cornell_box_original.json"])
def test_cornell_smoke_statistics(scene_name, data_dir):
    """Cornell at tiny res: mean brightness in a sane band and light pixels
    present (regression guard on end-to-end shading)."""
    scene, dims = loader.load_scene(f"{data_dir}/{scene_name}")
    img = _render(scene, w=24, h=24, spp=32, depth=16, seed=1)
    assert img.max() > 5.0           # light visible (emit 15)
    assert 0.02 < img.mean() < 1.0   # overall energy plausible
    assert np.isfinite(img).all()
