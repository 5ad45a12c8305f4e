"""The render router (render.route): which path each scene takes on each
platform, decided by a property of the scene."""

import json

import pytest

from raytrace2 import render as render_mod
from raytrace2.ops.pallas import megakernel as mk
from raytrace2.scene import loader


def _features(data_dir, name):
    scene, _ = loader.load_scene(f"{data_dir}/{name}")
    return scene.features()


@pytest.mark.parametrize("name,gpu_route", [
    ("cornell_box_original.json", "mega"),
    ("cornell_box_volume.json", "mega"),
    ("checkered_spheres.json", "mega"),
    ("book1_final.json", "mega"),
    ("book2_final_scene_10000_samples.json", "xla"),   # noise textures
])
def test_auto_route_per_scene(data_dir, name, gpu_route):
    feat = _features(data_dir, name)
    assert render_mod.route(feat, "auto", "gpu") == gpu_route
    assert render_mod.route(feat, "auto", "cpu") == "xla"


@pytest.mark.parametrize("backend", ["xla", "bvh"])
def test_forced_xla_routes(data_dir, backend):
    feat = _features(data_dir, "cornell_box_original.json")
    assert render_mod.route(feat, backend, "gpu") == "xla"


def test_forced_mega_on_cpu_is_kernel(data_dir):
    feat = _features(data_dir, "cornell_box_original.json")
    assert render_mod.route(feat, "mega", "cpu") == "mega"


def test_forced_mega_refuses_unsupported_scene(data_dir):
    feat = _features(data_dir, "book2_final_scene_10000_samples.json")
    with pytest.raises(ValueError, match="cannot render"):
        render_mod.route(feat, "mega", "gpu")


def test_unknown_backend_refused(data_dir):
    feat = _features(data_dir, "cornell_box_original.json")
    for old in ("pallas", "wavefront"):
        with pytest.raises(ValueError, match="unknown backend"):
            render_mod.route(feat, old, "gpu")


def test_ellipsoids_route_to_xla(tmp_path):
    j = {
        "camera": {"fov": 50, "center": [0, 1, 6], "look_at": [0, 0.5, 0]},
        "materials": [{"type": "lambertian", "albedo": [0.7, 0.3, 0.3]}],
        "primitives": [{"type": "sphere", "center": [0, 0.5, 0],
                        "radius": 1.0, "material": 0}],
        "scene": [{"primitive": 0,
                   "transform": {"scale": [1.0, 2.0, 0.5]}}],
    }
    p = tmp_path / "ell.json"
    p.write_text(json.dumps(j))
    scene, _ = loader.load_scene(str(p))
    assert render_mod.route(scene.features(), "auto", "gpu") == "xla"


def test_record_limit(data_dir):
    feat = _features(data_dir, "cornell_box_original.json")
    n_sph, n_quad, n_mat, n_tex, n_med, n_box = feat["mega_sizes"]
    over = dict(feat, mega_sizes=(mk.MAX_RECORDS - n_quad + 1, n_quad,
                                  n_mat, n_tex, n_med, n_box))
    assert mk.n_records(over["mega_sizes"]) == mk.MAX_RECORDS + 1
    assert render_mod.route(over, "auto", "gpu") == "xla"
    at = dict(feat, mega_sizes=(mk.MAX_RECORDS - n_quad, n_quad,
                                n_mat, n_tex, n_med, n_box))
    assert render_mod.route(at, "auto", "gpu") == "mega"
