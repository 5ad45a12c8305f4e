"""Scene-authoring tool tests: generated JSON loads and matches the
reference corpus structurally (make_scene.py parity)."""

import json
import os
import subprocess
import sys

import numpy as np
import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(REPO, "tools"))

import make_scene  # noqa: E402

from raytrace2.scene import loader  # noqa: E402


def test_cornell_original_structure(tmp_path):
    """Generator output loads and flattens to the expected Cornell geometry.
    (Note: the reference's shipped data fixture uses a smaller light than its
    own make_scene constructor — geometry equality with the fixture is not
    expected; make_scene.py:257-261 is the spec here.)"""
    scene_file = tmp_path / "c.json"
    make_scene.cornell_box_original().write_json(str(scene_file))
    ours, _ = loader.load_scene(str(scene_file))
    active = np.asarray(ours.quads.active)
    assert active.sum() == 6 + 12  # 6 walls incl. light + 2 boxes × 6
    # Light quad present at y=554 with the constructor's corner.
    q = np.asarray(ours.quads.q)[active]
    assert any(np.allclose(row, [113, 554, 127]) for row in q)
    # Rotated boxes baked: some quad normals are off-axis.
    n = np.asarray(ours.quads.normal)[active]
    offaxis = np.sum(np.isclose(np.abs(n), 1.0, atol=1e-4).sum(-1) == 0)
    assert offaxis >= 8  # 4 side faces per rotated box


def test_volume_scene_has_media(tmp_path):
    scene_file = tmp_path / "v.json"
    make_scene.cornell_box_volume().write_json(str(scene_file))
    scene, _ = loader.load_scene(str(scene_file))
    assert scene.features()["has_media"]
    assert int(np.asarray(scene.media.active).sum()) == 2


def test_book2_final_structure(tmp_path):
    scene_file = tmp_path / "b.json"
    make_scene.book2_final(rng_seed=1).write_json(str(scene_file))
    scene, _ = loader.load_scene(str(scene_file))
    # 400 floor boxes ×6 quads + light quad; 1000-cluster + 4 plain spheres
    # + 1 moving + noise sphere; 2 media (boundary fog + glass-ball mist).
    assert scene.quads.count >= 2401
    assert scene.spheres.count >= 1006
    assert int(np.asarray(scene.media.active).sum()) == 2
    assert scene.features()["has_noise"]


def test_cli_writes_scene_and_settings(tmp_path):
    r = subprocess.run(
        [sys.executable, os.path.join(REPO, "tools", "make_scene.py"), "--scene",
         "cornell_original", "--root", str(tmp_path), "--no-run"],
        capture_output=True, text=True, timeout=120,
    )
    assert r.returncode == 0, r.stderr
    settings = json.loads((tmp_path / "local/data/settings.json").read_text())
    assert settings["num_samples"] == 10 and settings["max_depth"] == 50
    scene = json.loads((tmp_path / "local/data/cornell_original.json").read_text())
    assert len(scene["primitives"]) == 8


def test_book1_final_structure(tmp_path):
    scene_file = tmp_path / "b1.json"
    make_scene.book1_final(rng_seed=0).write_json(str(scene_file))
    scene, dims = loader.load_scene(str(scene_file))
    assert dims == (1200, 675)
    n = int(np.asarray(scene.spheres.active).sum())
    assert 450 < n < 490  # 22x22 small spheres, minus the clearing, + 4
    assert np.any(np.asarray(scene.spheres.displacement) != 0)  # motion blur
    assert float(scene.camera.defocus_angle) > 0                 # depth of field


@pytest.mark.parametrize("name", sorted(make_scene.DATA_SCENES))
def test_committed_scene_regenerates_byte_for_byte(name, tmp_path):
    """data/<name> is what `make_scene.py --no-run --out` writes."""
    canned, seed = make_scene.DATA_SCENES[name]
    out = tmp_path / name
    args = ["--scene", canned, "--root", str(tmp_path), "--out", str(out),
            "--no-run"]
    if seed is not None:
        args += ["--seed", str(seed)]
    assert make_scene.main(args) == 0
    with open(os.path.join(REPO, "data", name), "rb") as f:
        assert out.read_bytes() == f.read()
