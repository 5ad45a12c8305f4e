"""Inverse-rendering end-to-end: gradient descent through the renderer
recovers perturbed scene parameters (tools/optimize_scene.py — north-star
differentiability surface; the reference has no gradients)."""

import json
import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from raytrace2.scene import loader, schema  # noqa: E402
from tools import optimize_scene as opt  # noqa: E402


def _scene(tmp_path):
    j = {
        "background_color": [0.7, 0.8, 1.0],
        "camera": {"fov": 40, "center": [0, 2, 6], "look_at": [0, 1, 0]},
        "materials": [{"type": "lambertian", "albedo": [0.8, 0.3, 0.3]},
                      {"type": "lambertian", "albedo": [0.3, 0.8, 0.3]}],
        "primitives": [
            {"type": "quad", "q": [-10, 0, -10], "u": [20, 0, 0],
             "v": [0, 0, 20], "material": 0},
            {"type": "sphere", "center": [0, 1, 0], "radius": 1.0,
             "material": 1},
        ],
    }
    p = tmp_path / "opt_scene.json"
    p.write_text(json.dumps(j))
    scene_host, _ = loader.load_scene(str(p))
    return schema.to_device(scene_host), tuple(
        sorted(scene_host.features().items()))


def test_albedo_recovery(tmp_path):
    scene, features = _scene(tmp_path)
    kw = dict(width=32, height=32, n_samples=2, max_depth=4, sqrt_spp=1)
    _, recs = opt.optimize(
        scene, features, ["materials.albedo"], steps=15, lr=5e-2,
        render_kw=kw, log=lambda s: None)
    first, last = recs[0], recs[-1]
    assert last["loss"] < first["loss"] / 4, (first, last)
    assert last["rel_err[materials.albedo]"] < first[
        "rel_err[materials.albedo]"] / 2, (first, last)


def test_cli_surface(tmp_path, capsys):
    scene, _ = _scene(tmp_path)  # writes the scene file
    rc = opt.main([str(tmp_path / "opt_scene.json"),
                   "--leaves", "background",
                   "--steps", "8", "--width", "24", "--height", "24",
                   "--samples", "1", "--depth", "3", "--lr", "0.05"])
    assert rc == 0
    lines = [json.loads(ln) for ln in
             capsys.readouterr().out.strip().splitlines()]
    assert lines[-1]["event"] == "done"
    assert lines[-1]["improvement"] > 1.5
