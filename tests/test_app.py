"""End-to-end CLI tests (App::Run parity, src/App.cpp:81-249)."""

import json
import os
import subprocess
import sys

import numpy as np
import pytest

from raytrace2.app import load_app_settings, main
from raytrace2.io import image


def _scene_json():
    return {
        "background_color": [0.7, 0.8, 1.0],
        "camera": {"fov": 60, "center": [0, 1, 3], "look_at": [0, 0, 0],
                   "width": 32, "aspect_ratio": 2.0},
        "materials": [{"type": "lambertian", "albedo": [0.5, 0.5, 0.5]}],
        "primitives": [{"type": "sphere", "center": [0, 0, 0], "radius": 1.0, "material": 0}],
    }


def test_settings_defaults(tmp_path):
    s = load_app_settings(str(tmp_path / "missing.json"))
    assert s == {
        "num_samples": 1, "render_once": False, "save_after_render_once": False,
        "max_depth": 50, "render_window": True,
    }
    p = tmp_path / "settings.json"
    p.write_text(json.dumps({"num_samples": 7, "max_depth": 3}))
    s = load_app_settings(str(p))
    assert s["num_samples"] == 7 and s["max_depth"] == 3


def test_cli_renders_png(tmp_path):
    scene = tmp_path / "scene.json"
    scene.write_text(json.dumps(_scene_json()))
    out = tmp_path / "out.png"
    rc = main([str(scene), str(out), "--samples", "2", "--depth", "4", "--quiet"])
    assert rc == 0
    dec = image.decode_png(out.read_bytes())
    assert dec.shape == (16, 32, 3)  # width 32, aspect 2 → height 16
    assert dec.mean() > 10  # sky-lit scene isn't black


def test_cli_scene_dims_and_default_output(tmp_path):
    scene = tmp_path / "scene.json"
    scene.write_text(json.dumps(_scene_json()))
    rc = main([str(scene), "--samples", "1", "--depth", "2", "--quiet",
               "--root", str(tmp_path)])
    assert rc == 0
    outs = os.listdir(tmp_path / "local" / "output")
    assert len(outs) == 1 and outs[0].startswith("scene_")


def test_cli_missing_scene_fails(tmp_path):
    rc = main([str(tmp_path / "nope.json"), "--quiet"])
    assert rc == 1


def test_cli_checkpoint_resume(tmp_path):
    scene = tmp_path / "scene.json"
    scene.write_text(json.dumps(_scene_json()))
    ck = tmp_path / "state.npz"
    out1 = tmp_path / "a.png"
    # NOTE: stratification (sqrt_spp) is derived from num_samples exactly as
    # the reference derives it from the camera's samples_per_pixel
    # (Camera.hpp:45), so a resume reproduces the one-shot render only when
    # int(sqrt(total)) matches across runs: 4 → 2 and 8 → 2 here.
    rc = main([str(scene), str(out1), "--samples", "4", "--depth", "3",
               "--checkpoint", str(ck), "--quiet"])
    assert rc == 0 and ck.exists()
    # Resume: 4 more samples on top of the checkpointed 4.
    out2 = tmp_path / "b.png"
    rc = main([str(scene), str(out2), "--samples", "8", "--depth", "3",
               "--checkpoint", str(ck), "--quiet"])
    assert rc == 0
    # One-shot 8-sample render must match the resumed one exactly.
    out3 = tmp_path / "c.png"
    rc = main([str(scene), str(out3), "--samples", "8", "--depth", "3", "--quiet"])
    assert rc == 0
    np.testing.assert_array_equal(
        image.decode_png(out2.read_bytes()), image.decode_png(out3.read_bytes())
    )


def test_module_invocation(tmp_path):
    scene = tmp_path / "scene.json"
    scene.write_text(json.dumps(_scene_json()))
    out = tmp_path / "out.png"
    env = dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH=os.path.dirname(
        os.path.dirname(os.path.abspath(__file__))))
    r = subprocess.run(
        [sys.executable, "-m", "raytrace2", str(scene), str(out),
         "--samples", "1", "--depth", "2"],
        capture_output=True, text=True, env=env, timeout=300,
    )
    assert r.returncode == 0, r.stderr
    assert "Num Samples: 1" in r.stdout
    assert out.exists()


def test_cli_watch_reloads_scene(tmp_path):
    """--watch: editing the scene file mid-render reloads it and restarts
    accumulation (the headless analog of the reference's load-scene panel,
    src/App.cpp:210-229). The background flips dark->bright mid-run; the
    final image must show the NEW background, and the reload must be
    logged."""
    scene = tmp_path / "scene.json"
    obj = _scene_json()
    obj["background_color"] = [0.01, 0.01, 0.01]
    scene.write_text(json.dumps(obj))
    out = tmp_path / "out.png"

    # Rewrite the scene from INSIDE the render loop (after the 4th batch)
    # so the test is deterministic regardless of jit-compile timing — a
    # wall-clock thread races a warm-cache render that finishes in <2 s.
    from raytrace2.render import Renderer

    calls = {"n": 0}
    orig_update = Renderer.update

    def update_and_rewrite(self, n):
        calls["n"] += 1
        if calls["n"] == 4:
            obj["background_color"] = [0.9, 0.9, 0.9]
            scene.write_text(json.dumps(obj))
        return orig_update(self, n)

    import contextlib
    import io as _io
    from unittest import mock

    buf = _io.StringIO()
    with contextlib.redirect_stdout(buf), mock.patch.object(
            Renderer, "update", update_and_rewrite):
        rc = main([str(scene), str(out), "--samples", "48", "--depth", "3",
                   "--batch", "1", "--watch"])
    assert rc == 0
    assert calls["n"] >= 5, calls  # reload happened mid-run, then continued
    log_text = buf.getvalue()
    assert "Scene reloaded" in log_text, log_text[-500:]
    dec = image.decode_png(out.read_bytes())
    # Bright sky after reload: mean far above the dark original's ~0-20.
    assert dec.mean() > 60, dec.mean()


def test_cli_metrics_jsonl(tmp_path):
    """--metrics: one structured JSON record per dispatch plus a final
    summary (SURVEY §5 metrics/observability — the reference's only perf
    surface is the window-title FPS average, App.cpp:182-191)."""
    scene = tmp_path / "scene.json"
    scene.write_text(json.dumps(_scene_json()))
    out = tmp_path / "out.png"
    metrics = tmp_path / "metrics.jsonl"
    rc = main([str(scene), str(out), "--samples", "4", "--depth", "2",
               "--batch", "2", "--quiet", "--metrics", str(metrics)])
    assert rc == 0
    recs = [json.loads(ln) for ln in metrics.read_text().splitlines()]
    dispatches = [r for r in recs if r["event"] == "dispatch"]
    assert [r["sample"] for r in dispatches] == [2, 4]
    assert all(r["total"] == 4 and r["mpaths_per_s"] >= 0 for r in dispatches)
    done = recs[-1]
    assert done["event"] == "done" and done["samples"] == 4
    assert done["output"] == str(out)


def test_cli_backend_flag(tmp_path):
    """--backend forces the render path through the real CLI: xla and bvh
    trace the same threefry streams (the BVH only changes how spheres are
    swept), and mega runs the megakernel — interpreted on the CPU — on its
    own counter-hash streams (same scene, other draw). A backend outside
    auto|xla|bvh|mega is refused."""
    scene = tmp_path / "scene.json"
    scene.write_text(json.dumps(_scene_json()))
    outs = {}
    for backend in ("xla", "bvh", "mega"):
        out = tmp_path / f"out_{backend}.png"
        rc = main([str(scene), str(out), "--samples", "2", "--depth", "4",
                   "--quiet", "--backend", backend])
        assert rc == 0
        outs[backend] = image.decode_png(out.read_bytes()).astype(np.int32)
    assert np.abs(outs["bvh"] - outs["xla"]).max() <= 1
    assert abs(float(outs["mega"].mean()) - float(outs["xla"].mean())) < 20.0
    assert outs["mega"].mean() > 10
    with pytest.raises(SystemExit):
        main([str(scene), "--backend", "wavefront"])
    # A noise texture is outside the kernel's scope: forcing it is refused.
    noisy = dict(_scene_json(), textures=[
        {"type": "noise", "scale": 2.0, "noise_type": 1, "albedo": [1, 1, 1]}])
    noisy["materials"] = [{"type": "texture", "tex_idx": 0}] + noisy["materials"][1:]
    scene.write_text(json.dumps(noisy))
    assert main([str(scene), str(tmp_path / "n.png"), "--samples", "1",
                 "--quiet", "--backend", "mega"]) == 1


def test_key_controls_inactive_off_tty():
    """Piped/CI stdin: the key poller must stay inert."""
    from raytrace2 import app as app_mod

    kc = app_mod._KeyControls(enabled=True)
    assert not kc.active
    assert kc.poll() == ""
    kc.close()  # no-op


def test_cli_key_quit_and_snapshot(tmp_path, monkeypatch):
    """'w' writes a snapshot mid-render, 'q' ends the run early but still
    writes the final image — the headless ImGui-panel analog
    (App.cpp:210-229)."""
    from raytrace2 import app as app_mod

    scene = tmp_path / "scene.json"
    scene.write_text(json.dumps(_scene_json()))
    out = tmp_path / "out.png"
    presses = iter(["", "wc", "q"])

    class FakeKeys:
        def __init__(self, enabled):
            self.active = True

        def poll(self):
            return next(presses, "q")

        def close(self):
            pass

    monkeypatch.setattr(app_mod, "_KeyControls", FakeKeys)
    rc = app_mod.main([str(scene), str(out), "--samples", "64", "--depth",
                       "3", "--batch", "1", "--watch", "--quiet"])
    assert rc == 0
    assert out.exists()
    assert os.path.exists(str(out) + ".camera.json")
    img = image.decode_png(open(str(out), "rb").read())
    assert img.shape[0] > 0
