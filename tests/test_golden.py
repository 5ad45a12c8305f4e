"""Golden-image gates. The fast CPU tier compares the two render paths on
the same random streams (the megakernel, interpreted, against the XLA
bounce loop with rng_impl="murmur"): identical paths, so any difference is
arithmetic. The float64 oracle of the XLA path is tests/test_double.py."""

import os

import numpy as np
import pytest

from raytrace2.io import compare
from raytrace2.scene import loader

CORNELL = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "data", "cornell_box_original.json")


def test_psnr_utility():
    a = np.zeros((8, 8, 3))
    assert compare.psnr(a, a) == float("inf")
    b = a + 0.1
    assert abs(compare.psnr(a, b) - 20.0) < 1e-6


def test_write_camera_roundtrip(tmp_path):
    scene, _ = loader.load_scene(CORNELL)
    p = tmp_path / "cam.json"
    loader.write_camera(scene.camera, str(p))
    import json

    obj = json.loads(p.read_text())
    assert obj["fov"] == 40.0
    assert obj["center"] == [278.0, 278.0, -800.0]


@pytest.mark.kernel
def test_cross_backend_matched_rng_psnr():
    """Megakernel (interpreted) vs XLA bounce loop on the SAME murmur RNG
    streams: identical paths, so the PSNR measures f32 arithmetic
    divergence only — >= 45 dB at 4 spp (every path agrees on the CPU; the
    same comparison at 600x600, depth 50 on the card is chip_smoke.py's
    kernel_vs_xla phase)."""
    import jax.numpy as jnp

    from raytrace2.ops import integrator
    from raytrace2.scene import schema

    scene_host, _ = loader.load_scene(CORNELL)
    scene = schema.to_device(scene_host)
    W = H = 48
    SPP, DEPTH, SQRT = 4, 8, 2
    feat = scene_host.features()
    f_mega = dict(feat, use_megakernel=True, mega_interpret=True)
    f_xla = dict(feat, use_megakernel=False, rng_impl="murmur")

    def run(features):
        return np.asarray(integrator.render_progressive(
            scene, dict(features), W, H, jnp.int32(0), jnp.int32(SPP), 0,
            DEPTH, SQRT)) / SPP

    im_m, im_x = run(f_mega), run(f_xla)
    assert abs(im_m.mean() - im_x.mean()) < 1e-3
    p = compare.psnr(im_m.astype(np.float64), im_x.astype(np.float64))
    assert p > 45.0, f"matched-RNG cross-backend PSNR {p:.1f} dB"
