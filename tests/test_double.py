"""RAYTRACE2_DOUBLE=1 — the reference's ``#define DOUBLE`` analog
(src/Defs.hpp:4-7): REAL=float64 + jax x64, a CPU-side verification mode.
The oracle check: the f32 production arithmetic must agree with the f64
ground truth of the SAME estimator (identical threefry streams) to far
below MC noise. Runs in subprocesses because the dtype is bound at
import time, exactly like the reference's compile-time #define."""

import json
import os
import subprocess
import sys

import numpy as np
import pytest

_WORKER = """
import sys, numpy as np
from raytrace2.scene import loader, schema
from raytrace2.ops import integrator
from raytrace2 import defs
import jax.numpy as jnp

scene, dims = loader.load_scene(sys.argv[1])
feat = scene.features()
scene = schema.to_device(scene)
r = integrator.render_progressive(
    scene, feat, 32, 24, jnp.int32(0), jnp.int32(4), 0, 6, 2)
out = np.asarray(r, np.float64)
assert out.dtype == np.float64
np.save(sys.argv[2], out)
print("REAL", defs.REAL.__name__)
"""


def test_f32_matches_f64_oracle(tmp_path, data_dir):
    outs = {}
    for double in ("0", "1"):
        env = dict(
            os.environ, RAYTRACE2_DOUBLE=double, JAX_PLATFORMS="cpu",
            PYTHONPATH=os.path.dirname(os.path.dirname(
                os.path.abspath(__file__))),
        )
        out_npy = str(tmp_path / f"r{double}.npy")
        p = subprocess.run(
            [sys.executable, "-c", _WORKER,
             f"{data_dir}/cornell_box_original.json", out_npy],
            capture_output=True, text=True, env=env, timeout=600,
        )
        assert p.returncode == 0, p.stderr[-2000:]
        assert ("REAL float64" if double == "1" else "REAL float32") in p.stdout
        outs[double] = np.load(out_npy)

    diff = np.abs(outs["0"] - outs["1"])
    scale = float(np.abs(outs["1"]).max())
    # Identical streams, but a handful of rays sit on DISCRETE decision
    # boundaries (Schlick coin, closest-hit ties) where the f32/f64 chains
    # legitimately diverge O(1) — a per-pixel max gate would only measure
    # those. Gate the continuous agreement distributionally instead: the
    # overwhelming majority of pixels must match to f32-rounding levels.
    # Measured depth scaling (flip fraction): 0.4% @ depth 1 → 8% @ depth
    # 6 — smooth chaotic growth, median exactly 0. A systematic f32 defect
    # (cancellation, a wrong epsilon) would blow the continuous statistics
    # instead: gate those.
    flipped = diff > 1e-3 * scale
    assert float(flipped.mean()) < 0.15, float(flipped.mean())
    p99 = float(np.quantile(diff[~flipped], 0.99)) / max(scale, 1e-12)
    assert p99 < 2e-4, p99
    assert float(np.median(diff)) < 1e-6 * scale
