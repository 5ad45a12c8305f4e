"""Benchmark: Cornell box progressive throughput on one GPU.

Workload: the reference's headline workload shape — Cornell box at
600x600, max_depth 50, stratified progressive sampling (a 10,000-sample
run, so sqrt_spp 100), 64 samples per dispatch. The scene is
data/cornell_box_original.json, which tools/make_scene.py builds with its
canned Cornell light (330x305, intensity 7). That is make_scene's variant,
not the reference's data fixture, which renders about 3.4x darker (mean
radiance ~0.16 against ~0.537): paths/s here is not comparable with runs
on that fixture. The render takes
the route ``Renderer`` picks (render.route): the Pallas megakernel where it
supports the scene on a GPU, the XLA bounce loop otherwise. The timed
window is the 64 dispatches (4,096 samples) after the first, which fit in
the 10,000-sample run.

``--grad``: instead time value_and_grad of the mean image through the
differentiable render (the XLA ``scan`` bounce loop) at depth 50 with
``--grad-samples`` samples per step, timed over the 2 steps after the
first; metric "cornell600_fwdbwd_d50_paths_per_sec".

Prints the device (JAX platform, device kind, device count) and the card's
name and power limit, then ONE JSON line with the metric. Exits non-zero,
printing no metric, where JAX finds no GPU. One process, one card:

    python bench.py
    python bench.py --grad
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

REPO = os.path.dirname(os.path.abspath(__file__))
SCENE = os.path.join(REPO, "data", "cornell_box_original.json")
DEPTH = 50
TOTAL_SAMPLES = 10000
SAMPLES_PER_DISPATCH = 64
TIMED_DISPATCHES = 64
TIMED_GRAD_STEPS = 2


def _log(msg: str) -> None:
    """Progress on stderr; stdout carries the device lines and the result."""
    print(f"# bench {time.strftime('%H:%M:%S')} {msg}", file=sys.stderr,
          flush=True)


def _timed(step, reps: int) -> float:
    """Seconds for ``reps`` calls of ``step`` (which blocks until the device
    is done)."""
    t0 = time.perf_counter()
    for _ in range(reps):
        step()
    return time.perf_counter() - t0


def bench_forward(scene_host, width, height):
    from raytrace2.render import Renderer

    r = Renderer(scene_host, width, height, num_samples=TOTAL_SAMPLES,
                 max_depth=DEPTH, backend="auto")
    route = "mega" if dict(r._features)["use_megakernel"] else "xla"
    spd = SAMPLES_PER_DISPATCH

    def step():
        r.update(spd)
        r.state.accum.block_until_ready()

    _log(f"route {route}: compiling")
    t0 = time.perf_counter()
    step()
    compile_s = time.perf_counter() - t0
    reps = TIMED_DISPATCHES
    dt = _timed(step, reps)
    mean = float(r.linear_pixels().mean())
    if not 0.0 < mean < 100.0:
        raise RuntimeError(f"implausible mean radiance {mean}")
    return {"metric": "cornell600_paths_per_sec",
            "value": reps * spd * width * height / dt, "unit": "paths/s",
            "route": route, "samples_per_dispatch": spd,
            "first_dispatch_s": compile_s, "timed_dispatches": reps,
            "mean_radiance": mean}


def bench_grad(scene_host, width, height, n_samples):
    import jax
    import jax.numpy as jnp

    from raytrace2 import grad as grad_mod
    from raytrace2.scene import schema

    features = tuple(sorted(scene_host.features().items()))
    scene = schema.to_device(scene_host)

    @jax.jit
    def run(scene):
        return grad_mod.value_and_grad_scene(
            jnp.mean, scene, features, 0, width=width, height=height,
            n_samples=n_samples, max_depth=DEPTH,
            sqrt_spp=max(int(n_samples ** 0.5), 1))

    def step():
        val, g = run(scene)
        jax.block_until_ready(g)
        if not (0.0 < float(val) < 100.0
                and bool(jnp.isfinite(g.materials.albedo).all())):
            raise RuntimeError(f"implausible loss {float(val)} or gradient")

    _log("grad: compiling")
    t0 = time.perf_counter()
    step()
    compile_s = time.perf_counter() - t0
    reps = TIMED_GRAD_STEPS
    dt = _timed(step, reps)
    return {"metric": f"cornell600_fwdbwd_d{DEPTH}_paths_per_sec",
            "value": reps * n_samples * width * height / dt,
            "unit": "paths/s", "route": "xla-scan",
            "samples_per_step": n_samples, "first_step_s": compile_s,
            "timed_steps": reps}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--grad", action="store_true",
                   help="time forward+backward instead of the forward render")
    p.add_argument("--grad-samples", type=int, default=48,
                   help="samples per gradient step; every sample's "
                        "residuals stay live until the backward pass, and 48 "
                        "(~55 GB at 600x600, depth 50) is the most that fits "
                        "in the 60 GB a JAX process takes of an 80 GB H100")
    args = p.parse_args(argv)

    from raytrace2.scene import loader
    from raytrace2.utils import device, enable_compilation_cache

    try:
        dev = device.require_gpu()
    except device.NoGpuError as e:
        print(f"bench: {e}", file=sys.stderr)
        return 2
    info = device.describe(dev)
    card = device.card_line()
    print(f"device: {json.dumps(info)}")
    print(f"card: {card}")
    enable_compilation_cache()

    scene_host, dims = loader.load_scene(SCENE)
    width, height = dims
    if args.grad:
        res = bench_grad(scene_host, width, height, args.grad_samples)
    else:
        res = bench_forward(scene_host, width, height)
    res.update(peak_bytes_in_use=device.peak_bytes(dev), device=info,
               card=card)
    print(json.dumps(res))
    return 0


if __name__ == "__main__":
    sys.exit(main())
