#!/usr/bin/env python
"""Smoke run of the renderer's main path on one GPU.

    python chip_smoke.py           # one card: phases 1-6
    python chip_smoke.py --four    # four cards: the sharded paths only

Phases (each prints one line: its numbers, then the card's name and power
limit; any failure raises and exits non-zero before the last line):

1. device — JAX must find a GPU; prints device_kind and the nvidia-smi
   name and power limit.
2. cli_forward — the CLI (app.main, in this process) renders
   data/cornell_box_original.json at 600x600, depth 50, 64 samples
   (sqrt_spp 8) in two dispatches; compile time, Mpaths/s, peak device
   bytes, and the mean linear radiance against its known value.
3. corpus — Cornell volume (16 spp) and book 2 (4 spp) at 600x600, depth
   50, through Renderer(backend="auto"); prints the route each took.
4. kernel_vs_xla — the Triton megakernel against the XLA bounce loop on
   the same murmur RNG streams: Cornell 600x600, depth 50, 16 spp; PSNR and
   mean agreement, both timings and the speedup.
5. gpu_vs_cpu — a 64x64, depth-8, 4-spp XLA render with identical
   threefry keys on the CPU (in a CPU-only child process) and on the GPU
   must agree (a dot running in TF32 would not).
6. grad — value_and_grad of the mean image at 600x600, depth 50, one
   sample: finite, non-zero albedo gradient, step time and peak bytes; and
   AD against a central finite difference on the light's emission at
   64x64, depth 8.

``--four`` (four cards) runs instead: the sharded XLA render at meshes
(sp, dp) = (1, 4) and (2, 2), the sharded gradient, and the sharded
megakernel render, each against a one-card run of the same pixels and
samples, on Cornell 600x600, depth 50.

The last line of stdout is one JSON object:
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.
Outputs (image, metrics, accumulator) go to local/chip_smoke/.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

REPO = os.path.dirname(os.path.abspath(__file__))
OUT = os.path.join(REPO, "local", "chip_smoke")
W = H = 600
DEPTH = 50
# Mean linear radiance of data/cornell_box_original.json at 600x600, 64
# samples (sqrt_spp 8), depth 50, seed 0: the CLI run's telltale. The scene
# is tools/make_scene.py's Cornell variant, not the reference's data fixture
# (about 3.4x darker, mean 0.159-0.160 at these settings). Measured
# 0.53680 on an H100 (megakernel route); the XLA route at 150x150 on the CPU
# gives 0.53698. The band is +-0.3% (Monte-Carlo noise of the mean at
# 23 M paths is ~0.06%); a precision regression moves it by percents.
CORNELL_MEAN = (0.535, 0.538)
PSNR_MIN_DB = 40.0
MEAN_REL_MAX = 1e-3
RTOL, ATOL = 2e-4, 2e-5      # one-card vs CPU / sharded vs one-card
FD_TOL = 5e-3                # tests/test_grad.py, materials.albedo


class SmokeError(AssertionError):
    """A phase's result is wrong."""


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise SmokeError(msg)


def report(phase: str, card: str, **numbers) -> None:
    print(f"[{phase}] {json.dumps(numbers)} | card: {card}", flush=True)


def psnr(a, b) -> float:
    import numpy as np

    mse = float(np.mean((np.asarray(a, np.float64) - np.asarray(b, np.float64)) ** 2))
    return float("inf") if mse == 0.0 else 10.0 * np.log10(1.0 / mse)


def timed(fn):
    """(result, seconds) of ``fn()``, blocking on the result."""
    import jax

    t0 = time.perf_counter()
    out = jax.block_until_ready(fn())
    return out, time.perf_counter() - t0


def cornell():
    from raytrace2.scene import loader

    scene, _ = loader.load_scene(
        os.path.join(REPO, "data", "cornell_box_original.json"))
    return scene


def phase_cli(card):
    from raytrace2 import app
    from raytrace2.io import checkpoint

    metrics = os.path.join(OUT, "cornell_metrics.jsonl")
    ckpt = os.path.join(OUT, "cornell_state.npz")
    for path in (metrics, ckpt):
        if os.path.exists(path):
            os.remove(path)
    rc = app.main([
        os.path.join(REPO, "data", "cornell_box_original.json"),
        os.path.join(OUT, "cornell.png"), "--root", OUT,
        "--width", str(W), "--height", str(H),
        "--samples", "64", "--depth", str(DEPTH), "--batch", "32",
        "--metrics", metrics, "--checkpoint", ckpt, "--quiet",
    ])
    check(rc == 0, f"CLI exited {rc}")
    with open(metrics) as f:
        recs = [json.loads(line) for line in f]
    disp = [r for r in recs if r["event"] == "dispatch"]
    done = recs[-1]
    check(len(disp) == 2 and done["event"] == "done", f"metrics: {recs}")
    steady = disp[1]["elapsed_s"] - disp[0]["elapsed_s"]
    state = checkpoint.load_state(ckpt)
    mean = float(state.accum.mean()) / int(state.frame_idx)
    report("cli_forward", card, compile_s=disp[0]["elapsed_s"] - steady,
           mpaths_per_s=32 * W * H / steady / 1e6,
           peak_bytes_in_use=done.get("device_peak_bytes"),
           mean_linear_radiance=mean, expected=CORNELL_MEAN)
    check(CORNELL_MEAN[0] <= mean <= CORNELL_MEAN[1],
          f"mean linear radiance {mean} outside {CORNELL_MEAN}")


def phase_corpus(card):
    import numpy as np

    from raytrace2.render import Renderer
    from raytrace2.scene import loader

    for name, spp in (("cornell_box_volume.json", 16),
                      ("book2_final_scene_10000_samples.json", 4)):
        scene, _ = loader.load_scene(os.path.join(REPO, "data", name))
        r = Renderer(scene, W, H, num_samples=spp, max_depth=DEPTH,
                     backend="auto")
        route = "mega" if dict(r._features)["use_megakernel"] else "xla"
        img, secs = timed(lambda: r.render(batch=spp))
        check(img.shape == (H, W, 3) and bool(np.isfinite(img).all()),
              f"{name}: bad image")
        check(0.0 < float(img.mean()) < 100.0, f"{name}: mean {img.mean()}")
        report("corpus", card, scene=name, route=route, spp=spp,
               seconds_incl_compile=secs, mean=float(img.mean()))


def phase_kernel_vs_xla(card):
    import jax
    import jax.numpy as jnp
    import numpy as np

    from raytrace2.ops import integrator
    from raytrace2.scene import schema

    host = cornell()
    scene = schema.to_device(host)
    feat = host.features()
    spp, sqrt_spp = 16, 4
    runs = {}
    for name, f in (("mega", dict(feat, use_megakernel=True)),
                    ("xla", dict(feat, use_megakernel=False,
                                 rng_impl="murmur"))):
        fn = jax.jit(lambda s, f=f: integrator.render_progressive(
            s, f, W, H, jnp.int32(0), jnp.int32(spp), 0, DEPTH, sqrt_spp))
        _, first = timed(lambda: fn(scene))
        img, secs = timed(lambda: fn(scene))
        runs[name] = (np.asarray(img) / spp, first, secs)
    a, b = runs["mega"][0], runs["xla"][0]
    p = psnr(a, b)
    rel = abs(float(a.mean()) - float(b.mean())) / float(b.mean())
    report("kernel_vs_xla", card, psnr_db=p, mean_rel_diff=rel,
           mega_s=runs["mega"][2], xla_s=runs["xla"][2],
           mega_first_s=runs["mega"][1], xla_first_s=runs["xla"][1],
           speedup=runs["xla"][2] / runs["mega"][2],
           mega_mpaths_per_s=spp * W * H / runs["mega"][2] / 1e6,
           xla_mpaths_per_s=spp * W * H / runs["xla"][2] / 1e6)
    check(p >= PSNR_MIN_DB, f"kernel vs XLA PSNR {p:.2f} dB < {PSNR_MIN_DB}")
    check(rel <= MEAN_REL_MAX, f"kernel vs XLA mean differs by {rel:.2e}")


def small_render():
    """Cornell 64x64, depth 8, 4 spp on the XLA path with threefry keys, on
    JAX's default device: [64, 64, 3] radiance sum."""
    import jax
    import jax.numpy as jnp
    import numpy as np

    from raytrace2.ops import integrator
    from raytrace2.scene import schema

    host = cornell()
    feat = host.features()
    fn = jax.jit(lambda s: integrator.render_progressive(
        s, feat, 64, 64, jnp.int32(0), jnp.int32(4), 0, 8, 2))
    return np.asarray(fn(schema.to_device(host)))


def phase_gpu_vs_cpu(card):
    """The CPU side runs in a child process held to the CPU and given no
    persistent compile cache: a CPU executable cached on one host embeds
    that host's instruction set, and another host may not have it."""
    import subprocess

    import numpy as np

    path = os.path.join(OUT, "cpu_render.npy")
    env = {k: v for k, v in os.environ.items()
           if k != "JAX_COMPILATION_CACHE_DIR"}
    env["JAX_PLATFORMS"] = "cpu"
    subprocess.run(
        [sys.executable, "-c",
         f"import numpy, chip_smoke; numpy.save({path!r}, chip_smoke.small_render())"],
        cwd=REPO, env=env, check=True, timeout=600)
    cpu = np.load(path)
    gpu = small_render()
    diff = np.abs(gpu - cpu)
    report("gpu_vs_cpu", card, max_abs_diff=float(diff.max()),
           frac_px_over_tol=float(
               (diff > ATOL + RTOL * np.abs(cpu)).any(-1).mean()),
           mean_cpu=float(cpu.mean()), mean_gpu=float(gpu.mean()))
    np.testing.assert_allclose(gpu, cpu, rtol=RTOL, atol=ATOL)


def _light_emission_leaf(host):
    """(texture row, channel) of the light's emission in the FlatScene."""
    import numpy as np

    from raytrace2 import defs

    mats = host.materials
    light = int(np.nonzero(np.asarray(mats.mtype) == defs.MAT_DIFFUSE_LIGHT)[0][0])
    return int(np.asarray(mats.tex)[light]), 0


def phase_grad(card):
    import dataclasses

    import jax
    import jax.numpy as jnp
    import numpy as np

    from raytrace2 import grad as grad_mod
    from raytrace2.scene import schema
    from raytrace2.utils import device

    host = cornell()
    features = tuple(sorted(host.features().items()))
    scene = schema.to_device(host)
    kw = dict(width=W, height=H, n_samples=1, max_depth=DEPTH, sqrt_spp=1)
    step = jax.jit(lambda s: grad_mod.value_and_grad_scene(
        jnp.mean, s, features, 0, **kw))
    _, first = timed(lambda: step(scene))
    (loss, g), secs = timed(lambda: step(scene))
    albedo = np.asarray(g.materials.albedo)
    peak = device.peak_bytes()
    report("grad", card, size=f"{W}x{H}", depth=DEPTH, n_samples=1,
           loss=float(loss), step_s=secs, first_step_s=first,
           peak_bytes_in_use=peak,
           albedo_grad_abs_sum=float(np.abs(albedo).sum()))
    check(bool(np.isfinite(albedo).all()), "non-finite albedo gradient")
    check(bool((albedo != 0).any()), "all-zero albedo gradient")

    # AD vs a central finite difference on the light's emission.
    tex, ch = _light_emission_leaf(host)
    small = dict(width=64, height=64, n_samples=2, max_depth=8, sqrt_spp=1)

    def with_emission(s, delta):
        t = s.textures
        return dataclasses.replace(s, textures=dataclasses.replace(
            t, albedo=t.albedo.at[tex, ch].add(delta)))

    loss_fn = jax.jit(lambda s, d: jnp.mean(grad_mod.render_image(
        with_emission(s, d), features, 0, **small)))
    _, g_small = grad_mod.value_and_grad_scene(
        jnp.mean, scene, features, 0, **small)
    ad = float(g_small.textures.albedo[tex, ch])
    eps = 1e-3
    fd = (float(loss_fn(scene, eps)) - float(loss_fn(scene, -eps))) / (2 * eps)
    report("grad_fd", card, leaf=f"textures.albedo[{tex},{ch}]", ad=ad, fd=fd,
           rel_err=abs(ad - fd) / max(abs(fd), 1e-12))
    check(abs(ad - fd) <= FD_TOL * abs(fd) + 1e-5,
          f"emission gradient: AD {ad} vs FD {fd}")


def phase_four(card):
    """The sharded paths on four cards, each against one card."""
    import jax
    import jax.numpy as jnp
    import numpy as np

    from raytrace2.parallel import sharding
    from raytrace2.scene import schema
    from raytrace2.utils import device

    devs = jax.devices()
    check(len(devs) == 4, f"--four needs 4 devices, found {len(devs)}")
    host = cornell()
    feat = host.features()
    features = tuple(sorted(feat.items()))
    scene = schema.to_device(host)
    total = 4
    one = sharding.make_mesh(sp=1, dp=1, devices=devs[:1])
    kw = dict(width=W, height=H, max_depth=DEPTH, sqrt_spp=2)

    ref = np.asarray(sharding.render_samples_sharded(
        scene, features, jnp.int32(0), 0, samples_per_device=total,
        mesh=one, **kw))
    feat_k = tuple(sorted(dict(feat, use_megakernel=True).items()))
    ref_k = np.asarray(sharding.render_samples_sharded_mega(
        scene, feat_k, jnp.int32(0), 0, samples_per_device=total,
        mesh=one, **kw))
    for sp, dp in ((1, 4), (2, 2)):
        mesh = sharding.make_mesh(sp=sp, dp=dp, devices=devs)
        out, secs = timed(lambda: sharding.render_samples_sharded(
            scene, features, jnp.int32(0), 0, samples_per_device=total // sp,
            mesh=mesh, **kw))
        check(len(out.sharding.device_set) == 4, "XLA render not on 4 cards")
        out = np.asarray(out)
        report("four_render", card, mesh=[sp, dp], seconds_incl_compile=secs,
               max_abs_diff=float(np.abs(out - ref).max()))
        np.testing.assert_allclose(out, ref, rtol=RTOL, atol=ATOL)
        out_k, secs = timed(lambda: sharding.render_samples_sharded_mega(
            scene, feat_k, jnp.int32(0), 0, samples_per_device=total // sp,
            mesh=mesh, **kw))
        check(len(out_k.sharding.device_set) == 4, "kernel not on 4 cards")
        out_k = np.asarray(out_k)
        report("four_kernel", card, mesh=[sp, dp], seconds_incl_compile=secs,
               max_abs_diff=float(np.abs(out_k - ref_k).max()))
        np.testing.assert_allclose(out_k, ref_k, rtol=RTOL, atol=ATOL)

    target = jnp.zeros((H, W, 3), jnp.float32)
    gkw = dict(width=W, height=H, max_depth=DEPTH, sqrt_spp=1, n_samples=1)
    loss_1, g_1 = sharding.render_grad_sharded(
        scene, features, target, 0, mesh=one, **gkw)
    (loss_4, g_4), secs = timed(lambda: sharding.render_grad_sharded(
        scene, features, target, 0,
        mesh=sharding.make_mesh(sp=2, dp=2, devices=devs), **gkw))
    peaks = [device.peak_bytes(d) for d in devs]
    report("four_grad", card, loss_1=float(loss_1), loss_4=float(loss_4),
           seconds_incl_compile=secs, peak_bytes_per_card=peaks)
    np.testing.assert_allclose(float(loss_4), float(loss_1), rtol=RTOL)
    np.testing.assert_allclose(np.asarray(g_4.materials.albedo),
                               np.asarray(g_1.materials.albedo),
                               rtol=RTOL, atol=ATOL)
    check(min(peaks) > 0, f"a card did no work: peaks {peaks}")


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--four", action="store_true",
                   help="run only the sharded paths, on four cards")
    args = p.parse_args(argv)

    sys.path.insert(0, REPO)
    from raytrace2.utils import device, enable_compilation_cache

    try:
        dev = device.require_gpu()
    except device.NoGpuError as e:
        print(f"chip_smoke: {e}", file=sys.stderr)
        return 2
    card = device.card_line()
    os.makedirs(OUT, exist_ok=True)
    enable_compilation_cache()
    report("device", card, **device.describe(dev))
    print(f"card: {card}", flush=True)

    phases = [phase_four] if args.four else [
        phase_cli, phase_corpus, phase_kernel_vs_xla, phase_gpu_vs_cpu,
        phase_grad]
    for phase in phases:
        phase(card)
    print(json.dumps({"ok": True, "device": device.describe(dev)}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
