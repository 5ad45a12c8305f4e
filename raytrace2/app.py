"""CLI app shell — the JAX form of App::Run (src/App.cpp:81-249).

Bit-compatible inputs:
* ``python -m raytrace2 <scene.json> [out.png]`` — argv parsing mirrors
  App.cpp:86-107 (default scene ``data/scene2.json`` relative to the
  reference-style root, ``.json`` suffix optional, optional explicit output
  path).
* ``local/data/settings.json`` — AppSettings fields num_samples,
  render_once, save_after_render_once, max_depth, render_window
  (src/Serialize.cpp:56-65, src/Settings.hpp:5-11). ``render_window`` is
  accepted but there is no GL window here; the progressive preview writes
  PNG snapshots instead (--preview-every).

Extra flags (new capabilities, all optional) never conflict with the
reference surface.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time
from datetime import datetime


def load_app_settings(path: str) -> dict:
    """AppSettings with reference defaults (Serialize.cpp:56-65); silently
    empty on missing/invalid file (Util.cpp:21-32 semantics)."""
    obj = {}
    try:
        with open(path) as f:
            obj = json.load(f)
    except (OSError, json.JSONDecodeError):
        pass
    return {
        "num_samples": int(obj.get("num_samples", 1)),
        "render_once": bool(obj.get("render_once", False)),
        "save_after_render_once": bool(obj.get("save_after_render_once", False)),
        "max_depth": int(obj.get("max_depth", 50)),
        "render_window": bool(obj.get("render_window", True)),
    }


def _resolve_scene(arg: str | None, root: str) -> tuple[str, str]:
    """argv[1] handling (App.cpp:86-100): default scene2, optional .json."""
    if not arg:
        return os.path.join(root, "data", "scene2.json"), "scene2"
    path = arg
    if path.endswith(".json"):
        name = os.path.basename(path)[: -len(".json")]
    else:
        name = os.path.basename(path)
        path += ".json"
    return path, name


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="raytrace2",
        description="Progressive path tracer in JAX (Raytrace2 capabilities).",
    )
    p.add_argument("scene", nargs="?", help="scene JSON path (default data/scene2.json)")
    p.add_argument("output", nargs="?", help="output image path (.png or .ppm)")
    p.add_argument("--root", default=".", help="project root for data/ and local/ dirs")
    p.add_argument("--settings", default=None, help="settings.json path (default local/data/settings.json)")
    p.add_argument("--samples", type=int, default=None, help="override num_samples")
    p.add_argument("--depth", type=int, default=None, help="override max_depth")
    p.add_argument("--width", type=int, default=None, help="override image width")
    p.add_argument("--height", type=int, default=None, help="override image height")
    p.add_argument("--seed", type=int, default=0, help="deterministic render seed")
    p.add_argument("--camera", default=None, metavar="CAM_JSON",
                   help="override the scene camera with a standalone camera "
                        "file (e.g. data/cam1.json)")
    p.add_argument("--chunk-size", type=int, default=None, help="rays per trace chunk")
    p.add_argument("--batch", type=int, default=0,
                   help="samples per device dispatch (0 = auto)")
    p.add_argument("--preview-every", type=int, default=0,
                   help="write a progressive preview PNG every N samples")
    p.add_argument("--checkpoint", default=None,
                   help="accumulator checkpoint path (resume if it exists)")
    p.add_argument("--checkpoint-every", type=int, default=0,
                   help="checkpoint the accumulator every N samples")
    p.add_argument("--live", action="store_true",
                   help="progressive ANSI preview in the terminal (the "
                        "headless analog of the reference's render window); "
                        "implies --watch")
    p.add_argument("--watch", action="store_true",
                   help="reload the scene and restart accumulation when the "
                        "scene file changes mid-render (the headless analog "
                        "of the reference's load-scene UI, App.cpp:210-229)")
    p.add_argument("--live-cols", type=int, default=100)
    p.add_argument("--profile", default=None, metavar="DIR",
                   help="capture a jax.profiler trace of the render into DIR")
    p.add_argument("--metrics", default=None, metavar="JSONL",
                   help="append one JSON line of structured metrics per "
                        "dispatch (sample index, wall time, Mpaths/s, device "
                        "memory) plus a final summary record")
    p.add_argument("--backend", default="auto",
                   choices=["auto", "xla", "bvh", "mega"],
                   help="render path: auto (default) routes by scene and "
                        "device (render.route); xla/bvh force the XLA path "
                        "without/with the sphere BVH; mega forces the "
                        "Pallas megakernel")
    p.add_argument("--quiet", action="store_true")
    return p


class _KeyControls:
    """Non-blocking single-key control of a running render — the headless
    analog of the reference's ImGui runtime panel (App.cpp:210-229: frame
    count, scene hot-load, tracer Reset). Active only when stdin is a TTY;
    everywhere else ``poll`` is a no-op so piped/CI runs are unaffected.

    Keys: q finish now (write image + exit) · w write a snapshot now ·
    r reset accumulation · c write the camera JSON (WriteCamera parity,
    src/Serialize.cpp:47-54)."""

    def __init__(self, enabled: bool):
        self.active = False
        if not enabled:
            return
        try:
            import termios
            import tty

            self._fd = sys.stdin.fileno()
            if not os.isatty(self._fd):
                return
            self._termios = termios
            self._saved = termios.tcgetattr(self._fd)
            tty.setcbreak(self._fd)
            self.active = True
            # Restore the terminal on ANY exit path (Ctrl-C mid-render,
            # render errors): close() is idempotent, so the explicit call
            # on the normal path and this atexit hook coexist.
            import atexit

            atexit.register(self.close)
        except Exception:
            self.active = False

    def poll(self) -> str:
        """Drain pending keypresses; returns them as a string ('' if none)."""
        if not self.active:
            return ""
        import select

        keys = []
        while True:
            ready, _, _ = select.select([sys.stdin], [], [], 0)
            if not ready:
                break
            keys.append(sys.stdin.read(1))
        return "".join(keys)

    def close(self) -> None:
        if self.active:
            self._termios.tcsetattr(
                self._fd, self._termios.TCSADRAIN, self._saved)
            self.active = False


def _device_mem() -> dict:
    """Bytes in use and peak bytes on the render device, where the backend
    reports them (a GPU exposes memory_stats; the CPU reports nothing)."""
    import jax

    stats = jax.local_devices()[0].memory_stats() or {}
    return {out: int(stats[key]) for key, out in
            (("bytes_in_use", "device_mem_bytes"),
             ("peak_bytes_in_use", "device_peak_bytes")) if key in stats}


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)

    settings_path = args.settings or os.path.join(args.root, "local", "data", "settings.json")
    settings = load_app_settings(settings_path)
    if args.samples is not None:
        settings["num_samples"] = args.samples
    if args.depth is not None:
        settings["max_depth"] = args.depth

    scene_path, scene_name = _resolve_scene(args.scene, args.root)

    def log(*a):
        if not args.quiet:
            print(*a, flush=True)

    # Startup echo (App.cpp:108-113).
    log(f"Render window: {int(settings['render_window'])}")
    log(f"Render once: {int(settings['render_once'])}")
    log(f"Num Samples: {settings['num_samples']}")
    log(f"Max Depth: {settings['max_depth']}")
    log(f"Scene Path: {scene_path}")

    # Heavy imports after arg parsing so --help stays instant.
    from raytrace2.io import image as image_io
    from raytrace2.io import checkpoint as ckpt_io
    from raytrace2.render import Renderer
    from raytrace2.scene import loader
    from raytrace2.utils import enable_compilation_cache

    enable_compilation_cache()

    try:
        scene, dims = loader.load_scene(scene_path, seed=args.seed)
        if args.camera:
            import dataclasses

            scene = dataclasses.replace(
                scene, camera=loader.load_camera_file(args.camera)
            )
    except (OSError, loader.SceneError, json.JSONDecodeError) as e:
        print(f"Failed to load scene: {e}", file=sys.stderr)
        return 1

    width, height = dims or (1600, 900)  # initial_dims default (App.cpp:115)
    if args.width:
        width = args.width
        height = args.height or width
    elif args.height:
        height = args.height

    renderer_kw = dict(
        num_samples=settings["num_samples"],
        max_depth=settings["max_depth"],
        seed=args.seed,
        chunk_size=args.chunk_size or 65536,
        backend=args.backend,
    )
    try:
        renderer = Renderer(scene, width, height, **renderer_kw)
    except ValueError as e:  # a forced backend that cannot render the scene
        print(f"Cannot render: {e}", file=sys.stderr)
        return 1

    if args.checkpoint and os.path.exists(args.checkpoint):
        state = ckpt_io.load_state(args.checkpoint)
        renderer.set_state(state)
        log(f"Resumed from {args.checkpoint} at sample {renderer.frame_idx}")

    out_path = args.output
    if not out_path:
        outdir = os.path.join(args.root, "local", "output")
        os.makedirs(outdir, exist_ok=True)
        stamp = datetime.now().strftime("%Y-%m-%d.%H:%M:%S")
        out_path = os.path.join(outdir, f"{scene_name}_{stamp}.png")

    total = settings["num_samples"]
    rays_per_sample = width * height
    # Samples per dispatch: large batches amortize host→device round-trips
    # while keeping preview/checkpoint cadence; auto = up to 1/10 of the run.
    batch = args.batch or max(min(total // 10, 64), 1)
    for gate in (args.preview_every, args.checkpoint_every):
        if gate:
            batch = min(batch, gate)
    profiler_cm = None
    if args.profile:
        import jax

        profiler_cm = jax.profiler.trace(args.profile)
        profiler_cm.__enter__()
    t0 = time.perf_counter()
    done0 = renderer.frame_idx
    first_frame = True
    watch = args.watch or args.live
    watch_mtime = os.stat(scene_path).st_mtime if watch else None
    keys = _KeyControls(enabled=args.live or args.watch)
    if keys.active:
        log("Keys: [q]uit+save  [w]rite snapshot  [r]eset  [c]amera save")
    while renderer.frame_idx < total:
        if watch:
            try:
                mtime = os.stat(scene_path).st_mtime
            except OSError:
                mtime = watch_mtime  # mid-swap; retry next iteration
            if mtime != watch_mtime:
                try:
                    new_scene, new_dims = loader.load_scene(
                        scene_path, seed=args.seed)
                    if args.camera:
                        import dataclasses

                        new_scene = dataclasses.replace(
                            new_scene, camera=loader.load_camera_file(args.camera)
                        )
                except (OSError, loader.SceneError, json.JSONDecodeError) as e:
                    # Partial write or bad edit: keep rendering the old
                    # scene; mtime stays armed so the next change retries.
                    log(f"Scene reload failed (keeping current): {e}")
                else:
                    watch_mtime = mtime
                    # Honor the edited file's dims unless the CLI pinned a
                    # size (accumulation restarts either way, so a
                    # resolution edit is free — the reference's resize
                    # path, RayTracer.cpp:87-104).
                    if new_dims and not (args.width or args.height):
                        width, height = new_dims
                        rays_per_sample = width * height
                    renderer = Renderer(
                        new_scene, width, height, **renderer_kw)
                    t0 = time.perf_counter()
                    done0 = 0
                    log(f"Scene reloaded: {scene_path} (accumulation reset)")
        renderer.update(min(batch, total - renderer.frame_idx))
        i = renderer.frame_idx
        if args.metrics:
            # Time completed work, not the enqueue: dispatch is async.
            renderer.state.accum.block_until_ready()
            dt = time.perf_counter() - t0
            rec = {
                "event": "dispatch", "sample": i, "total": total,
                "elapsed_s": round(dt, 4),
                "mpaths_per_s": round(
                    (i - done0) * rays_per_sample / max(dt, 1e-9) / 1e6, 4),
                "width": width, "height": height, "scene": scene_name,
            }
            rec.update(_device_mem())
            with open(args.metrics, "a") as f:
                f.write(json.dumps(rec) + "\n")
        pressed = keys.poll()
        if pressed:
            if "r" in pressed:
                renderer.reset()
                t0 = time.perf_counter()
                done0 = 0
                log("Accumulation reset")
            if "w" in pressed:
                image_io.write_image(renderer.linear_pixels(), out_path)
                log(f"Snapshot written: {out_path}")
            if "c" in pressed:
                cam_path = out_path + ".camera.json"
                loader.write_camera(renderer.scene.camera, cam_path)
                log(f"Camera written: {cam_path}")
            if "q" in pressed:
                log("Quit requested — writing image")
                break
        if args.live:
            from raytrace2.io import term

            dt = time.perf_counter() - t0
            term.redraw(
                renderer.linear_pixels(), args.live_cols, first=first_frame,
                status=(
                    f"sample {i}/{total}  "
                    f"{(i - done0) * rays_per_sample / max(dt, 1e-9) / 1e6:.2f}"
                    " Mpaths/s" + ("  [q/w/r/c]" if keys.active else "")
                ),
            )
            first_frame = False
        if not args.quiet and not args.live:
            dt = time.perf_counter() - t0
            log(
                f"sample {i}/{total}  "
                f"{(i - done0) * rays_per_sample / max(dt, 1e-9) / 1e6:.2f} Mpaths/s"
            )
        if args.preview_every and i % args.preview_every == 0 and i < total:
            image_io.write_image(renderer.linear_pixels(), out_path)
        if args.checkpoint and args.checkpoint_every and i % args.checkpoint_every == 0:
            ckpt_io.save_state(args.checkpoint, renderer.state)

    keys.close()
    if profiler_cm is not None:
        profiler_cm.__exit__(None, None, None)
    if args.metrics:
        dt = time.perf_counter() - t0
        with open(args.metrics, "a") as f:
            f.write(json.dumps({
                "event": "done", "samples": renderer.frame_idx,
                "total": total, "elapsed_s": round(dt, 4),
                "mpaths_per_s": round(
                    (renderer.frame_idx - done0) * rays_per_sample
                    / max(dt, 1e-9) / 1e6, 4),
                "width": width, "height": height, "scene": scene_name,
                "output": out_path, **_device_mem(),
            }) + "\n")
    log(f"Writing image: {out_path}")
    image_io.write_image(renderer.linear_pixels(), out_path)
    if args.checkpoint:
        ckpt_io.save_state(args.checkpoint, renderer.state)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
