"""Progressive renderer: the JAX form of cpu::RayTracer.

The reference accumulates one stratified sample per pixel per Update call
into ``accumulation_data_`` and derives display pixels as
``clamp(acc / frame_idx)`` (src/cpu_raytrace/RayTracer.cpp:55-70). Here the
accumulator is an immutable [H,W,3] array threaded through a jitted step
function (donated, so XLA updates it in place); ``Reset``/``OnResize``
(RayTracer.cpp:49-53, 87-104) become fresh-state construction. The
(accumulator, frame_idx, seed) triple is the full render state — serialize it
and rendering resumes exactly (see io/checkpoint.py), the disk-backed
extension of the reference's in-memory progressive design (SURVEY.md §5).
"""

from __future__ import annotations

import dataclasses
import functools
import math
from typing import Any

import jax
import jax.numpy as jnp
import numpy as np

from raytrace2 import defs
from raytrace2.ops import integrator
from raytrace2.ops.pallas import megakernel
from raytrace2.scene import schema


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class RenderState:
    """Progressive accumulation state (resume-able)."""

    accum: Any      # [H,W,3] f32 linear radiance sum
    frame_idx: Any  # [] i32 — samples accumulated so far


def init_state(width: int, height: int) -> RenderState:
    return RenderState(
        accum=jnp.zeros((height, width, 3), defs.REAL),
        frame_idx=jnp.int32(0),
    )


@functools.partial(
    jax.jit,
    static_argnames=("features", "width", "height", "max_depth", "sqrt_spp",
                     "chunk_size"),
    donate_argnames=("state",),
)
def render_step(scene, features, state, seed, n_samples=1, *, width, height,
                max_depth, sqrt_spp, chunk_size):
    """``n_samples`` progressive samples for all pixels, accumulated in one
    dispatch (RayTracer::Update × n; n is traced → one compilation)."""
    radiance = integrator.render_progressive(
        scene, dict(features), width, height, state.frame_idx, n_samples,
        seed, max_depth, sqrt_spp, chunk_size,
    )
    return RenderState(
        accum=state.accum + radiance,
        frame_idx=state.frame_idx + jnp.asarray(n_samples, jnp.int32),
    )


def linear_image(state: RenderState) -> jnp.ndarray:
    """acc / frame_idx in linear space — RayTracer::NonConvertedPixels
    (src/cpu_raytrace/RayTracer.cpp:105-112)."""
    return state.accum / jnp.maximum(state.frame_idx, 1).astype(state.accum.dtype)


def display_image(state: RenderState) -> jnp.ndarray:
    """u8 display pixels: clamp(acc/frames) → sqrt gamma → 255.999 scale
    (RayTracer.cpp:16-18,64-66 + Util.cpp:41-48)."""
    lin = jnp.clip(linear_image(state), 0.0, 1.0)
    return jnp.clip(jnp.sqrt(lin) * 255.999, 0.0, 255.0).astype(jnp.uint8)


BACKENDS = ("auto", "xla", "bvh", "mega")


def route(features: dict, backend: str, platform: str) -> str:
    """The path a render takes: ``"mega"`` (the Pallas megakernel) or
    ``"xla"`` (the XLA bounce loop, with or without the sphere BVH).

    'auto' takes the kernel on a GPU for every scene it supports
    (megakernel.supports: no noise textures or ellipsoids, at most
    MAX_RECORDS records) and XLA otherwise; on the CPU it takes XLA, since
    the kernel runs there only in the interpreter. 'mega' forces the kernel
    and refuses a scene it cannot render; 'xla' and 'bvh' force XLA."""
    if backend not in BACKENDS:
        raise ValueError(f"unknown backend {backend!r}; expected {BACKENDS}")
    if backend == "mega":
        if not megakernel.supports(features):
            raise ValueError(
                "backend 'mega' cannot render this scene (noise textures, "
                f"ellipsoids or more than {megakernel.MAX_RECORDS} records)")
        return "mega"
    if backend == "auto" and platform == "gpu" and megakernel.supports(features):
        return "mega"
    return "xla"


@dataclasses.dataclass
class Renderer:
    """Host-side progressive driver — the App/RayTracer pair's public surface
    (Update / Reset / OnResize / Pixels / NonConvertedPixels / FrameIdx,
    src/cpu_raytrace/RayTracer.hpp:15-42) in functional form."""

    scene: schema.FlatScene
    width: int
    height: int
    num_samples: int = 1
    max_depth: int = 50
    seed: int = 0
    chunk_size: int | None = 65536
    backend: str = "auto"  # 'auto' | 'xla' | 'bvh' | 'mega' (see route())
    _features: tuple = ()
    _state: RenderState | None = None

    def __post_init__(self):
        features = self.scene.features()
        platform = jax.default_backend()
        kernel = route(features, self.backend, platform) == "mega"
        features["use_megakernel"] = kernel
        # The Pallas interpreter runs a kernel only where it was asked for
        # by name on the CPU (tests); a GPU always runs the compiled kernel.
        features["mega_interpret"] = kernel and platform == "cpu"
        n_records = megakernel.n_records(features["mega_sizes"] or (0,) * 6)
        if self.chunk_size == 65536 and n_records > 1024:
            # Large scenes on the XLA path: smaller chunks bound the
            # [chunk, records] intersection intermediates.
            self.chunk_size = 16384
        # Sphere BVH for the XLA path on sphere-heavy scenes (book1: 486
        # spheres, book2: 1005): the dense sweep is O(rays x spheres), the
        # traversal O(rays x log) — the production home of the reference's
        # App-level BVH wrap (src/App.cpp:126). 'bvh' forces it for any
        # sphere count.
        n_sph_active = int(np.asarray(self.scene.spheres.active).sum())
        use_bvh = self.backend == "bvh" or (
            not kernel and self.backend in ("auto", "xla")
            and n_sph_active >= 256
        )
        if use_bvh and n_sph_active:
            from raytrace2.scene import bvh as bvh_mod

            tree, md = bvh_mod.build_sphere_bvh(self.scene.spheres)
            self.scene = dataclasses.replace(self.scene, sphere_bvh=tree)
            features["use_bvh_spheres"] = True
            features["bvh_depth"] = md
        self._features = tuple(sorted(features.items()))
        self.scene = schema.to_device(self.scene)
        self.reset()

    @property
    def sqrt_spp(self) -> int:
        # Stratification grid side — int sqrt truncation as in Camera::Update
        # (Camera.hpp:45); non-square sample counts wrap strata.
        return max(int(math.sqrt(self.num_samples)), 1)

    def reset(self) -> None:
        """RayTracer::Reset (RayTracer.cpp:49-53)."""
        self._state = init_state(self.width, self.height)

    def resize(self, width: int, height: int) -> None:
        """RayTracer::OnResize — reallocate and restart accumulation
        (RayTracer.cpp:87-104)."""
        self.width, self.height = width, height
        self.reset()

    def update(self, n_samples: int = 1) -> None:
        """``n_samples`` progressive samples in one dispatch
        (RayTracer::Update semantics per sample)."""
        chunk = self.chunk_size
        n = self.width * self.height
        if chunk is not None and chunk >= n:
            chunk = None
        self._state = render_step(
            self.scene, self._features, self._state, self.seed,
            jnp.int32(n_samples),
            width=self.width, height=self.height, max_depth=self.max_depth,
            sqrt_spp=self.sqrt_spp, chunk_size=chunk,
        )

    def render(self, num_samples: int | None = None, batch: int = 1) -> np.ndarray:
        """Headless batch loop (App.cpp:243-248): run all samples, return the
        linear image. ``batch`` groups samples per dispatch."""
        remaining = num_samples or self.num_samples
        while remaining > 0:
            step = min(batch, remaining)
            self.update(step)
            remaining -= step
        return self.linear_pixels()

    @property
    def frame_idx(self) -> int:
        return int(self._state.frame_idx)

    @property
    def state(self) -> RenderState:
        return self._state

    def set_state(self, state: RenderState) -> None:
        """Restore a checkpointed accumulator (resume)."""
        self._state = state

    def linear_pixels(self) -> np.ndarray:
        return np.asarray(linear_image(self._state))

    def display_pixels(self) -> np.ndarray:
        return np.asarray(display_image(self._state))
