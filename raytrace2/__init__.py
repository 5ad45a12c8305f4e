"""raytrace2 — a differentiable path tracer in JAX.

A from-scratch JAX/XLA/Pallas re-design of the feature set of
tonadr1022/Raytrace2 (a C++ CPU path tracer following the Ray Tracing in One
Weekend series). Scenes load from the same JSON formats; rendering runs as
batched, jit-compiled computations — on a GPU, a Pallas megakernel compiled
through Triton for the scenes it supports — and shards pixels/samples over
device meshes.
"""

__version__ = "0.1.0"
