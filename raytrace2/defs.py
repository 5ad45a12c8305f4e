"""Global constants and dtype policy for the path tracer.

Mirrors the semantics of the reference's foundational definitions
(reference: src/Defs.hpp:4-27, src/cpu_raytrace/Interval.cpp:7-13):

* ``real`` is float32 (the reference compiles without ``DOUBLE``).
  ``RAYTRACE2_DOUBLE=1`` in the environment is the ``#define DOUBLE`` analog
  (src/Defs.hpp:4-7): REAL becomes float64 and jax x64 mode is enabled —
  a CPU-side verification mode (the oracle tests can compare f32 renders
  against f64 ground truth; the production paths stay f32 by design).
* "Infinity" is the REAL type's max, **not** IEEE inf — the reference
  defines ``kInfinity = std::numeric_limits<real>::max()`` (src/Defs.hpp:7)
  and all interval arithmetic relies on that. We keep the same convention so
  that interval tests behave identically and no inf*0 NaNs appear under jit.
"""

from __future__ import annotations

import os

import numpy as np

# float32 everywhere on the compute path; geometry in bf16 loses too much
# precision for ray intersection, so bf16 is not used for the tracer core.
DOUBLE = os.environ.get("RAYTRACE2_DOUBLE", "") not in ("", "0")
REAL = np.float64 if DOUBLE else np.float32
INDEX = np.int32
if DOUBLE:
    import jax

    jax.config.update("jax_enable_x64", True)

# Reference: src/Defs.hpp:7 — numeric max, not inf.
INFINITY = REAL(np.finfo(REAL).max)

# Minimum hit distance for shading rays (reference: src/cpu_raytrace/RayTracer.cpp:25).
T_MIN = REAL(1e-3)

# Quad parallel-ray epsilon (reference: src/cpu_raytrace/Quad.cpp:22).
QUAD_EPS = REAL(1e-8)

# Near-zero scatter-direction epsilon (reference: src/cpu_raytrace/Math.hpp:61-64).
NEAR_ZERO_EPS = REAL(1e-8)

# Constant-medium re-entry epsilon (reference: src/cpu_raytrace/ConstantMedium.cpp:22).
MEDIUM_EPS = REAL(1e-4)

# AABB minimum side padding (reference: src/cpu_raytrace/AABB.hpp:58-64).
AABB_PAD = REAL(1e-4)

# Material type ids (reference dispatches a std::variant, src/cpu_raytrace/Fwd.hpp:13-14;
# we dispatch on an integer type id instead).
MAT_LAMBERTIAN = 0
MAT_METAL = 1
MAT_DIELECTRIC = 2
MAT_TEXTURE = 3
MAT_DIFFUSE_LIGHT = 4
MAT_ISOTROPIC = 5
NUM_MAT_TYPES = 6

# Texture type ids (reference: src/cpu_raytrace/Fwd.hpp:20).
TEX_SOLID = 0
TEX_CHECKER = 1
TEX_NOISE = 2

# Noise type ids (reference: src/cpu_raytrace/Texture.hpp:30).
NOISE_PERLIN = 0
NOISE_MARBLE = 1

# Medium boundary type ids (new framework concept: the reference wraps an
# arbitrary hittable, src/cpu_raytrace/ConstantMedium.hpp:8-18; in the SoA
# form boundaries are analytic spheres or boxes).
MEDIUM_SPHERE = 0
MEDIUM_BOX = 1

# Primitive record classes used by the unified hit encoding.
REC_SPHERE = 0
REC_QUAD = 1
REC_MEDIUM = 2
