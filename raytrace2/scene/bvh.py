"""Flattened BVH: reference build algorithm, array representation.

The reference builds a binary tree of ``shared_ptr`` nodes: sort the span by
the *minimum* of each child's AABB along the **longest axis of the span's
total bounds**, split at the median, recurse; single-object spans duplicate
the child (src/cpu_raytrace/BVH.cpp:10-48). Traversal tests the node AABB
then left, then right with the interval max shrunk to the left hit
(BVH.cpp:50-55).

Here the same algorithm emits index arrays (SoA, device-friendly):

* ``left/right[i]``  — child node ids (internal nodes)
* ``prim[i]``        — primitive id at leaves, -1 otherwise
* ``aabb_min/max[i,3]``

Node 0 is the root. Internal nodes: 2N-1 total for N primitives (leaves are
single-primitive; the reference's duplicate-single-child trick becomes a
plain leaf).

The builder has two implementations with identical output: NumPy (always
available) and native C++ (native/bvh_builder.cpp via ctypes, built by
``make -C native``, or at first use) — the analog of the reference's C++
build path, used at scene-load time where Python overhead dominates for
10k+-primitive scenes.

Traversal (`ops/bvh_traverse.py`) is an iterative fixed-depth stack inside
jit — the XLA path's sphere sweep for sphere-heavy scenes; smaller scenes
take the dense sweep (see ops/intersect.py).
"""

from __future__ import annotations

import ctypes
import dataclasses
import os
from typing import Any

import numpy as np

import jax

from raytrace2 import defs


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class BVHArrays:
    aabb_min: Any  # [M,3] f32
    aabb_max: Any  # [M,3] f32
    left: Any      # [M] i32 (child id; -1 at leaves)
    right: Any     # [M] i32
    prim: Any      # [M] i32 (primitive id at leaves; -1 internal)

    @property
    def num_nodes(self) -> int:
        return self.left.shape[0]


_LIB = None
_LIB_TRIED = False
_NATIVE_DIR = os.path.abspath(
    os.path.join(os.path.dirname(__file__), "..", "..", "native"))


def _build_native(path: str) -> None:
    """Build native/libbvh.so from native/Makefile (first use in a fresh
    checkout; the library is not committed). One builder at a time: test
    workers share the checkout. A missing compiler leaves no library and
    the NumPy builder serves."""
    import fcntl
    import subprocess

    with open(os.path.join(_NATIVE_DIR, ".build.lock"), "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if not os.path.exists(path):
            try:
                subprocess.run(["make", "-s", "-C", _NATIVE_DIR, "libbvh.so"],
                               check=True, capture_output=True, timeout=300)
            except (OSError, subprocess.SubprocessError):
                pass


def _native_lib():
    global _LIB, _LIB_TRIED
    if not _LIB_TRIED:
        _LIB_TRIED = True
        path = os.path.join(_NATIVE_DIR, "libbvh.so")
        if not os.path.exists(path):
            _build_native(path)
        if os.path.exists(path):
            try:
                lib = ctypes.CDLL(path)
                lib.bvh_build.restype = ctypes.c_int
                lib.bvh_build.argtypes = [
                    ctypes.c_int,
                    np.ctypeslib.ndpointer(np.float32, flags="C"),
                    np.ctypeslib.ndpointer(np.float32, flags="C"),
                    np.ctypeslib.ndpointer(np.float32, flags="C"),
                    np.ctypeslib.ndpointer(np.float32, flags="C"),
                    np.ctypeslib.ndpointer(np.int32, flags="C"),
                    np.ctypeslib.ndpointer(np.int32, flags="C"),
                    np.ctypeslib.ndpointer(np.int32, flags="C"),
                ]
                _LIB = lib
            except OSError:
                _LIB = None
    return _LIB


def build(aabb_min: np.ndarray, aabb_max: np.ndarray, use_native: bool | None = None) -> BVHArrays:
    """Build the flattened BVH over N primitive AABBs.

    ``use_native``: force the C++ builder (True), the NumPy builder (False),
    or auto (None — native if the shared library is built).
    """
    aabb_min = np.ascontiguousarray(aabb_min, np.float32).reshape(-1, 3)
    aabb_max = np.ascontiguousarray(aabb_max, np.float32).reshape(-1, 3)
    n = aabb_min.shape[0]
    if n == 0:
        raise ValueError("cannot build a BVH over zero primitives")
    m = 2 * n - 1

    lib = _native_lib() if use_native in (None, True) else None
    if use_native is True and lib is None:
        raise RuntimeError("native BVH library not built (make -C native)")

    if lib is not None:
        out_min = np.empty((m, 3), np.float32)
        out_max = np.empty((m, 3), np.float32)
        left = np.empty(m, np.int32)
        right = np.empty(m, np.int32)
        prim = np.empty(m, np.int32)
        used = lib.bvh_build(n, aabb_min, aabb_max, out_min, out_max, left, right, prim)
        assert used == m, f"native builder emitted {used} nodes, expected {m}"
        return BVHArrays(out_min, out_max, left, right, prim)

    return _build_numpy(aabb_min, aabb_max)


def _build_numpy(aabb_min: np.ndarray, aabb_max: np.ndarray) -> BVHArrays:
    """Iterative (explicit stack) median-split build, identical ordering to
    the reference's recursion (BVH.cpp:10-31): node ids are assigned in
    pre-order, left subtree before right."""
    n = aabb_min.shape[0]
    m = 2 * n - 1
    out_min = np.empty((m, 3), np.float32)
    out_max = np.empty((m, 3), np.float32)
    left = np.full(m, -1, np.int32)
    right = np.full(m, -1, np.int32)
    prim = np.full(m, -1, np.int32)

    order = np.arange(n)

    # Explicit stack of (span_start, span_end, node_id). Ids follow pre-order
    # layout arithmetic: a node over c primitives occupies ids
    # [id, id + 2c - 1); left child = id + 1 (over mid prims), right child =
    # id + 2·mid.
    stack = [(0, n, 0)]
    while stack:
        start, end, node = stack.pop()
        span = order[start:end]
        mn = aabb_min[span].min(0)
        mx = aabb_max[span].max(0)
        out_min[node] = mn
        out_max[node] = mx
        if end - start == 1:
            prim[node] = span[0]
            continue
        # Longest axis of the span bounds (AABB::LongestAxis, AABB.hpp:49-54),
        # sort by child AABB min on that axis (BVH.cpp:33-48).
        axis = int(np.argmax(mx - mn))
        keys = aabb_min[span, axis]
        order[start:end] = span[np.argsort(keys, kind="stable")]
        mid = (end - start) // 2
        l_id = node + 1
        r_id = node + 2 * mid
        left[node] = l_id
        right[node] = r_id
        stack.append((start + mid, end, r_id))
        stack.append((start, start + mid, l_id))
    return BVHArrays(out_min, out_max, left, right, prim)


def build_sphere_bvh(spheres) -> tuple[BVHArrays, int]:
    """BVH over a scene's ACTIVE spheres (the loader packs actives as a
    prefix, so leaf prim ids are sphere row indices). AABBs are
    motion-inclusive — they cover the center path over the whole shutter,
    exactly like the reference's moving-sphere constructor unions the t=0
    and t=1 boxes (src/cpu_raytrace/Sphere.hpp:24-27).

    Returns (tree, max_depth) with max_depth sized for the traversal stack.
    """
    c0 = np.asarray(spheres.center0)
    disp = np.asarray(spheres.displacement)
    rad = np.asarray(spheres.radius)[:, None]
    act = np.asarray(spheres.active)
    n = int(act.sum())
    if not np.all(act[:n]):
        raise ValueError("active spheres must form a prefix")
    lo = np.minimum(c0, c0 + disp)[:n] - rad[:n]
    hi = np.maximum(c0, c0 + disp)[:n] + rad[:n]
    tree = build(lo, hi)
    return tree, depth(tree)


def depth(bvh: BVHArrays) -> int:
    """Maximum tree depth (for sizing the traversal stack)."""
    left = np.asarray(bvh.left)
    right = np.asarray(bvh.right)
    d = np.zeros(left.shape[0], np.int32)
    maxd = 0
    stack = [(0, 0)]
    while stack:
        node, dd = stack.pop()
        maxd = max(maxd, dd)
        if left[node] >= 0:
            stack.append((left[node], dd + 1))
            stack.append((right[node], dd + 1))
    return maxd


def sah_cost(bvh: BVHArrays) -> float:
    """Surface-area-heuristic cost metric (diagnostics/benchmarks)."""
    mn = np.asarray(bvh.aabb_min)
    mx = np.asarray(bvh.aabb_max)
    ext = np.maximum(mx - mn, 0)
    area = 2 * (ext[:, 0] * ext[:, 1] + ext[:, 1] * ext[:, 2] + ext[:, 0] * ext[:, 2])
    root = max(area[0], 1e-30)
    internal = np.asarray(bvh.prim) < 0
    return float((area[internal].sum() * 1.2 + area[~internal].sum()) / root)
