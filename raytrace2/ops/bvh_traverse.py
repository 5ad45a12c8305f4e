"""Iterative BVH traversal under jit (fixed-size stack, per-ray).

The reference traverses recursively with virtual dispatch
(src/cpu_raytrace/BVH.cpp:50-55): test the node AABB against the current
[t_min, t_max), then left, then right with max shrunk to the left's hit.
Here each ray walks the flattened arrays with an explicit stack inside
``lax.while_loop`` and shrinks its interval the same way; batches are
``vmap``-ed.

This is the XLA path's sphere sweep for sphere-heavy scenes (the Renderer
enables it from 256 spheres); smaller scenes take the dense sweep
(ops/intersect.py), and scenes within its scope take the megakernel on a
GPU. It is also the oracle-checked foundation for a per-ray BVH walk inside
the kernel (ROADMAP.md).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

BIG = np.float32(3.0e38)


def _aabb_hit(mn, mx, o, inv_d, t0, t1):
    """Slab test (src/cpu_raytrace/AABB.hpp:34-47): shrink [t0,t1) per axis,
    hit iff max > min (strict)."""
    ta = (mn - o) * inv_d
    tb = (mx - o) * inv_d
    lo = jnp.minimum(ta, tb)
    hi = jnp.maximum(ta, tb)
    t0 = jnp.maximum(t0, jnp.max(lo))
    t1 = jnp.minimum(t1, jnp.min(hi))
    return t1 > t0


def traverse_one(bvh, leaf_fn, o, d, t_min, t_max, max_depth: int):
    """Closest hit of one ray via the flattened BVH.

    Args:
      bvh: BVHArrays (device arrays).
      leaf_fn: (prim_id, t_min, t_max) -> t; returns the primitive's hit t in
        (t_min, t_max) or BIG. Must be jittable.
      o, d: [3]; t_min/t_max: scalars. max_depth: static stack bound
        (scene/bvh.depth(bvh) + 1).
    Returns (t, prim_id) with prim_id = -1 on miss.
    """
    inv_d = 1.0 / d
    stack_size = max_depth + 2

    def cond(state):
        sp, _, _, _ = state
        return sp > 0

    def body(state):
        sp, stack, best_t, best_p = state
        node = stack[sp - 1]
        sp = sp - 1
        hit_box = _aabb_hit(bvh.aabb_min[node], bvh.aabb_max[node], o, inv_d, t_min, best_t)
        is_leaf = bvh.prim[node] >= 0

        # Leaf: intersect primitive, shrink best.
        t_leaf = jnp.where(
            hit_box & is_leaf,
            leaf_fn(bvh.prim[node], t_min, best_t),
            BIG,
        )
        closer = t_leaf < best_t
        best_t = jnp.where(closer, t_leaf, best_t)
        best_p = jnp.where(closer, bvh.prim[node], best_p)

        # Internal: push children (right then left, so left pops first, same
        # visit order as the reference's left-then-right recursion).
        push = hit_box & ~is_leaf
        stack = stack.at[sp].set(jnp.where(push, bvh.right[node], stack[sp]))
        sp = sp + push.astype(jnp.int32)
        stack = stack.at[sp].set(jnp.where(push, bvh.left[node], stack[sp]))
        sp = sp + push.astype(jnp.int32)
        return sp, stack, best_t, best_p

    # np scalars (not jnp): jax.Array scalar constants become hoisted const
    # invars of the jaxpr under jax 0.9's simplified-constants mode, and the
    # cached C++ jit fastpath fails to re-supply them on the second call
    # ("Execution supplied 34 buffers but compiled program expected 36").
    # numpy scalars inline as literals and sidestep the bug entirely.
    stack = jnp.zeros(stack_size, jnp.int32)
    state = (np.int32(1), stack, t_max, np.int32(-1))
    _, _, best_t, best_p = jax.lax.while_loop(cond, body, state)
    return best_t, best_p


def traverse(bvh, leaf_fn, o, d, t_min, t_max, max_depth: int):
    """Batched closest hit: o,d [N,3]; t_min/t_max [N]. Returns ([N], [N])."""
    return jax.vmap(
        lambda oo, dd, a, b: traverse_one(bvh, leaf_fn, oo, dd, a, b, max_depth)
    )(o, d, t_min, t_max)
