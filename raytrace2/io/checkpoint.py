"""Checkpoint/resume of the progressive accumulator.

The reference's accumulator is an in-memory checkpoint (rendering is
resumable sample-by-sample, src/cpu_raytrace/RayTracer.cpp:55-70, reset on
resize, :49-53); serializing the (accum, frame_idx) pair to disk extends that
to true restart-resume (SURVEY.md §5 checkpoint/resume). Format: a single
``.npz`` — no framework dependency, loadable anywhere.
"""

from __future__ import annotations

import os

import jax.numpy as jnp
import numpy as np

from raytrace2 import render as render_mod


def save_state(path: str, state: "render_mod.RenderState") -> None:
    tmp = path + ".tmp"
    np.savez(
        tmp if tmp.endswith(".npz") else tmp,
        accum=np.asarray(state.accum),
        frame_idx=np.asarray(state.frame_idx),
    )
    # np.savez appends .npz to paths without it; normalize.
    written = tmp if tmp.endswith(".npz") else tmp + ".npz"
    os.replace(written, path)


def load_state(path: str) -> "render_mod.RenderState":
    with np.load(path) as z:
        return render_mod.RenderState(
            accum=jnp.asarray(z["accum"]),
            frame_idx=jnp.asarray(z["frame_idx"], jnp.int32),
        )
