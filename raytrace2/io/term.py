"""Terminal live preview — the headless replacement for the reference's
SDL2/OpenGL live view (src/Window.cpp, src/App.cpp:176-242).

Renders the progressive accumulator as 24-bit-color ANSI half-blocks (▀ has
an upper fg and lower bg pixel → two image rows per text row). The CLI's
``--live`` mode redraws in place each sample batch, giving the same
"watch it converge" workflow the GL window provided.
"""

from __future__ import annotations

import numpy as np

from raytrace2.io import image as image_io

_HALF = "▀"  # upper half block


def ansi_frame(linear: np.ndarray, max_cols: int = 100) -> str:
    """One ANSI frame from a linear [H,W,3] image (display orientation:
    row 0 bottom, same as the renderer's buffer)."""
    rgb = image_io.to_color(linear)[::-1]  # flip: top row first for printing
    h, w, _ = rgb.shape
    step = max(1, (w + max_cols - 1) // max_cols)
    rgb = rgb[::step, ::step]
    h, w, _ = rgb.shape
    if h % 2:
        rgb = np.concatenate([rgb, np.zeros((1, w, 3), np.uint8)], axis=0)
        h += 1
    lines = []
    for y in range(0, h, 2):
        top = rgb[y]
        bot = rgb[y + 1]
        parts = []
        for x in range(w):
            tr, tg, tb = (int(v) for v in top[x])
            br, bg_, bb = (int(v) for v in bot[x])
            parts.append(f"\x1b[38;2;{tr};{tg};{tb}m\x1b[48;2;{br};{bg_};{bb}m{_HALF}")
        lines.append("".join(parts) + "\x1b[0m")
    return "\n".join(lines)


def redraw(linear: np.ndarray, max_cols: int = 100, first: bool = False,
           status: str = "") -> None:
    """Print a frame (plus an optional status line under it — the headless
    analog of the reference's frame-count panel, App.cpp:212-213),
    rewinding the cursor over the previous one."""
    frame = ansi_frame(linear, max_cols)
    if status:
        frame += "\n\x1b[2K" + status
    n_lines = frame.count("\n") + 1
    if not first:
        print(f"\x1b[{n_lines}A", end="")
    print(frame)
