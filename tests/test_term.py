"""Terminal live-preview frame construction."""

import numpy as np

from raytrace2.io import term


def test_ansi_frame_shape_and_colors():
    img = np.zeros((4, 6, 3))
    img[0] = [1.0, 0.0, 0.0]  # renderer bottom row red
    frame = term.ansi_frame(img, max_cols=6)
    lines = frame.split("\n")
    assert len(lines) == 2  # 4 rows → 2 half-block lines
    # Bottom image row appears in the LAST line's background (flip), red ≈ 255.
    assert "48;2;255;0;0" in lines[-1]
    assert frame.endswith("\x1b[0m")


def test_ansi_frame_downsamples_wide_images():
    img = np.ones((8, 400, 3)) * 0.5
    frame = term.ansi_frame(img, max_cols=100)
    first = frame.split("\n")[0]
    assert first.count("▀") <= 100
