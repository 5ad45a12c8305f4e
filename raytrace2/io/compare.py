"""Image comparison metrics for golden-image gates (PSNR between two
renders of the same scene, e.g. the megakernel against the XLA loop)."""

from __future__ import annotations

import numpy as np


def psnr(a: np.ndarray, b: np.ndarray, peak: float = 1.0) -> float:
    """Peak signal-to-noise ratio in dB between two images in [0, peak]."""
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    mse = np.mean((a - b) ** 2)
    if mse == 0:
        return float("inf")
    return float(10.0 * np.log10(peak * peak / mse))


def downsample(img: np.ndarray, factor: int) -> np.ndarray:
    """Box-filter downsample (noise-variance reduction for comparing
    low-spp renders against converged goldens)."""
    h, w, c = img.shape
    h2, w2 = h // factor, w // factor
    return img[: h2 * factor, : w2 * factor].reshape(
        h2, factor, w2, factor, c
    ).mean((1, 3))


def load_png_normalized(path: str) -> np.ndarray:
    """Load an 8-bit PNG as float [0,1] RGB (drops alpha)."""
    from raytrace2.io import image as image_io

    with open(path, "rb") as f:
        arr = image_io.decode_png(f.read())
    return arr[..., :3].astype(np.float64) / 255.0
