"""Image writer tests: reference conversion semantics (src/Util.cpp:39-79)
and PNG round-trip."""

import numpy as np

from raytrace2.io import image
import pytest

pytestmark = pytest.mark.tier0


def test_to_color_gamma_and_clamp():
    lin = np.array([[[0.0, 0.25, 1.0]], [[4.0, -1.0, 0.5]]])
    out = image.to_color(lin)
    assert out.shape == (2, 1, 3)
    assert out[0, 0, 0] == 0
    assert out[0, 0, 1] == int(0.5 * 255.999)
    assert out[0, 0, 2] == 255
    assert out[1, 0, 0] == 255   # clamped above
    assert out[1, 0, 1] == 0     # clamped below
    assert out[1, 0, 2] == int(np.sqrt(0.5) * 255.999)


def test_png_roundtrip():
    rng = np.random.RandomState(0)
    rgb = rng.randint(0, 256, (13, 17, 3), np.uint8)
    dec = image.decode_png(image.encode_png(rgb))
    np.testing.assert_array_equal(dec, rgb)


def test_write_image_flips_vertically(tmp_path):
    lin = np.zeros((2, 1, 3))
    lin[0] = 1.0  # renderer row 0 (bottom scanline) is white
    p = tmp_path / "out.png"
    image.write_image(lin, str(p))
    dec = image.decode_png(p.read_bytes())
    assert dec[1, 0, 0] == 255  # ends up at the bottom of the file
    assert dec[0, 0, 0] == 0


def test_write_ppm(tmp_path):
    lin = np.ones((2, 2, 3)) * 0.25
    p = tmp_path / "out.ppm"
    image.write_image(lin, str(p))
    text = p.read_text().split()
    assert text[0] == "P3"
    assert text[1:3] == ["2", "2"]
    assert text[4] == str(int(0.5 * 255.999))
