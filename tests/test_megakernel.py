"""Path-regeneration megakernel (ops/pallas/megakernel.py) in the Pallas
interpreter: exact results on deterministic scenes, and agreement with the
plain reference — the XLA bounce loop on the kernel's own murmur RNG
streams (features rng_impl="murmur"), which traces the same paths."""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from raytrace2.io import compare
from raytrace2.ops import integrator
from raytrace2.ops.pallas import megakernel as mk
from raytrace2.scene import loader, schema

pytestmark = pytest.mark.kernel  # interpreted Pallas: seconds each on CPU


def _scene(tmp_path, j, name="k.json"):
    p = tmp_path / name
    p.write_text(json.dumps(j))
    scene, _ = loader.load_scene(str(p))
    return scene


def _render(scene, w, h, spp, depth, kernel, seed=0, s0=0):
    """Mean radiance over ``spp`` progressive samples; ``kernel`` picks
    the interpreted megakernel, else the XLA loop on matched streams."""
    feat = dict(scene.features())
    if kernel:
        feat.update(use_megakernel=True, mega_interpret=True)
    else:
        feat.update(use_megakernel=False, rng_impl="murmur")
    dev = schema.to_device(scene)
    out = jax.jit(lambda s: integrator.render_progressive(
        s, feat, w, h, jnp.int32(s0), jnp.int32(spp), seed, depth,
        max(int(np.sqrt(spp)), 1)))(dev)
    return np.asarray(out) / spp


def test_emissive_enclosure_exact(tmp_path):
    scene = _scene(tmp_path, {
        "background_color": [0, 0, 0],
        "camera": {"fov": 90, "center": [0, 0, 0], "look_at": [0, 0, -1]},
        "materials": [{"type": "diffuse_light", "albedo": [2.0, 3.0, 4.0]}],
        "primitives": [{"type": "sphere", "center": [0, 0, 0], "radius": 10.0,
                        "material": 0}],
    })
    img = _render(scene, 8, 8, 3, 4, kernel=True)
    np.testing.assert_allclose(img, np.broadcast_to([2, 3, 4], img.shape),
                               rtol=1e-5)


def test_lambertian_plane_exact(tmp_path):
    scene = _scene(tmp_path, {
        "background_color": [1.0, 0.8, 0.6],
        "camera": {"fov": 40, "center": [0, 5, 0], "look_at": [0, 0, -10]},
        "materials": [{"type": "lambertian", "albedo": [0.3, 0.5, 0.7]}],
        "primitives": [{"type": "quad", "q": [-1000, 0, -1000],
                        "u": [2000, 0, 0], "v": [0, 0, 2000], "material": 0}],
    })
    img = _render(scene, 8, 8, 3, 4, kernel=True)
    np.testing.assert_allclose(
        img, np.broadcast_to(np.array([0.3, 0.5, 0.7]) * [1.0, 0.8, 0.6],
                             img.shape), rtol=1e-4)


def test_aa_box_family_exact(tmp_path):
    """Axis-aligned boxes take the kernel's slab test; an emissive box
    interior must still be exact (every ray hits the box walls)."""
    scene = _scene(tmp_path, {
        "background_color": [0, 0, 0],
        "camera": {"fov": 90, "center": [0, 0, 0], "look_at": [0, 0, -1]},
        "materials": [{"type": "diffuse_light", "albedo": [1.5, 2.5, 3.5]}],
        "primitives": [{"type": "box", "a": [-5, -5, -5], "b": [5, 5, 5],
                        "material": 0}],
    })
    assert int(np.asarray(scene.boxes.active).sum()) == 1
    img = _render(scene, 8, 8, 2, 4, kernel=True)
    np.testing.assert_allclose(img, np.broadcast_to([1.5, 2.5, 3.5], img.shape),
                               rtol=1e-5)


def _mixed_scene():
    """Metal, dielectric, checker floor, an AA box and a light. (The floor
    sits off the checker's cell boundaries: on y = 0 the parity would hang
    on the sign of a rounding error in the hit point.)"""
    return {
        "background_color": [0.6, 0.7, 0.9],
        "textures": [
            {"type": "solid_color", "albedo": [0.9, 0.9, 0.9]},
            {"type": "solid_color", "albedo": [0.2, 0.3, 0.1]},
            {"type": "checker", "scale": 2.0, "even_tex_idx": 0,
             "odd_tex_idx": 1},
        ],
        "materials": [
            {"type": "texture", "tex_idx": 2},
            {"type": "metal", "albedo": [0.8, 0.8, 0.9], "fuzz": 0.1},
            {"type": "dielectric", "refraction_index": 1.5},
            {"type": "diffuse_light", "albedo": [4, 4, 4]},
            {"type": "lambertian", "albedo": [0.5, 0.7, 0.5]},
        ],
        "primitives": [
            {"type": "quad", "q": [-50, -0.37, -50], "u": [100, 0, 0],
             "v": [0, 0, 100], "material": 0},
            {"type": "sphere", "center": [-1.2, 1, 0], "radius": 1.0,
             "material": 1},
            {"type": "sphere", "center": [1.2, 1, 0], "radius": 1.0,
             "material": 2},
            {"type": "box", "a": [-0.5, 0, 1.2], "b": [0.5, 0.8, 2.0],
             "material": 4},
            {"type": "quad", "q": [-1, 4, -1], "u": [2, 0, 0],
             "v": [0, 0, 2], "material": 3},
        ],
        "camera": {"fov": 50, "center": [0, 2, 6], "look_at": [0, 1, 0]},
    }


def _many_spheres_scene():
    """40 spheres (> the unrolled-loop limit: the sweep runs as a loop)
    with 41 materials (per-lane gathers from a larger material table)."""
    rs = np.random.RandomState(3)
    mats, prims = [{"type": "diffuse_light", "albedo": [5, 5, 5]}], []
    for i in range(40):
        mats.append({"type": "lambertian",
                     "albedo": [float(x) for x in rs.uniform(0.2, 0.9, 3)]})
        prims.append({"type": "sphere",
                      "center": [float(rs.uniform(-4, 4)),
                                 float(rs.uniform(0.2, 1.0)),
                                 float(rs.uniform(-4, 4))],
                      "radius": 0.3, "material": i + 1})
    prims.append({"type": "quad", "q": [-2, 5, -2], "u": [4, 0, 0],
                  "v": [0, 0, 4], "material": 0})
    return {"background_color": [0.3, 0.35, 0.5],
            "camera": {"fov": 60, "center": [0, 2, 8], "look_at": [0, 0.5, 0]},
            "materials": mats, "primitives": prims}


@pytest.mark.parametrize("source", [
    "cornell_box_original.json", "cornell_box_volume.json",
    "checkered_spheres.json", "mixed", "many_spheres",
])
def test_matches_reference_on_matched_streams(source, data_dir, tmp_path):
    """Kernel == XLA loop on the same streams: the same paths, so only
    f32 rounding may differ (and every path here agrees)."""
    if source == "mixed":
        scene = _scene(tmp_path, _mixed_scene())
    elif source == "many_spheres":
        scene = _scene(tmp_path, _many_spheres_scene())
        assert scene.features()["mega_sizes"][0] > 32
    else:
        scene, _ = loader.load_scene(f"{data_dir}/{source}")
    a = _render(scene, 24, 16, 4, 12, kernel=True)
    b = _render(scene, 24, 16, 4, 12, kernel=False)
    assert abs(a.mean() - b.mean()) < 1e-3
    p = compare.psnr(a.astype(np.float64), b.astype(np.float64))
    assert p > 45.0, f"{source}: matched-stream PSNR {p:.1f} dB"


def test_nested_checker_cross_backend(tmp_path):
    """Depth-2 checker on matched streams: the kernel's per-level parity
    and re-resolve must agree with the XLA texture recursion."""
    scene = _scene(tmp_path, {
        "background_color": [1, 1, 1],
        "camera": {"fov": 50, "center": [0, 6, 5], "look_at": [0, 0, 0]},
        "textures": [
            {"type": "solid_color", "albedo": [0.9, 0.1, 0.1]},
            {"type": "solid_color", "albedo": [0.1, 0.1, 0.9]},
            {"type": "checker", "scale": 0.7, "even_tex_idx": 0,
             "odd_tex_idx": 1},
            {"type": "checker", "scale": 2.9, "even_tex_idx": 2,
             "odd_tex_idx": 1},
        ],
        "materials": [{"type": "texture", "tex_idx": 3}],
        "primitives": [{"type": "quad", "q": [-20, 0.37, -20],
                        "u": [40, 0, 0], "v": [0, 0, 40], "material": 0}],
    })
    assert int(scene.features()["has_checker"]) == 2
    im_m = _render(scene, 24, 16, 2, 4, kernel=True)
    im_x = _render(scene, 24, 16, 2, 4, kernel=False)
    assert abs(im_m.mean() - im_x.mean()) < 1e-3
    np.testing.assert_allclose(im_m, im_x, rtol=1e-3, atol=1e-3)


@pytest.mark.parametrize("seed", [0, 16, 17, 42, 123, 2**28 + 7])
def test_sample_keys_distinct_above_seed_16(seed):
    """Regression: deriving seed*1000003+s in f32 collapses keys above 2^24
    (seed >= 17), duplicating progressive samples. Every (seed, sample)
    pair must get its own key."""
    keys = np.asarray(jax.jit(jax.vmap(
        lambda s: mk.sample_key(seed, jnp.uint32(12345), s)
    ))(jnp.arange(256)))
    assert len(np.unique(keys)) == 256, f"seed {seed}: collapsed sample keys"
    keys2 = np.asarray(jax.jit(jax.vmap(
        lambda sd: mk.sample_key(sd, jnp.uint32(12345), 3)
    ))(jnp.arange(64) + seed))
    assert len(np.unique(keys2)) == 64


def test_high_seed_samples_not_duplicated(tmp_path):
    """End-to-end form of the regression: at seed 123 eight single-sample
    renders must all differ."""
    scene = _scene(tmp_path, {
        "background_color": [1.0, 1.0, 1.0],
        "camera": {"fov": 60, "center": [0, 2, 4], "look_at": [0, 0, 0]},
        "materials": [{"type": "metal", "albedo": [0.9, 0.9, 0.9],
                       "fuzz": 0.9}],
        "primitives": [{"type": "sphere", "center": [0, 0, 0], "radius": 1.5,
                        "material": 0}],
    })
    singles = np.stack([_render(scene, 8, 8, 1, 6, kernel=True, seed=123,
                                s0=s).reshape(-1) for s in range(8)])
    for i in range(8):
        for j in range(i + 1, 8):
            assert not np.allclose(singles[i], singles[j]), (i, j)


def test_batch_split_invariance(data_dir):
    """Samples [0,4) in one batch == [0,2) + [2,4): streams are pure
    functions of (pixel, sample)."""
    scene, _ = loader.load_scene(f"{data_dir}/cornell_box_original.json")
    feat = dict(scene.features(), use_megakernel=True, mega_interpret=True)
    dev = schema.to_device(scene)
    go = jax.jit(lambda s, s0, n: integrator.render_progressive(
        s, feat, 16, 16, s0, n, 0, 6, 2))
    whole = np.asarray(go(dev, jnp.int32(0), jnp.int32(4)))
    split = (np.asarray(go(dev, jnp.int32(0), jnp.int32(2)))
             + np.asarray(go(dev, jnp.int32(2), jnp.int32(2))))
    np.testing.assert_allclose(whole, split, rtol=1e-5, atol=1e-5)


def test_table_layout(data_dir):
    """The packed table holds the header then every family's records at
    the offsets the kernel reads."""
    scene, _ = loader.load_scene(f"{data_dir}/cornell_box_volume.json")
    sizes = scene.features()["mega_sizes"]
    dev = schema.to_device(scene)
    hdr = mk.header(dev, 40, 30, 5, 7, 2, slot0=128)
    table = np.asarray(mk.pack_table(dev, sizes, hdr))
    off, total = mk.table_offsets(sizes)
    assert table.shape == (total,)
    assert list(table[19:25]) == [40, 1200, 5, 7, 2, 128]
    np.testing.assert_array_equal(table[25:28], np.asarray(dev.background))
    q = off["quad"] + len(mk.QUAD_FIELDS)          # second quad
    np.testing.assert_allclose(table[q:q + 3], np.asarray(dev.quads.normal[1]))
    m = off["med"]
    assert table[m + len(mk.MED_FIELDS) - 1] == int(dev.media.material[0])
    t = off["tex"] + len(mk.TEX_FIELDS) * (sizes[3] - 1)
    assert table[t] == int(dev.textures.ttype[sizes[3] - 1])


@pytest.mark.parametrize("n,parts,want", [
    (360000, 1, 360000), (100, 1, 128), (100, 4, 64), (129, 2, 128)])
def test_slot_ranges(n, parts, want):
    assert mk.BLOCK == 64
    got = mk.n_slots_for(n, parts)
    assert got == want and got % mk.BLOCK == 0 and got * parts >= n


@pytest.mark.gpu
def test_compiled_kernel_matches_reference(gpu, data_dir):
    """The kernel as compiled for the card (no interpreter) against the XLA
    loop on matched streams, Cornell 64x64, depth 50, 16 spp."""
    scene, _ = loader.load_scene(f"{data_dir}/cornell_box_original.json")
    feat = scene.features()
    dev = schema.to_device(scene)
    run = {}
    for name, f in (("mega", dict(feat, use_megakernel=True)),
                    ("xla", dict(feat, use_megakernel=False,
                                 rng_impl="murmur"))):
        run[name] = np.asarray(jax.jit(lambda s, f=f: integrator.render_progressive(
            s, f, 64, 64, jnp.int32(0), jnp.int32(16), 0, 50, 4))(dev)) / 16
    assert abs(run["mega"].mean() - run["xla"].mean()) < 1e-3 * run["xla"].mean()
    assert compare.psnr(run["mega"].astype(np.float64),
                        run["xla"].astype(np.float64)) > 40.0
