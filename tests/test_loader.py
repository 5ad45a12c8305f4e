"""Scene-loading tests: every data/ scene (both JSON format generations,
see src/Serialize.cpp:199-360 and SURVEY.md §2.8) must compile to a
flattened SoA scene with sane invariants."""

import glob
import os

import numpy as np
import pytest

from raytrace2 import defs
from raytrace2.scene import loader

pytestmark = pytest.mark.tier0

DATA_DIR = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "data")
ALL_SCENES = sorted(
    os.path.basename(p)
    for p in glob.glob(os.path.join(DATA_DIR, "*.json"))
    # camera files are not scenes
    if not os.path.basename(p).startswith("camera_")
)


def test_enum_repr_material_types(tmp_path):
    """An older make_scene.py serialized material types as Python enum
    reprs ("MatType.lambertian"); the loader accepts the suffix."""
    import json

    doc = {
        "camera": {"fov": 40, "center": [0, 0, 1], "look_at": [0, 0, 0]},
        "materials": [{"type": "MatType.lambertian", "albedo": [0.5, 0.5, 0.5]},
                      {"type": "MatType.metal", "albedo": [0.8, 0.8, 0.8],
                       "fuzz": 0.1}],
        "primitives": [
            {"type": "sphere", "center": [0, 0, 0], "radius": 1.0, "material": 0},
            {"type": "sphere", "center": [2, 0, 0], "radius": 0.5, "material": 1},
        ],
    }
    p = tmp_path / "enum.json"
    p.write_text(json.dumps(doc))
    scene, _ = loader.load_scene(str(p))
    assert int(scene.spheres.active.sum()) == 2
    assert list(scene.materials.mtype[:2]) == [defs.MAT_LAMBERTIAN, defs.MAT_METAL]


def test_data_dir_has_the_corpus():
    assert {"cornell_box_original.json", "cornell_box_volume.json",
            "book1_final.json", "book2_final_scene_10000_samples.json",
            "checkered_spheres.json", "final_render_book_1.json",
            "cornell_box_scene_graph.json"} <= set(ALL_SCENES)


@pytest.mark.parametrize("name", ALL_SCENES)
def test_load_all_reference_scenes(name, data_dir):
    scene, dims = loader.load_scene(os.path.join(data_dir, name))
    ns = int(scene.spheres.active.sum())
    nq = int(scene.quads.active.sum())
    nm = int(scene.media.active.sum())
    assert ns + nq + nm > 0, "scene flattened to zero records"
    # material indices in range
    K = scene.materials.count
    assert scene.spheres.material.max() < K
    assert scene.quads.material.max() < K
    assert scene.media.material.max() < K
    # texture indices in range
    L = scene.textures.count
    assert scene.materials.tex.max() < L
    # quad precomputation consistency: normal·q == d, w ∥ normal for active rows
    act = scene.quads.active
    if nq:
        n = scene.quads.normal[act]
        assert np.allclose(np.linalg.norm(n, axis=-1), 1.0, atol=1e-5)
        assert np.allclose(
            np.sum(n * scene.quads.q[act], axis=-1), scene.quads.d[act], rtol=1e-4, atol=1e-4
        )


def test_book2_final_scene_counts(data_dir):
    """book2 final: 400 floor boxes (→2400 quads) + 1 light quad + 1007 spheres,
    2 constant media (data/book2_final_scene_10000_samples.json, built by
    tools/make_scene.py book2_final, seed 0)."""
    scene, dims = loader.load_scene(
        os.path.join(data_dir, "book2_final_scene_10000_samples.json")
    )
    assert dims == (600, 600)
    assert int(scene.quads.active.sum()) == 400 * 6 + 1
    # 1007 spheres total; 2 of them are medium boundaries (boundary spheres at
    # [360,150,145] r=70 and [0,0,0] r=5000) → 1005 surface spheres + 3 media?
    # make_scene adds: moving sphere, dielectric, metal, dielectric(surface),
    # same sphere as medium, world-fog sphere as medium, perlin sphere,
    # 1000 cluster spheres. Media: 2 sphere-boundary media.
    assert int(scene.media.active.sum()) == 2
    assert int(scene.spheres.active.sum()) == 1005
    # the 1000-sphere cluster is under a rotate+translate node → baked rigidly:
    # radius unchanged (order-independent: spheres are Morton-sorted at load)
    radii = scene.spheres.radius[scene.spheres.active]
    assert int(np.isclose(radii, 10.0).sum()) == 1000


def test_cornell_box_original(data_dir):
    scene, dims = loader.load_scene(os.path.join(data_dir, "cornell_box_original.json"))
    assert dims == (600, 600)
    # 6 wall/light quads + 2 boxes × 6 quads, each box occurrence transformed
    assert int(scene.quads.active.sum()) == 6 + 12
    assert int(scene.spheres.active.sum()) == 0
    assert np.allclose(scene.background, [0, 0, 0])
    assert float(scene.camera.vfov) == 40.0


def test_cornell_volume_media(data_dir):
    scene, _ = loader.load_scene(os.path.join(data_dir, "cornell_box_volume.json"))
    m = scene.media
    assert int(m.active.sum()) == 2
    assert np.all(m.btype[m.active] == defs.MEDIUM_BOX)
    # rotated boxes → inverse affine is not identity
    ident = np.hstack([np.eye(3), np.zeros((3, 1))])
    assert not np.allclose(m.inv_model[0], ident, atol=1e-6)
    # isotropic media materials auto-registered with solid textures
    assert np.all(scene.materials.mtype[m.material[m.active]] == defs.MAT_ISOTROPIC)


def test_legacy_checkered_spheres(data_dir):
    scene, dims = loader.load_scene(os.path.join(data_dir, "checkered_spheres.json"))
    assert dims is None  # legacy: camera by name, no width
    assert int(scene.spheres.active.sum()) == 2
    # camera file camera_checkered_spheres.json: fov 20, center [13,2,3]
    assert float(scene.camera.vfov) == 20.0
    assert np.allclose(scene.camera.center, [13, 2, 3])
    # checker texture children
    assert scene.textures.ttype[0] == defs.TEX_CHECKER
    assert np.isclose(scene.textures.inv_scale[0], 1.0 / 0.32, rtol=1e-5)


def test_legacy_final_render_book1(data_dir):
    """Legacy book-1 excerpt: spheres by material_id, one moving, and no
    camera key."""
    scene, dims = loader.load_scene(os.path.join(data_dir, "final_render_book_1.json"))
    assert dims is None
    assert int(scene.spheres.active.sum()) == 5
    assert int((np.abs(scene.spheres.displacement).sum(-1) > 0).sum()) == 1
    # no camera key → loader defaults (src/Serialize.cpp:32-40)
    assert float(scene.camera.vfov) == 90.0


def test_scene_graph_nesting(data_dir):
    """cornell_box_scene_graph.json nests boxes 3 deep with accumulated
    translations — nested transforms must compose parent·child."""
    scene, _ = loader.load_scene(os.path.join(data_dir, "cornell_box_scene_graph.json"))
    nq = int(scene.quads.active.sum())
    assert nq == 6 + 3 * 6  # walls + 3 nested boxes
    # The innermost box sits at the sum of its ancestors' translations:
    # (100,0,100) + R15·((120,0,0) + R15·(0,100,120)) — its quads reach
    # y = 100..200 (only the innermost level is lifted by 100).
    q = np.asarray(scene.quads.q)[np.asarray(scene.quads.active)][6:]
    assert np.isclose(q[:, 1].max(), 200.0, atol=1e-3)


def test_instancing_duplicates():
    """The same primitive referenced by two graph nodes must appear twice."""
    import json, tempfile

    doc = {
        "camera": {"fov": 40, "center": [0, 0, 1], "look_at": [0, 0, 0]},
        "materials": [{"type": "lambertian", "albedo": [0.5, 0.5, 0.5]}],
        "primitives": [{"type": "sphere", "center": [0, 0, 0], "radius": 1.0, "material": 0}],
        "scene": [
            {"primitive": 0},
            {"primitive": 0, "transform": {"translation": [5, 0, 0]}},
        ],
    }
    with tempfile.NamedTemporaryFile("w", suffix=".json", delete=False) as f:
        json.dump(doc, f)
        path = f.name
    scene, _ = loader.load_scene(path)
    act = scene.spheres.active
    assert int(act.sum()) == 2
    centers = scene.spheres.center0[act]
    assert np.allclose(sorted(centers[:, 0].tolist()), [0.0, 5.0])
    os.unlink(path)


# --------------------------------------------------------------------------
# Loud rejection at the supported-scope edges (loader._validate_references;
# the reference prints-and-skips bad entries, Serialize.cpp:102-104 — this
# port refuses to silently mis-render).
# --------------------------------------------------------------------------

_EDGE_BASE = {
    "camera": {"fov": 90, "center": [0, 0, 1], "look_at": [0, 0, 0]},
    "background_color": [1, 1, 1],
    "materials": [{"type": "texture", "tex_idx": 1}],
    "primitives": [
        {"type": "sphere", "center": [0, 0, 0], "radius": 0.5, "material": 0}
    ],
    "scene": [{"primitive": 0}],
}


def _write_scene(tmp_path, name, overrides):
    import json

    doc = dict(_EDGE_BASE)
    doc.update(overrides)
    p = tmp_path / name
    p.write_text(json.dumps(doc))
    return str(p)


@pytest.mark.parametrize(
    "name,overrides,needle",
    [
        (
            "checker_cycle",
            {"textures": [
                {"type": "solid_color", "albedo": [1, 0, 0]},
                {"type": "checker", "scale": 1.0, "even_tex_idx": 2,
                 "odd_tex_idx": 0},
                {"type": "checker", "scale": 0.5, "even_tex_idx": 1,
                 "odd_tex_idx": 0}]},
            "CYCLE",
        ),
        (
            "checker_child_oob",
            {"textures": [
                {"type": "solid_color", "albedo": [1, 0, 0]},
                {"type": "checker", "scale": 1.0, "even_tex_idx": 7,
                 "odd_tex_idx": 0}]},
            "out of range",
        ),
        (
            "mat_tex_oob",
            {"textures": [{"type": "solid_color", "albedo": [1, 0, 0]},
                          {"type": "solid_color", "albedo": [0, 1, 0]}],
             "materials": [{"type": "texture", "tex_idx": 99}]},
            "tex_idx 99 out of range",
        ),
        (
            "prim_mat_oob",
            {"textures": [{"type": "solid_color", "albedo": [1, 0, 0]},
                          {"type": "solid_color", "albedo": [0, 1, 0]}],
             "primitives": [{"type": "sphere", "center": [0, 0, 0],
                             "radius": 0.5, "material": 7}]},
            "material index 7 out of range",
        ),
        (
            "unknown_texture_type",
            {"textures": [{"type": "wavelet"}],
             "materials": [{"type": "lambertian", "albedo": [1, 1, 1]}]},
            "Invalid texture type",
        ),
        (
            "unknown_material_type",
            {"textures": [{"type": "solid_color", "albedo": [1, 0, 0]},
                          {"type": "solid_color", "albedo": [0, 1, 0]}],
             "materials": [{"type": "subsurface"}]},
            "Invalid material type",
        ),
    ],
)
def test_scope_edges_raise_loudly(tmp_path, name, overrides, needle):
    path = _write_scene(tmp_path, name + ".json", overrides)
    with pytest.raises(loader.SceneError, match=needle):
        loader.load_scene(path)


def test_medium_over_flat_quad_is_reference_noop(tmp_path, capsys):
    """The full authorable constant_medium surface is sphere | box (the
    6-quad convex MakeBox — 'quad-composed' boundary, supported incl.
    transforms) | a flat quad (Serialize.cpp:287-341). The flat-quad case
    never scatters in the reference — ConstantMedium::Hit needs entry AND
    exit hits and a plane is hit once (ConstantMedium.cpp:14-33) — so the
    wrapped primitive disappears. Parity: load fine, emit nothing, warn."""
    overrides = {
        "textures": [{"type": "solid_color", "albedo": [1, 0, 0]},
                     {"type": "solid_color", "albedo": [0, 1, 0]}],
        "primitives": [{"type": "quad", "q": [0, 0, 0], "u": [1, 0, 0],
                        "v": [0, 1, 0], "material": 0,
                        "constant_medium": {"density": 0.5,
                                            "albedo": [1, 1, 1]}}]}
    path = _write_scene(tmp_path, "medium_quad.json", overrides)
    scene, _ = loader.load_scene(path)
    assert int(scene.media.active.sum()) == 0
    assert int(scene.quads.active.sum()) == 0
    assert "never scatters" in capsys.readouterr().err


def test_nested_checker_loads_with_depth(tmp_path):
    """Checker-of-checker is in scope (reference recursion,
    Texture.cpp:7-11): loads, and features() reports the nesting depth."""
    overrides = {"textures": [
        {"type": "solid_color", "albedo": [1, 0, 0]},
        {"type": "checker", "scale": 1.0, "even_tex_idx": 2,
         "odd_tex_idx": 0},
        {"type": "checker", "scale": 0.5, "even_tex_idx": 0,
         "odd_tex_idx": 0}]}
    path = _write_scene(tmp_path, "nested.json", overrides)
    scene, _ = loader.load_scene(path)
    assert int(scene.features()["has_checker"]) == 2
