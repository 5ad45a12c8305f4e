"""JSON scene loading and compilation to the flattened SoA form.

Replaces the reference's ``serialize::SceneLoader::LoadScene``
(src/Serialize.cpp:199-360) and its recursive graph parser
(``ParseNode``, src/Serialize.cpp:161-197). Two scene-format generations are
accepted, like the data/ corpus requires (see SURVEY.md §2.8):

* **new format** — ``primitives`` is a typed list (``material`` index,
  ``constant_medium`` wrapper) plus ``scene`` graph nodes with TRS transforms.
* **legacy format** — ``primitives`` is a dict of ``spheres``/``quads``/
  ``boxes`` lists using ``material_id``; no scene graph (every primitive is a
  root); camera may be an object, a by-name string resolving to
  ``<data_dir>/<name>.json``, or absent.

Compilation strategy (array-first, no pointer graphs):

1. Parse JSON into light host records.
2. Walk the scene graph, composing each node chain's TRS matrices
   (translate·rotate·scale per node, src/Serialize.cpp:125-126; nested nodes
   compose parent·child, matching TransformedHittable nesting semantics).
3. For each primitive *occurrence*, bake the composite transform:
   quads take any affine exactly (q' = A q + t, u' = A u, v' = A v);
   spheres take rigid/uniform-scale transforms (center moved, radius scaled);
   constant-medium boundaries carry the inverse affine for model-space
   entry/exit tests. Instanced primitives are duplicated per occurrence.
4. Emit padded SoA arrays (schema.FlatScene).
"""

from __future__ import annotations

import dataclasses
import json
import math
import os
import sys
from typing import Any

import numpy as np

from raytrace2 import defs
from raytrace2.scene import perlin, schema


class SceneError(ValueError):
    pass


# --------------------------------------------------------------------------
# Host-side parse records
# --------------------------------------------------------------------------


@dataclasses.dataclass
class PrimDesc:
    kind: str                     # 'sphere' | 'quad' | 'box'
    params: dict
    material: int
    medium: dict | None = None    # {'density': float, 'material': int}


@dataclasses.dataclass
class SceneDesc:
    """Parsed but not yet flattened scene."""

    textures: list[dict]
    materials: list[dict]
    primitives: list[PrimDesc]
    nodes: list[dict]             # scene-graph roots ({} nodes with primitive/children/transform)
    camera: dict
    background: np.ndarray
    dims: tuple[int, int] | None


def _vec3(value, default=(0.0, 0.0, 0.0)) -> np.ndarray:
    if value is None:
        value = default
    return np.asarray(value, np.float64).reshape(3)


def _angle_axis_matrix(angle_deg: float, axis) -> np.ndarray:
    """Rotation matrix from angle-axis, matching glm::angleAxis semantics
    (axis is normalized by glm internally only if unit; the reference passes
    raw axes — glm::angleAxis expects a normalized axis, and the data files
    always use unit axes; we normalize defensively)."""
    axis = np.asarray(axis, np.float64)
    n = np.linalg.norm(axis)
    if n == 0:
        return np.eye(3)
    x, y, z = axis / n
    a = math.radians(angle_deg)
    c, s = math.cos(a), math.sin(a)
    C = 1 - c
    return np.array(
        [
            [c + x * x * C, x * y * C - z * s, x * z * C + y * s],
            [y * x * C + z * s, c + y * y * C, y * z * C - x * s],
            [z * x * C - y * s, z * y * C + x * s, c + z * z * C],
        ]
    )


def _parse_transform(node: dict) -> np.ndarray | None:
    """TRS composition per src/Serialize.cpp:106-132 (translate · rotate · scale).
    Returns a 4x4 matrix or None if the node carries no transform."""
    t_json = node.get("transform")
    if not isinstance(t_json, dict):
        return None
    translation = _vec3(t_json.get("translation"), (0, 0, 0))
    rot = t_json.get("rotation", [0.0, 0.0, 1.0, 0.0])  # [deg, x, y, z] default axis (0,1,0)
    # Reference default array is {0,0,1,0}: angle 0 about (0,1,0) — identity.
    rotation = _angle_axis_matrix(float(rot[0]), rot[1:4])
    scale = _vec3(t_json.get("scale"), (1, 1, 1))
    m = np.eye(4)
    m[:3, :3] = rotation @ np.diag(scale)
    m[:3, 3] = translation
    return m


# --------------------------------------------------------------------------
# JSON parsing (both format generations)
# --------------------------------------------------------------------------


_DEFAULT_CAMERA = {
    # LoadCamera defaults: src/Serialize.cpp:32-40.
    "fov": 90.0,
    "center": (0.0, 0.0, 1.0),
    "look_at": (0.0, 0.0, 0.0),
    "defocus_angle": 0.0,
    "focus_distance": 1.0,
}


def _parse_camera(obj: Any, data_dir: str) -> tuple[dict, tuple[int, int] | None]:
    dims = None
    if isinstance(obj, dict):
        cam_json = obj
        width = int(obj.get("width", 0))
        aspect = float(obj.get("aspect_ratio", 0.0))
        if width and aspect:
            # height = width / aspect (src/Serialize.cpp:348-357; C++ truncates).
            dims = (width, int(width / aspect))
    elif isinstance(obj, str):
        path = os.path.join(data_dir, obj + ".json")
        with open(path) as f:
            cam_json = json.load(f)
    else:
        cam_json = {}
    cam = {
        "fov": float(cam_json.get("fov", _DEFAULT_CAMERA["fov"])),
        "center": _vec3(cam_json.get("center"), _DEFAULT_CAMERA["center"]),
        "look_at": _vec3(cam_json.get("look_at"), _DEFAULT_CAMERA["look_at"]),
        "defocus_angle": float(cam_json.get("defocus_angle", 0.0)),
        "focus_distance": float(cam_json.get("focus_distance", 1.0)),
        "vup": np.array([0.0, 1.0, 0.0]),  # Camera.hpp:115 default view-up
    }
    return cam, dims


def _parse_textures(obj: dict, errors: list[str]) -> list[dict]:
    textures: list[dict] = []
    for t in obj.get("textures") or []:
        ttype = t.get("type", "")
        if ttype == "solid_color":
            textures.append({"type": "solid", "albedo": _vec3(t.get("albedo"), (1, 1, 1))})
        elif ttype == "checker":
            textures.append(
                {
                    "type": "checker",
                    "scale": float(t.get("scale", 1.0)),
                    "even": int(t.get("even_tex_idx", 0)),
                    "odd": int(t.get("odd_tex_idx", 0)),
                }
            )
        elif ttype == "noise":
            textures.append(
                {
                    "type": "noise",
                    "albedo": _vec3(t.get("albedo"), (1, 1, 1)),
                    "scale": float(t.get("scale", 1.0)),
                    "noise_type": int(t.get("noise_type", defs.NOISE_MARBLE)),
                    "point_count": int(t.get("point_count", perlin.POINT_COUNT)),
                }
            )
        else:
            errors.append(f"Invalid texture type: {ttype}")
    return textures


def _add_solid_texture(textures: list[dict], albedo) -> int:
    """Auto-register an inline solid-color texture
    (reference: src/Serialize.cpp:264-267, 274-277, 322-327)."""
    textures.append({"type": "solid", "albedo": _vec3(albedo, (1, 1, 1))})
    return len(textures) - 1


def _parse_materials(obj: dict, textures: list[dict], errors: list[str]) -> list[dict]:
    materials: list[dict] = []
    for m in obj.get("materials") or []:
        mtype = m.get("type", "")
        if mtype.startswith("MatType."):
            # test.json (repo root) was generated by an older make_scene.py
            # that serialized Python enum reprs; accept the suffix.
            mtype = mtype.split(".", 1)[1]
        if mtype == "" and "tex_idx" in m:
            # Lenient extension: data/final_render_checker.json has a typeless
            # material carrying only tex_idx; the reference loader aborts on it
            # (src/Serialize.cpp:246-249). Interpreting it as a texture
            # material keeps the whole data/ corpus loadable. That same scene
            # also ships NO textures array, so its tex_idx dangles — absorb it
            # with a default white solid (with a warning) instead of tripping
            # the strict reference validation; explicit typed materials stay
            # strict (_validate_references).
            mtype = "texture"
            if not (0 <= int(m["tex_idx"]) < len(textures)):
                print(
                    f"Warning: typeless material tex_idx {m['tex_idx']} "
                    "dangles (no such texture); substituting solid white",
                    file=sys.stderr,
                )
                m = dict(m, tex_idx=_add_solid_texture(textures, (1, 1, 1)))
        if mtype == "lambertian":
            materials.append({"type": defs.MAT_LAMBERTIAN, "albedo": _vec3(m.get("albedo"), (1, 1, 1))})
        elif mtype == "dielectric":
            materials.append({"type": defs.MAT_DIELECTRIC, "param": float(m.get("refraction_index", 1.0))})
        elif mtype == "metal":
            materials.append(
                {
                    "type": defs.MAT_METAL,
                    "albedo": _vec3(m.get("albedo"), (1, 1, 1)),
                    "param": float(m.get("fuzz", 0.0)),
                }
            )
        elif mtype == "texture":
            if "tex_idx" in m:
                materials.append({"type": defs.MAT_TEXTURE, "tex": int(m["tex_idx"])})
            elif "albedo" in m:
                materials.append({"type": defs.MAT_TEXTURE, "tex": _add_solid_texture(textures, m["albedo"])})
            else:
                errors.append("invalid texture material, must contain tex_idx or albedo")
        elif mtype == "diffuse_light":
            if "tex_idx" in m:
                materials.append({"type": defs.MAT_DIFFUSE_LIGHT, "tex": int(m["tex_idx"])})
            elif "albedo" in m:
                materials.append(
                    {"type": defs.MAT_DIFFUSE_LIGHT, "tex": _add_solid_texture(textures, m["albedo"])}
                )
            else:
                errors.append("invalid diffuse light, must contain tex_idx or albedo")
        else:
            errors.append(f"Invalid material type: {mtype}")
    return materials


def _parse_medium(pjson: dict, textures: list[dict], materials: list[dict], errors: list[str]) -> dict | None:
    """Per-primitive constant_medium wrapper (src/Serialize.cpp:320-340)."""
    if "constant_medium" not in pjson:
        return None
    cm = pjson["constant_medium"]
    if "albedo" in cm:
        tex_idx = _add_solid_texture(textures, cm.get("albedo", (0, 0, 0)))
        materials.append({"type": defs.MAT_ISOTROPIC, "tex": tex_idx})
        material_idx = len(materials) - 1
    elif "material" in cm:
        material_idx = int(cm.get("material", 0))
    else:
        errors.append("constant_medium must contain 'albedo' or 'material'")
        return None
    return {"density": float(cm.get("density", 0.01)), "material": material_idx}


def _parse_primitives_new(
    plist: list, textures: list[dict], materials: list[dict], errors: list[str]
) -> list[PrimDesc]:
    prims: list[PrimDesc] = []
    for p in plist:
        ptype = p.get("type", "")
        medium = _parse_medium(p, textures, materials, errors)
        mat = int(p.get("material", 0))
        if ptype == "quad":
            prims.append(
                PrimDesc(
                    "quad",
                    {
                        "q": _vec3(p.get("q"), (0, 0, 0)),
                        "u": _vec3(p.get("u"), (1, 0, 0)),
                        "v": _vec3(p.get("v"), (0, 0, 1)),
                    },
                    mat,
                    medium,
                )
            )
        elif ptype == "box":
            prims.append(
                PrimDesc(
                    "box",
                    {"a": _vec3(p.get("a"), (0, 0, 0)), "b": _vec3(p.get("b"), (1, 1, 1))},
                    mat,
                    medium,
                )
            )
        elif ptype == "sphere":
            prims.append(
                PrimDesc(
                    "sphere",
                    {
                        "center": _vec3(p.get("center"), (0, 0, 0)),
                        "displacement": _vec3(p.get("displacement"), (0, 0, 0)),
                        "radius": float(p.get("radius", 0.5)),
                    },
                    mat,
                    medium,
                )
            )
        else:
            errors.append(f"invalid primitive type: {ptype}")
    return prims


def _parse_primitives_legacy(
    pdict: dict, textures: list[dict], materials: list[dict], errors: list[str]
) -> list[PrimDesc]:
    """Legacy generation: ``primitives: {spheres: [...], quads: [...], boxes:
    [...]}`` with ``material_id`` (e.g. data/checkered_spheres.json,
    data/final_render_book_1.json, data/cornell_box2.json)."""
    prims: list[PrimDesc] = []
    for s in pdict.get("spheres") or []:
        prims.append(
            PrimDesc(
                "sphere",
                {
                    "center": _vec3(s.get("center"), (0, 0, 0)),
                    "displacement": _vec3(s.get("displacement"), (0, 0, 0)),
                    "radius": float(s.get("radius", 0.5)),
                },
                int(s.get("material_id", s.get("material", 0))),
                _parse_medium(s, textures, materials, errors),
            )
        )
    for qj in pdict.get("quads") or []:
        prims.append(
            PrimDesc(
                "quad",
                {
                    "q": _vec3(qj.get("q"), (0, 0, 0)),
                    "u": _vec3(qj.get("u"), (1, 0, 0)),
                    "v": _vec3(qj.get("v"), (0, 0, 1)),
                },
                int(qj.get("material_id", qj.get("material", 0))),
                _parse_medium(qj, textures, materials, errors),
            )
        )
    for b in pdict.get("boxes") or []:
        prims.append(
            PrimDesc(
                "box",
                {"a": _vec3(b.get("a"), (0, 0, 0)), "b": _vec3(b.get("b"), (1, 1, 1))},
                int(b.get("material_id", b.get("material", 0))),
                _parse_medium(b, textures, materials, errors),
            )
        )
    return prims


def _validate_references(textures: list[dict], materials: list[dict],
                         prims: list, errors: list[str]) -> None:
    """Loud rejection at the supported-scope edges (VERDICT r3 item 8).

    The reference loader prints and *skips* bad entries
    (src/Serialize.cpp:102-104); silently dropping or mis-rendering is
    worse than failing, so every dangling index — and the one construct
    that can never compile here, a CYCLIC checker child graph (which would
    recurse forever in the reference too, Texture.cpp:7-11) — raises
    SceneError. Checkers nesting to any FINITE depth are fully supported
    on every backend (the kernels re-resolve one level per nesting
    level; see ops/pallas/megakernel._shade_advance)."""
    n_tex = len(textures)
    n_mat = len(materials)
    for i, t in enumerate(textures):
        if t["type"] != "checker":
            continue
        for side in ("even", "odd"):
            c = t[side]
            if not (0 <= c < n_tex):
                errors.append(
                    f"texture {i}: checker {side}_tex_idx {c} out of range "
                    f"(have {n_tex} textures)")
    # Checkers nest to arbitrary FINITE depth (reference recursion,
    # Texture.cpp:7-11) — but a cyclic child graph would recurse forever
    # there and cannot be compiled here; reject it loudly.
    state = {}  # 0 in-progress, 1 done

    def visit(i):
        if state.get(i) == 1:
            return True
        if state.get(i) == 0:
            return False
        state[i] = 0
        ok = True
        if textures[i]["type"] == "checker":
            for side in ("even", "odd"):
                c = textures[i][side]
                if 0 <= c < n_tex and not visit(c):
                    ok = False
        state[i] = 1
        return ok

    for i, t in enumerate(textures):
        if t["type"] == "checker" and not visit(i):
            errors.append(
                f"texture {i}: checker children form a CYCLE — the "
                "reference would recurse forever; rejecting")
            break
    for i, m in enumerate(materials):
        tex = m.get("tex")
        if tex is not None and not (0 <= tex < n_tex):
            errors.append(
                f"material {i}: tex_idx {tex} out of range "
                f"(have {n_tex} textures)")
    # max(n_mat, 1): with an EMPTY materials list, parse_scene appends one
    # default gray lambertian after validation ("primitive material indices
    # default to 0"), so index 0 is deliberately valid there; any other
    # dangling index still raises.
    for i, p in enumerate(prims):
        if not (0 <= p.material < max(n_mat, 1)):
            errors.append(
                f"primitive {i}: material index {p.material} out of range "
                f"(have {n_mat} materials)")
        if p.medium is not None and not (0 <= p.medium["material"] < max(n_mat, 1)):
            errors.append(
                f"primitive {i}: constant_medium material index "
                f"{p.medium['material']} out of range (have {n_mat} materials)")


def parse_scene(path: str, data_dir: str | None = None) -> SceneDesc:
    with open(path) as f:
        obj = json.load(f)
    if data_dir is None:
        data_dir = os.path.dirname(os.path.abspath(path))

    errors: list[str] = []
    background = _vec3(obj.get("background_color"), (1, 1, 1))
    camera, dims = _parse_camera(obj.get("camera"), data_dir)
    textures = _parse_textures(obj, errors)
    materials = _parse_materials(obj, textures, errors)

    pjson = obj.get("primitives")
    if isinstance(pjson, dict):
        prims = _parse_primitives_legacy(pjson, textures, materials, errors)
        nodes = [{"primitive": i} for i in range(len(prims))]
    else:
        prims = _parse_primitives_new(pjson or [], textures, materials, errors)
        if "scene" in obj:
            nodes = list(obj["scene"])
        else:
            # The reference would render nothing without graph nodes
            # (src/Serialize.cpp:344-346 iterates a missing key); treating each
            # primitive as a root is the useful generalization make_scene.py
            # applies (make_scene.py:203-204).
            nodes = [{"primitive": i} for i in range(len(prims))]

    _validate_references(textures, materials, prims, errors)
    if errors:
        raise SceneError(f"Failed to parse scene {path}: " + "; ".join(errors))

    if not materials:
        # Primitive material indices default to 0; guarantee a valid row.
        materials.append({"type": defs.MAT_LAMBERTIAN, "albedo": _vec3((0.5, 0.5, 0.5))})

    return SceneDesc(
        textures=textures,
        materials=materials,
        primitives=prims,
        nodes=nodes,
        camera=camera,
        background=background.astype(defs.REAL),
        dims=dims,
    )


# --------------------------------------------------------------------------
# Graph flattening + transform baking
# --------------------------------------------------------------------------


def _make_box_quads(a: np.ndarray, b: np.ndarray) -> list[tuple[np.ndarray, np.ndarray, np.ndarray]]:
    """Expand a box into 6 quads, same construction as MakeBox
    (src/cpu_raytrace/Quad.hpp:34-50)."""
    mn = np.minimum(a, b)
    mx = np.maximum(a, b)
    dx = np.array([mx[0] - mn[0], 0, 0])
    dy = np.array([0, mx[1] - mn[1], 0])
    dz = np.array([0, 0, mx[2] - mn[2]])
    return [
        (np.array([mn[0], mn[1], mx[2]]), dx, dy),    # front
        (np.array([mx[0], mn[1], mx[2]]), -dz, dy),   # right
        (np.array([mx[0], mn[1], mn[2]]), -dx, dy),   # back
        (np.array([mn[0], mn[1], mn[2]]), dz, dy),    # left
        (np.array([mn[0], mx[1], mx[2]]), dx, -dz),   # top
        (np.array([mn[0], mn[1], mn[2]]), dx, dz),    # bottom
    ]


def _is_similarity(m3: np.ndarray, tol: float = 1e-6) -> tuple[bool, float]:
    """True if the 3x3 linear part is rotation × uniform scale."""
    g = m3.T @ m3
    s2 = np.trace(g) / 3.0
    ok = bool(np.allclose(g, np.eye(3) * s2, atol=tol * max(1.0, s2)))
    return ok, math.sqrt(max(s2, 0.0))


def _invert_affine(m4: np.ndarray) -> np.ndarray:
    """[3,4] inverse of an affine 4x4."""
    a = m4[:3, :3]
    t = m4[:3, 3]
    ainv = np.linalg.inv(a)
    out = np.zeros((3, 4))
    out[:, :3] = ainv
    out[:, 3] = -ainv @ t
    return out


def _is_axis_aligned(m3: np.ndarray, tol: float = 1e-9) -> bool:
    """True if the 3x3 linear part is diagonal (axis-aligned scale/flip)."""
    off = m3 - np.diag(np.diag(m3))
    return bool(np.all(np.abs(off) <= tol)) and bool(np.all(np.abs(np.diag(m3)) > 0))


@dataclasses.dataclass
class _Flattener:
    prims: list[PrimDesc]
    spheres: list = dataclasses.field(default_factory=list)
    quads: list = dataclasses.field(default_factory=list)
    media: list = dataclasses.field(default_factory=list)
    # Axis-aligned boxes: kept as records for the megakernel's slab sweep;
    # their quads go into aabox_quads (appended AFTER plain quads so the
    # kernel can sweep the plain prefix only).
    aaboxes: list = dataclasses.field(default_factory=list)
    aabox_quads: list = dataclasses.field(default_factory=list)
    # Spheres under non-similarity transforms (non-uniform scale/shear):
    # carried un-baked with the inverse affine (schema.Ellipsoids).
    ellipsoids: list = dataclasses.field(default_factory=list)

    def emit(self, prim_idx: int, xform: np.ndarray | None) -> None:
        if prim_idx < 0 or prim_idx >= len(self.prims):
            raise SceneError(f"primitive index {prim_idx} out of range")
        p = self.prims[prim_idx]
        m4 = np.eye(4) if xform is None else xform
        a3, t3 = m4[:3, :3], m4[:3, 3]

        if p.medium is not None:
            self._emit_medium(p, m4)
            return

        if p.kind == "sphere":
            ok, s = _is_similarity(a3)
            if not ok:
                # Non-similarity affine (non-uniform scale / shear):
                # un-bakeable — carry the model-space sphere + inverse
                # affine as an ELLIPSOID record (TransformedHittable over
                # a sphere, src/cpu_raytrace/Transform.cpp:75-88; the
                # normal transform is transpose(inverse(model)),
                # Transform.cpp:38).
                self.ellipsoids.append(
                    (
                        p.params["center"],
                        p.params["displacement"],
                        p.params["radius"],
                        _invert_affine(m4),
                        np.linalg.inv(a3).T,
                        p.material,
                    )
                )
                return
            self.spheres.append(
                (
                    a3 @ p.params["center"] + t3,
                    a3 @ p.params["displacement"],
                    p.params["radius"] * s,
                    p.material,
                )
            )
        elif p.kind == "quad":
            q, u, v = p.params["q"], p.params["u"], p.params["v"]
            self.quads.append((a3 @ q + t3, a3 @ u, a3 @ v, p.material))
        elif p.kind == "box":
            if _is_axis_aligned(a3):
                corner_a = a3 @ p.params["a"] + t3
                corner_b = a3 @ p.params["b"] + t3
                self.aaboxes.append(
                    (np.minimum(corner_a, corner_b),
                     np.maximum(corner_a, corner_b), p.material)
                )
                sink = self.aabox_quads
            else:
                sink = self.quads
            for q, u, v in _make_box_quads(p.params["a"], p.params["b"]):
                sink.append((a3 @ q + t3, a3 @ u, a3 @ v, p.material))
        else:  # pragma: no cover
            raise SceneError(f"unknown primitive kind {p.kind}")

    def _emit_medium(self, p: PrimDesc, m4: np.ndarray) -> None:
        inv = _invert_affine(m4)
        if p.kind == "sphere":
            self.media.append(
                (
                    defs.MEDIUM_SPHERE,
                    p.params["center"],
                    np.array([p.params["radius"], 0.0, 0.0]),
                    p.params["displacement"],
                    inv,
                    -1.0 / p.medium["density"],
                    p.medium["material"],
                )
            )
        elif p.kind == "box":
            mn = np.minimum(p.params["a"], p.params["b"])
            mx = np.maximum(p.params["a"], p.params["b"])
            self.media.append(
                (
                    defs.MEDIUM_BOX,
                    mn,
                    mx,
                    np.zeros(3),
                    inv,
                    -1.0 / p.medium["density"],
                    p.medium["material"],
                )
            )
        elif p.kind == "quad":
            # Degenerate by the reference's own semantics: ConstantMedium
            # needs an entry AND an exit hit (ConstantMedium.cpp:14-33),
            # and a flat quad is hit once — the second Hit (from just past
            # the first) misses, so the medium never scatters and the
            # wrapped quad effectively disappears from the render. Parity
            # = emit NOTHING, loudly.
            import sys
            print(
                "warning: constant_medium over a flat quad never scatters "
                "(the reference's two-hit boundary test always fails, "
                "src/cpu_raytrace/ConstantMedium.cpp:14-33); primitive "
                "dropped to match",
                file=sys.stderr,
            )
        else:  # pragma: no cover — parser only emits sphere/quad/box
            raise SceneError(
                f"constant_medium boundary {p.kind!r} cannot be authored "
                "by the reference scene format (Serialize.cpp:287-341: "
                "only sphere, box — the 6-quad convex MakeBox, supported "
                "here incl. transforms via the carried inverse affine — "
                "and flat quads can carry the wrapper)")


def _walk(node: dict, parent: np.ndarray | None, fl: _Flattener) -> None:
    """Flatten one graph node (ParseNode semantics, src/Serialize.cpp:161-197):
    the node's transform applies to its own primitive *and* all children."""
    own = _parse_transform(node)
    if parent is not None and own is not None:
        xform = parent @ own
    else:
        xform = own if own is not None else parent
    if "primitive" in node:
        fl.emit(int(node["primitive"]), xform)
    elif "primitive_idx" in node:
        # Older generator key used by the repo-root test.json.
        fl.emit(int(node["primitive_idx"]), xform)
    for child in node.get("children") or []:
        _walk(child, xform, fl)


def _morton3(p: np.ndarray, bits: int = 10) -> np.ndarray:
    """Morton (Z-order) codes for [N,3] points — spatial sort key so the
    megakernel's sphere clusters are compact (cluster-level skip)."""
    lo = p.min(0)
    ext = np.maximum(p.max(0) - lo, 1e-9)
    q = np.clip(((p - lo) / ext * ((1 << bits) - 1)).astype(np.uint64), 0, (1 << bits) - 1)
    code = np.zeros(len(p), np.uint64)
    for b in range(bits):
        for axis in range(3):
            code |= ((q[:, axis] >> b) & 1) << np.uint64(3 * b + axis)
    return code


def _kd_order(p: np.ndarray, align: int = 16, block: int = 128) -> np.ndarray:
    """Balanced kd-tree ordering for [N,3] points: recursively split on the
    widest axis at a split point rounded to the LARGEST granularity the
    kernel tests at that level — ``block`` (128-record superclusters) while
    the segment exceeds it, falling to ``align`` (16-record clusters) below.

    This is the host-side BVH build the megakernel's cluster hierarchy rides
    on (the reference builds its BVH the same median-split-on-longest-axis
    way, src/cpu_raytrace/BVH.cpp:10-31). Rounding to ``align`` alone is NOT
    enough for the superclusters: a split at e.g. 496 (multiple of 16, not
    of 128) makes the supercluster [384,512) straddle two disjoint kd cells
    and its AABB balloon, so _hier_sweep's L2 skips stop firing. With
    block-granular splits above ``block``, every aligned 128-block AND every
    aligned 16-block is one contiguous kd cell."""
    order = np.arange(len(p), dtype=np.int64)

    def rec(ids):
        n = len(ids)
        if n <= align:
            return ids
        ext = p[ids].max(0) - p[ids].min(0)
        axis = int(np.argmax(ext))
        ids = ids[np.argsort(p[ids, axis], kind="stable")]
        unit = align
        while unit * 2 <= block and unit * 2 < n:
            unit *= 2
        k = max(unit, min(round(n / 2 / unit) * unit, (n - 1) // unit * unit))
        if k >= n:
            k = (n - 1) // align * align or align
        return np.concatenate([rec(ids[:k]), rec(ids[k:])])

    return rec(order)


def flatten(desc: SceneDesc, seed: int = 0, pad: bool = True) -> schema.FlatScene:
    """Compile a parsed scene into the padded SoA pytree (host numpy)."""
    fl = _Flattener(desc.primitives)
    for node in desc.nodes:
        _walk(node, None, fl)

    # Spatially sort spheres and AA boxes (closest-hit is order-independent;
    # the megakernel's cluster-skip wants compact clusters).
    if len(fl.spheres) > 2:
        centers = np.array([s[0] for s in fl.spheres], np.float64).reshape(-1, 3)
        order = _kd_order(centers)
        fl.spheres = [fl.spheres[i] for i in order]
    if len(fl.aaboxes) > 2:
        centers = np.array(
            [(b[0] + b[1]) * 0.5 for b in fl.aaboxes], np.float64
        ).reshape(-1, 3)
        order = _kd_order(centers)
        fl.aaboxes = [fl.aaboxes[i] for i in order]

    def round_up(n: int, m: int = 8) -> int:
        return max(((n + m - 1) // m) * m, m) if pad else max(n, 1)

    if fl.spheres:
        c0, disp, rad, mat = zip(*fl.spheres)
    else:
        c0, disp, rad, mat = [], [], [], []
    spheres = schema.make_spheres(
        np.array(c0, np.float64).reshape(-1, 3),
        np.array(disp, np.float64).reshape(-1, 3),
        np.array(rad, np.float64).reshape(-1),
        np.array(mat, np.int64).reshape(-1),
        pad_to=round_up(len(fl.spheres)),
    )

    all_quads = fl.quads + fl.aabox_quads
    if all_quads:
        qq, qu, qv, qmat = zip(*all_quads)
    else:
        qq, qu, qv, qmat = [], [], [], []
    quads = schema.make_quads(
        np.array(qq, np.float64).reshape(-1, 3),
        np.array(qu, np.float64).reshape(-1, 3),
        np.array(qv, np.float64).reshape(-1, 3),
        np.array(qmat, np.int64).reshape(-1),
        pad_to=round_up(len(all_quads)),
    )

    if fl.aaboxes:
        bmins, bmaxs, bmats = zip(*fl.aaboxes)
        nb = len(fl.aaboxes)
        tb = round_up(nb)
        bactive = np.zeros(tb, bool)
        bactive[:nb] = True
        boxes = schema.Boxes(
            bmin=schema._pad(np.array(bmins, defs.REAL).reshape(-1, 3), tb),
            bmax=schema._pad(np.array(bmaxs, defs.REAL).reshape(-1, 3), tb),
            material=schema._pad(np.array(bmats, defs.INDEX).reshape(-1), tb),
            active=bactive,
        )
    else:
        boxes = schema.empty_boxes()

    if fl.media:
        mcount = len(fl.media)
        target = max(mcount, 1)
        btype = np.zeros(target, defs.INDEX)
        p0 = np.zeros((target, 3), defs.REAL)
        p1 = np.zeros((target, 3), defs.REAL)
        mdisp = np.zeros((target, 3), defs.REAL)
        inv_model = np.tile(np.hstack([np.eye(3), np.zeros((3, 1))]).astype(defs.REAL), (target, 1, 1))
        nid = np.full(target, -1.0, defs.REAL)
        mmat = np.zeros(target, defs.INDEX)
        active = np.zeros(target, bool)
        for i, (bt, a, b, dsp, inv, nidv, mt) in enumerate(fl.media):
            btype[i], p0[i], p1[i], mdisp[i] = bt, a, b, dsp
            inv_model[i], nid[i], mmat[i], active[i] = inv, nidv, mt, True
        media = schema.Media(btype, p0, p1, mdisp, inv_model, nid, mmat, active)
    else:
        media = schema.empty_media()

    # Materials → SoA.
    K = len(desc.materials)
    mtype = np.zeros(K, defs.INDEX)
    malbedo = np.ones((K, 3), defs.REAL)
    mparam = np.zeros(K, defs.REAL)
    mtex = np.zeros(K, defs.INDEX)
    for i, m in enumerate(desc.materials):
        mtype[i] = m["type"]
        malbedo[i] = m.get("albedo", np.ones(3))
        mparam[i] = m.get("param", 0.0)
        mtex[i] = m.get("tex", 0)
    materials = schema.Materials(mtype, malbedo, mparam, mtex)

    # Textures → SoA (guarantee ≥1 row so gathers are always valid).
    texs = desc.textures or [{"type": "solid", "albedo": np.ones(3)}]
    L = len(texs)
    ttype = np.zeros(L, defs.INDEX)
    talbedo = np.ones((L, 3), defs.REAL)
    tinv_scale = np.ones(L, defs.REAL)
    tscale = np.ones(L, defs.REAL)
    teven = np.zeros(L, defs.INDEX)
    todd = np.zeros(L, defs.INDEX)
    tnoise = np.zeros(L, defs.INDEX)
    perm = np.zeros((L, 3, perlin.POINT_COUNT), defs.INDEX)
    grad = np.zeros((L, perlin.POINT_COUNT, 3), defs.REAL)
    for i, t in enumerate(texs):
        if t["type"] == "solid":
            ttype[i] = defs.TEX_SOLID
            talbedo[i] = t["albedo"]
            perm[i], grad[i] = perlin.identity_tables()
        elif t["type"] == "checker":
            ttype[i] = defs.TEX_CHECKER
            tinv_scale[i] = 1.0 / t["scale"]  # Texture.hpp:20
            teven[i] = t["even"]
            todd[i] = t["odd"]
            perm[i], grad[i] = perlin.identity_tables()
        elif t["type"] == "noise":
            ttype[i] = defs.TEX_NOISE
            talbedo[i] = t["albedo"]
            tscale[i] = t["scale"]
            tnoise[i] = t["noise_type"]
            perm[i], grad[i] = perlin.make_tables(seed, i, perlin.POINT_COUNT)
    textures = schema.Textures(
        ttype, talbedo, tinv_scale, tscale, teven, todd, tnoise, perm, grad
    )

    cam = schema.CameraParams(
        center=np.asarray(desc.camera["center"], defs.REAL),
        look_at=np.asarray(desc.camera["look_at"], defs.REAL),
        vup=np.asarray(desc.camera["vup"], defs.REAL),
        vfov=defs.REAL(desc.camera["fov"]),
        defocus_angle=defs.REAL(desc.camera["defocus_angle"]),
        focus_dist=defs.REAL(desc.camera["focus_distance"]),
    )

    ellipsoids = None
    if fl.ellipsoids:
        e_c0, e_dp, e_rad, e_inv, e_invt, e_mat = zip(*fl.ellipsoids)
        ellipsoids = schema.make_ellipsoids(
            np.array(e_c0), np.array(e_dp), np.array(e_rad),
            np.array(e_inv), np.array(e_invt), np.array(e_mat))

    return schema.FlatScene(
        spheres=spheres,
        quads=quads,
        boxes=boxes,
        media=media,
        materials=materials,
        textures=textures,
        camera=cam,
        background=np.asarray(desc.background, defs.REAL),
        ellipsoids=ellipsoids,
    )


def load_scene(path: str, seed: int = 0, data_dir: str | None = None):
    """Parse + flatten. Returns (FlatScene, dims|None)."""
    desc = parse_scene(path, data_dir=data_dir)
    return flatten(desc, seed=seed), desc.dims


def load_camera_file(path: str) -> schema.CameraParams:
    """Load a standalone camera JSON (e.g. data/cam1.json) —
    serialize::LoadCamera(filepath) (src/Serialize.cpp:42-45). Useful for
    scenes that ship without a camera (the reference aborts on those;
    final_render_book_1.json pairs with cam1.json)."""
    with open(path) as f:
        cam_json = json.load(f)
    cam = {
        "fov": float(cam_json.get("fov", 90)),
        "center": _vec3(cam_json.get("center"), (0, 0, 1)),
        "look_at": _vec3(cam_json.get("look_at"), (0, 0, 0)),
        "defocus_angle": float(cam_json.get("defocus_angle", 0.0)),
        "focus_distance": float(cam_json.get("focus_distance", 1.0)),
    }
    return schema.CameraParams(
        center=np.asarray(cam["center"], defs.REAL),
        look_at=np.asarray(cam["look_at"], defs.REAL),
        vup=np.array([0.0, 1.0, 0.0], defs.REAL),
        vfov=defs.REAL(cam["fov"]),
        defocus_angle=defs.REAL(cam["defocus_angle"]),
        focus_dist=defs.REAL(cam["focus_distance"]),
    )


def write_camera(cam: schema.CameraParams, path: str) -> None:
    """Camera write-back JSON — serialize::WriteCamera (src/Serialize.cpp:47-54)."""
    obj = {
        "fov": float(cam.vfov),
        "center": [float(x) for x in np.asarray(cam.center)],
        "look_at": [float(x) for x in np.asarray(cam.look_at)],
        "defocus_angle": float(cam.defocus_angle),
        "focus_distance": float(cam.focus_dist),
    }
    with open(path, "w") as f:
        json.dump(obj, f, indent=2)
