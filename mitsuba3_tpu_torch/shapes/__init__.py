"""Host-side shape -> triangle-mesh lowering — counterpart of
``mitsuba3_tpu/shapes/__init__.py`` for the in-memory ``mesh``, the
``rectangle`` and the ``cube``.

Shapes become world-space triangle arrays (NumPy, float64) while the scene
dict is lowered; the loader concatenates them into the scene's face table.
Canonical geometry matches the reference plugins: the rectangle is
[-1,1]^2 in the XY plane with a +Z normal (src/shapes/rectangle.cpp), the
cube [-1,1]^3 with outward normals (src/shapes/cube.cpp).
"""
from __future__ import annotations

import numpy as np

from ..core.transform import as_transform

# keys each shape type may carry; any other key names a feature that is
# not ported (uvs or normals of a mesh, vertex colors, media)
SHAPE_KEYS = {
    "mesh": ("type", "vertices", "faces", "bsdf", "emitter", "to_world"),
    "rectangle": ("type", "bsdf", "emitter", "to_world"),
    "cube": ("type", "bsdf", "emitter", "to_world"),
}


class MeshData:
    """Host-side triangle mesh (world space), with optional per-vertex uvs."""

    def __init__(self, vertices: np.ndarray, faces: np.ndarray,
                 uvs: np.ndarray | None = None):
        self.vertices = np.asarray(vertices, np.float64)
        self.faces = np.asarray(faces, np.int32)
        self.uvs = uvs if uvs is None else np.asarray(uvs, np.float64)

    def face_areas(self) -> np.ndarray:
        p = self.vertices[self.faces]
        return 0.5 * np.linalg.norm(
            np.cross(p[:, 1] - p[:, 0], p[:, 2] - p[:, 0]), axis=-1)


def make_rectangle() -> MeshData:
    v = np.array([[-1, -1, 0], [1, -1, 0], [1, 1, 0], [-1, 1, 0]], np.float64)
    f = np.array([[0, 1, 2], [2, 3, 0]], np.int32)
    uv = np.array([[0, 0], [1, 0], [1, 1], [0, 1]], np.float64)
    return MeshData(v, f, uv)


def make_cube() -> MeshData:
    # 24 vertices (4 per face) so uvs stay per-face-consistent
    verts, faces, uvs = [], [], []
    for ax, u_ax, v_ax in ((0, 1, 2), (1, 2, 0), (2, 0, 1)):
        for sgn in (1.0, -1.0):
            base = len(verts)
            for uu, vv in ((-1, -1), (1, -1), (1, 1), (-1, 1)):
                p = np.zeros(3)
                p[ax] = sgn
                p[u_ax] = uu * sgn  # winding flips with the face sign
                p[v_ax] = vv
                verts.append(p)
                uvs.append([(uu + 1) / 2, (vv + 1) / 2])
            faces.append([base, base + 1, base + 2])
            faces.append([base + 2, base + 3, base])
    return MeshData(np.array(verts), np.array(faces, np.int32), np.array(uvs))


def build_shape(spec: dict) -> MeshData:
    """Lower a scene-dict shape spec to a world-space MeshData."""
    stype = spec["type"]
    if stype not in SHAPE_KEYS:
        raise NotImplementedError(f"shape type {stype!r} is not ported")
    extra = sorted(set(spec) - set(SHAPE_KEYS[stype]))
    if extra:
        raise NotImplementedError(
            f"{stype} properties {extra} are not ported (a {stype} takes "
            f"{', '.join(SHAPE_KEYS[stype][1:])})")
    if stype == "rectangle":
        mesh = make_rectangle()
    elif stype == "cube":
        mesh = make_cube()
    else:
        mesh = MeshData(np.asarray(spec["vertices"], np.float64),
                        np.asarray(spec["faces"], np.int64))
    if spec.get("to_world") is not None:
        mesh = MeshData(as_transform(spec["to_world"]).transform_point(
            mesh.vertices), mesh.faces, mesh.uvs)
    return mesh
