"""Host-side shape -> triangle-mesh lowering — counterpart of
``mitsuba3_tpu/shapes/__init__.py`` for the in-memory ``mesh`` (with
optional per-vertex uvs, normals and colors), the ``rectangle``, the
``cube`` and the mesh files ``obj``, ``ply`` and ``serialized`` (``loaders.py``,
``serialized_io.py``).

Shapes become world-space triangle arrays (NumPy, float64) while the scene
dict is lowered; the loader concatenates them into the scene's face table.
Canonical geometry matches the reference plugins: the rectangle is
[-1,1]^2 in the XY plane with a +Z normal (src/shapes/rectangle.cpp), the
cube [-1,1]^3 with outward normals (src/shapes/cube.cpp).
"""
from __future__ import annotations

import numpy as np

from ..core.transform import Transform4f, as_transform

# keys each shape type may carry; any other key names a feature that is
# not ported (obj's flip_tex_coords among them). The media keys are the
# loader's: build_shape reads only the geometry
_COMMON = ("type", "bsdf", "emitter", "to_world", "interior", "exterior",
           "interior_medium", "exterior_medium")
SHAPE_KEYS = {
    "mesh": _COMMON + ("vertices", "faces", "uvs", "normals",
                       "vertex_colors"),
    "rectangle": _COMMON,
    "cube": _COMMON,
    "obj": _COMMON + ("filename",),
    "ply": _COMMON + ("filename",),
    "serialized": _COMMON + ("filename", "shape_index"),
}


class MeshData:
    """Host-side triangle mesh (world space), with optional per-vertex uvs,
    shading normals and colors."""

    def __init__(self, vertices: np.ndarray, faces: np.ndarray,
                 uvs: np.ndarray | None = None,
                 normals: np.ndarray | None = None,
                 colors: np.ndarray | None = None):
        self.vertices = np.asarray(vertices, np.float64)
        self.faces = np.asarray(faces, np.int32)
        self.uvs = uvs if uvs is None else np.asarray(uvs, np.float64)
        self.normals = (normals if normals is None
                        else np.asarray(normals, np.float64))
        self.colors = (colors if colors is None
                       else np.asarray(colors, np.float64))

    def transformed(self, t: Transform4f) -> "MeshData":
        """The mesh under `t`: points by the matrix, normals by its
        inverse transpose, renormalised."""
        n = None
        if self.normals is not None:
            n = t.transform_normal(self.normals)
            n = n / np.maximum(np.linalg.norm(n, axis=-1, keepdims=True),
                               1e-20)
        return MeshData(t.transform_point(self.vertices), self.faces,
                        self.uvs, n, self.colors)

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
    elif stype in ("obj", "ply"):
        from .loaders import load_mesh_file
        mesh = load_mesh_file(spec["filename"], stype)
    elif stype == "serialized":
        from .serialized_io import read_serialized
        m = read_serialized(spec["filename"], int(spec.get("shape_index", 0)))
        mesh = MeshData(m["vertices"], m["faces"], uvs=m.get("uvs"),
                        normals=m.get("normals"), colors=m.get("colors"))
    else:
        def opt(key):
            return np.asarray(spec[key], np.float64) if key in spec else None
        mesh = MeshData(np.asarray(spec["vertices"], np.float64),
                        np.asarray(spec["faces"], np.int64),
                        uvs=opt("uvs"), normals=opt("normals"),
                        colors=opt("vertex_colors"))
    if spec.get("to_world") is not None:
        mesh = mesh.transformed(as_transform(spec["to_world"]))
    return mesh
