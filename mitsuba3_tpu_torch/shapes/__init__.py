"""Host-side shape -> triangle-mesh lowering — counterpart of
``mitsuba3_tpu/shapes/__init__.py`` for the in-memory ``mesh`` (with
optional per-vertex uvs, normals and colors), the ``rectangle``, the
``cube``, the mesh files ``obj``, ``ply`` and ``serialized`` (``loaders.py``,
``serialized_io.py``), the ``sphere``, ``disk`` and ``cylinder``
tessellations that the JAX loader falls back to when it cannot make the
shape analytic (an emitter attached, ``flip_normals``, or a to_world that
is not rigid with a uniform scale; ``analytic`` says which), and the
``linearcurve`` and ``bsplinecurve`` tubes where the JAX loader
tessellates curves (``curves.tessellated``). The analytic shapes and
curves themselves are not ported.

Shapes become world-space triangle arrays (NumPy, float64) while the scene
dict is lowered; the loader concatenates them into the scene's face table.
Canonical geometry matches the reference plugins: the rectangle is
[-1,1]^2 in the XY plane with a +Z normal (src/shapes/rectangle.cpp), the
cube [-1,1]^3 with outward normals (src/shapes/cube.cpp), the sphere a
32 x 64 lat-long unit sphere, the disk a 64-gon in the XY plane, the
cylinder an open 64-gon tube of unit radius over z in [0, 1]. As in the
JAX package, ``flip_normals`` flips nothing.
"""
from __future__ import annotations

import numpy as np

from ..core.transform import Transform4f, as_transform

# keys each shape type may carry; any other key names a feature that is
# not ported (obj's flip_tex_coords among them). The media keys are the
# loader's: build_shape reads only the geometry
_COMMON = ("type", "bsdf", "emitter", "to_world", "interior", "exterior",
           "interior_medium", "exterior_medium")
_CURVE = ("filename", "control_points", "segment_indices", "n_sides",
          "subdiv", "tessellate")
SHAPE_KEYS = {
    "mesh": _COMMON + ("vertices", "faces", "uvs", "normals",
                       "vertex_colors"),
    "rectangle": _COMMON,
    "cube": _COMMON,
    "obj": _COMMON + ("filename",),
    "ply": _COMMON + ("filename",),
    "serialized": _COMMON + ("filename", "shape_index"),
    "sphere": _COMMON + ("center", "radius", "flip_normals"),
    "disk": _COMMON + ("flip_normals",),
    "cylinder": _COMMON + ("radius", "p0", "p1", "flip_normals"),
    "linearcurve": _COMMON + _CURVE,
    "bsplinecurve": _COMMON + _CURVE,
}
IMPLICIT = ("sphere", "disk", "cylinder")


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


def make_sphere_mesh(subdiv_theta: int = 32,
                     subdiv_phi: int = 64) -> MeshData:
    """Lat-long triangulated unit sphere, its vertices as normals."""
    th = np.linspace(0.0, np.pi, subdiv_theta + 1)
    ph = np.linspace(0.0, 2 * np.pi, subdiv_phi, endpoint=False)
    tt, pp = np.meshgrid(th, ph, indexing="ij")
    verts = np.stack([np.sin(tt) * np.cos(pp), np.sin(tt) * np.sin(pp),
                      np.cos(tt)], axis=-1).reshape(-1, 3)
    faces = []
    for i in range(subdiv_theta):
        for j in range(subdiv_phi):
            a = i * subdiv_phi + j
            b = i * subdiv_phi + (j + 1) % subdiv_phi
            c = (i + 1) * subdiv_phi + j
            d = (i + 1) * subdiv_phi + (j + 1) % subdiv_phi
            if i > 0:
                faces.append([a, c, b])
            if i < subdiv_theta - 1:
                faces.append([b, c, d])
    return MeshData(verts, np.array(faces, np.int32), normals=verts.copy())


def make_disk(subdiv: int = 64) -> MeshData:
    """Unit disk in the XY plane, +Z normal (src/shapes/disk.cpp); uv is
    polar (r, phi / 2pi) like the reference parameterization."""
    angles = np.linspace(0.0, 2 * np.pi, subdiv, endpoint=False)
    verts = [np.zeros(3)] + [[np.cos(a), np.sin(a), 0.0] for a in angles]
    uvs = [[0.0, 0.0]] + [[1.0, a / (2 * np.pi)] for a in angles]
    faces = [[0, 1 + i, 1 + (i + 1) % subdiv] for i in range(subdiv)]
    n = np.tile([0.0, 0.0, 1.0], (len(verts), 1))
    return MeshData(np.array(verts), np.array(faces, np.int32),
                    np.array(uvs), n)


def make_cylinder(subdiv: int = 64) -> MeshData:
    """Open cylinder: unit radius, z in [0, 1], outward normals
    (src/shapes/cylinder.cpp canonical frame)."""
    angles = np.linspace(0.0, 2 * np.pi, subdiv, endpoint=False)
    ring = np.stack([np.cos(angles), np.sin(angles)], axis=-1)
    zeros, ones = np.zeros((subdiv, 1)), np.ones((subdiv, 1))
    verts = np.concatenate([np.concatenate([ring, zeros], -1),
                            np.concatenate([ring, ones], -1)], 0)
    normals = np.concatenate([np.concatenate([ring, zeros], -1)] * 2, 0)
    u = angles / (2 * np.pi)
    uvs = np.concatenate([np.stack([u, np.zeros(subdiv)], -1),
                          np.stack([u, np.ones(subdiv)], -1)], 0)
    faces = []
    for i in range(subdiv):
        j = (i + 1) % subdiv
        faces.append([i, j, subdiv + i])
        faces.append([j, subdiv + j, subdiv + i])
    return MeshData(verts, np.array(faces, np.int32), uvs, normals)


def _uniform_scale(spec: dict):
    """(4x4 matrix, scale) of the shape's to_world if its columns have one
    length, else None (the JAX loader's scale test)."""
    tw = spec.get("to_world")
    m = np.eye(4) if tw is None else np.asarray(as_transform(tw).matrix,
                                                np.float64)
    lens = np.linalg.norm(m[:3, :3], axis=0)
    s = float(lens.mean())
    if s <= 0 or np.abs(lens - s).max() > 1e-5 * max(s, 1e-6):
        return None
    return m, s


def analytic(spec: dict) -> bool:
    """True where the JAX loader makes a sphere, disk or cylinder an
    analytic primitive (``_try_analytic``: no emitter, no
    ``flip_normals``, a rigid uniform-scale to_world, a cylinder of
    nonzero length): those are not ported. The others are tessellated
    here as there."""
    if spec.get("type") not in IMPLICIT or spec.get("emitter") is not None \
            or spec.get("flip_normals"):
        return False
    fit = _uniform_scale(spec)
    if fit is None:
        return False
    m, s = fit
    rot = m[:3, :3] / s
    if np.abs(rot.T @ rot - np.eye(3)).max() > 1e-4:
        return False
    if spec["type"] == "cylinder":
        p0 = np.asarray(spec.get("p0", [0, 0, 0]), np.float64)
        p1 = np.asarray(spec.get("p1", [0, 0, 1]), np.float64)
        return bool(np.linalg.norm(m[:3, :3] @ (p1 - p0)) > 0)
    return True


def sphere_center_radius(spec: dict):
    """World-space (cx, cy, cz, r) float32 of a sphere under a
    uniform-scale to_world, else None (JAX's ``_sphere_center_radius``:
    the scale test only)."""
    fit = _uniform_scale(spec) if spec.get("type") == "sphere" else None
    if fit is None:
        return None
    m, s = fit
    c = m[:3, :3] @ np.asarray(spec.get("center", [0, 0, 0]),
                               np.float64) + m[:3, 3]
    return np.asarray([c[0], c[1], c[2], s * float(spec.get("radius", 1.0))],
                      np.float32)


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
    if analytic(spec):
        raise NotImplementedError(
            f"an analytic {stype!r} shape (no emitter, no flip_normals, a "
            f"rigid uniform-scale to_world) is not ported to "
            f"mitsuba3_tpu_torch: ROADMAP queue 1 item 5 (ops/analytic.py)")
    if stype in ("linearcurve", "bsplinecurve"):
        from . import curves
        if not curves.tessellated(spec):
            raise NotImplementedError(
                f"a {stype} of at most {curves.MAX_CONES} round cones, no "
                f"emitter and no tessellate (analytic in the JAX package) "
                f"is not ported to mitsuba3_tpu_torch: ROADMAP queue 1 "
                f"item 5 (ops/analytic.py)")
        mesh = curves.build_curve_mesh(spec, stype == "bsplinecurve")
    elif stype == "rectangle":
        mesh = make_rectangle()
    elif stype == "cube":
        mesh = make_cube()
    elif stype == "disk":
        mesh = make_disk()
    elif stype == "cylinder":
        mesh = make_cylinder()
        r = float(spec.get("radius", 1.0))
        p0 = np.asarray(spec.get("p0", [0, 0, 0]), np.float64)
        axis = np.asarray(spec.get("p1", [0, 0, 1]), np.float64) - p0
        length = np.linalg.norm(axis)
        if length > 0:
            z = axis / length
            x = np.cross([0.0, 1.0, 0.01], z)
            x /= max(np.linalg.norm(x), 1e-12)
            y = np.cross(z, x)
            m = np.eye(4)
            m[:3, 0], m[:3, 1], m[:3, 2], m[:3, 3] = (x * r, y * r,
                                                      z * length, p0)
            mesh = mesh.transformed(Transform4f(m))
    elif stype == "sphere":
        mesh = make_sphere_mesh()
        center, radius = spec.get("center"), spec.get("radius")
        if center is not None or radius is not None:
            mesh = mesh.transformed(Transform4f().translate(
                center or [0, 0, 0]).scale(radius or 1.0))
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
