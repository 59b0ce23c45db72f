"""Host-side shape lowering — counterpart of
``mitsuba3_tpu/shapes/__init__.py`` for the in-memory ``mesh`` (with
optional per-vertex uvs, normals and colors), the ``rectangle``, the
``cube``, the mesh files ``obj``, ``ply`` and ``serialized``
(``loaders.py``, ``serialized_io.py``), the ``sphere``, ``disk`` and
``cylinder``, the ``linearcurve`` and ``bsplinecurve`` (``curves.py``) and
the ``ellipsoidsmesh`` shell cloud (``make_ellipsoids_mesh``).

A sphere, disk or cylinder with no emitter, no ``flip_normals`` and a
rigid uniform-scale to_world becomes an analytic row
(``analytic_row``, JAX's ``_try_analytic``; ``ops/analytic.py``); the
others, and every one inside a shapegroup, are tessellated here as in
JAX. Shapes become world-space triangle arrays (NumPy, float64) while the
scene dict is lowered; the loader concatenates them into the scene's face
table. Canonical geometry matches the reference plugins: the rectangle is
[-1,1]^2 in the XY plane with a +Z normal (src/shapes/rectangle.cpp), the
cube [-1,1]^3 with outward normals (src/shapes/cube.cpp), the sphere a
32 x 64 lat-long unit sphere, the disk a 64-gon in the XY plane, the
cylinder an open 64-gon tube of unit radius over z in [0, 1]. As in the
JAX package, a tessellated shape's ``flip_normals`` flips nothing.
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
    "ellipsoidsmesh": _COMMON + ("centers", "means", "scales", "quaternions",
                                 "quats", "colors", "extent", "shell"),
    # the loader's: a grid or a .vol file in the to_world-mapped unit cube
    "sdfgrid": ("type", "bsdf", "to_world", "interior", "exterior",
                "interior_medium", "exterior_medium", "grid", "filename"),
}
IMPLICIT = ("sphere", "disk", "cylinder")
N_ANALYTIC_COLS = 24   # ops/analytic.py's row width


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


def analytic_row(spec: dict):
    """A sphere, disk or cylinder as an analytic row [N_ANALYTIC_COLS]
    float32 (ops/analytic.py's layout, slots 15-19 left 0), or None where
    JAX's ``_try_analytic`` tessellates it: an emitter, ``flip_normals``,
    a to_world that is not rigid with a uniform scale, or a cylinder of
    zero length."""
    st = spec.get("type")
    if st not in IMPLICIT or spec.get("emitter") is not None \
            or spec.get("flip_normals"):
        return None
    fit = _uniform_scale(spec)
    if fit is None:
        return None
    m, s = fit
    rot = m[:3, :3] / s
    if np.abs(rot.T @ rot - np.eye(3)).max() > 1e-4:
        return None
    row = np.zeros(N_ANALYTIC_COLS, np.float32)
    if st == "sphere":
        c = m[:3, :3] @ np.asarray(spec.get("center", [0, 0, 0]),
                                   np.float64) + m[:3, 3]
        row[1:4] = c
        row[4:7] = rot[:, 2]
        row[7] = s * float(spec.get("radius", 1.0))
        row[9:12] = rot[:, 0]
        row[12:15] = rot[:, 1]
    elif st == "disk":
        row[0] = 1
        row[1:4] = m[:3, 3]
        row[4:7] = rot[:, 2]
        row[7] = s
        row[9:12] = rot[:, 0]
        row[12:15] = rot[:, 1]
    else:
        p0 = np.asarray(spec.get("p0", [0, 0, 0]), np.float64)
        p1 = np.asarray(spec.get("p1", [0, 0, 1]), np.float64)
        axis = m[:3, :3] @ (p1 - p0)
        length = np.linalg.norm(axis)
        if length <= 0:
            return None
        z = axis / length
        x = np.cross([0.0, 1.0, 0.01], z)
        nx = np.linalg.norm(x)
        if nx < 1e-9:
            x = np.cross([1.0, 0.0, 0.0], z)
            nx = np.linalg.norm(x)
        x /= nx
        row[0] = 2
        row[1:4] = m[:3, :3] @ p0 + m[:3, 3]
        row[4:7] = z
        row[7] = s * float(spec.get("radius", 1.0))
        row[8] = length
        row[9:12] = x
        row[12:15] = np.cross(z, x)
    return row


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


def check_keys(spec: dict):
    """Refuse a shape type or a property the port does not carry."""
    stype = spec["type"]
    if stype not in SHAPE_KEYS:
        raise NotImplementedError(f"shape type {stype!r} is not ported")
    extra = sorted(set(spec) - set(SHAPE_KEYS[stype]))
    if extra:
        raise NotImplementedError(
            f"{stype} properties {extra} are not ported (a {stype} takes "
            f"{', '.join(SHAPE_KEYS[stype][1:])})")


def build_shape(spec: dict) -> MeshData:
    """Lower a scene-dict shape spec to a world-space MeshData, as JAX's
    ``build_shape`` does: a sphere, disk, cylinder or curve set is
    tessellated whatever the loader would make of it."""
    check_keys(spec)
    stype = spec["type"]
    if stype == "sdfgrid":
        raise ValueError(f"Unsupported shape type: {stype}")
    if stype in ("linearcurve", "bsplinecurve"):
        from . import curves
        mesh = curves.build_curve_mesh(spec, stype == "bsplinecurve")
    elif stype == "ellipsoidsmesh":
        mesh = make_ellipsoids_mesh(spec)
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


def _quat_to_rot(q: np.ndarray) -> np.ndarray:
    """[N, 4] (w, x, y, z) unit quaternions -> [N, 3, 3] rotations."""
    q = q / np.maximum(np.linalg.norm(q, axis=1, keepdims=True), 1e-12)
    w, x, y, z = q[:, 0], q[:, 1], q[:, 2], q[:, 3]
    return np.stack([
        np.stack([1 - 2 * (y * y + z * z), 2 * (x * y - w * z),
                  2 * (x * z + w * y)], -1),
        np.stack([2 * (x * y + w * z), 1 - 2 * (x * x + z * z),
                  2 * (y * z - w * x)], -1),
        np.stack([2 * (x * z - w * y), 2 * (y * z + w * x),
                  1 - 2 * (x * x + y * y)], -1)], 1)


def make_ellipsoids_mesh(spec: dict) -> MeshData:
    """The ellipsoid cloud's shell geometry (src/shapes/ellipsoidsmesh.cpp):
    one shell mesh per ellipsoid with its extent-scaled transform baked,
    per-vertex colors carrying the primitive's color (rendered through a
    mesh_attribute reflectance). Shells: ``default``, ``ico_sphere`` and
    ``uv_sphere`` (a 6 x 8 lat-long sphere) or ``box`` (the cube)."""
    centers = np.asarray(spec.get("centers", spec.get("means")), np.float64)
    n = centers.shape[0]
    scales = np.asarray(spec.get("scales", np.full((n, 3), 0.1)),
                        np.float64).reshape(n, -1)
    if scales.shape[1] == 1:
        scales = np.tile(scales, (1, 3))
    quats = np.asarray(spec.get("quaternions", spec.get(
        "quats", np.tile([1.0, 0, 0, 0], (n, 1)))), np.float64)
    colors = np.asarray(spec.get("colors", np.full((n, 3), 0.5)), np.float64)
    extent = float(spec.get("extent", 3.0))
    shell = spec.get("shell", "default")
    if shell in ("default", "ico_sphere", "uv_sphere"):
        proto = make_sphere_mesh(subdiv_theta=6, subdiv_phi=8)
    elif shell == "box":
        proto = make_cube()
    else:
        raise ValueError(f"Unsupported shell type {shell!r}")
    pv, pf = proto.vertices, proto.faces
    lin = _quat_to_rot(quats) * (scales * extent)[:, None, :]   # R diag(se)
    verts = np.einsum("nij,vj->nvi", lin, pv) + centers[:, None, :]
    nv = pv.shape[0]
    faces = pf[None, :, :] + (np.arange(n) * nv)[:, None, None]
    normals = None
    if proto.normals is not None:
        # normals by the inverse transpose of the linear part
        it = np.linalg.inv(lin).transpose(0, 2, 1)
        nrm = np.einsum("nij,vj->nvi", it, proto.normals)
        nrm /= np.maximum(np.linalg.norm(nrm, axis=-1, keepdims=True),
                          1e-12)
        normals = nrm.reshape(-1, 3)
    uvs = np.tile(proto.uvs, (n, 1)) if proto.uvs is not None else None
    return MeshData(verts.reshape(-1, 3), faces.reshape(-1, 3), uvs=uvs,
                    normals=normals,
                    colors=np.repeat(colors[:, None, :], nv,
                                     axis=1).reshape(-1, 3))
