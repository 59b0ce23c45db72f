"""Mesh file loaders — counterpart of ``mitsuba3_tpu/shapes/loaders.py``
(src/shapes/{obj,ply}.cpp).

Host-side NumPy parsing while a scene is lowered. OBJ: v, vt, vn and f
with fan triangulation and negative indices; a corner is split on its
unique ``v/vt/vn`` spec string; texture coordinates are not flipped;
normals that are all zero are dropped. PLY: ascii and
binary_little_endian, the ``vertex`` element's x y z [nx ny nz]
[u v | s t | texture_u texture_v] and the ``face`` element's index list.
The arrays equal the JAX loaders': float64 vertices, normals and uvs,
int32 faces, in the same order.
"""
from __future__ import annotations

import numpy as np

from . import MeshData

# PLY property type -> little-endian numpy type
PLY_TYPES = {"float": "<f4", "float32": "<f4", "double": "<f8",
             "uchar": "u1", "uint8": "u1", "char": "i1", "short": "<i2",
             "ushort": "<u2", "int": "<i4", "int32": "<i4", "uint": "<u4",
             "uint32": "<u4"}


def load_obj(filename: str):
    """Returns (vertices [V,3], faces [F,3], uvs [V,2] | None,
    normals [V,3] | None)."""
    positions, texcoords, normals = [], [], []
    corner_map = {}
    out_pos, out_uv, out_n = [], [], []
    faces = []

    def index(text, items):
        k = int(text)
        return k - 1 if k > 0 else len(items) + k

    def corner(spec: str):
        if spec in corner_map:
            return corner_map[spec]
        parts = (spec.split("/") + ["", ""])[:3]
        out_pos.append(positions[index(parts[0], positions)])
        out_uv.append(texcoords[index(parts[1], texcoords)] if parts[1]
                      else (0.0, 0.0))
        out_n.append(normals[index(parts[2], normals)] if parts[2]
                     else (0.0, 0.0, 0.0))
        corner_map[spec] = len(out_pos) - 1
        return corner_map[spec]

    with open(filename, "r", errors="replace") as f:
        for line in f:
            if line.startswith("v "):
                positions.append(tuple(map(float, line.split()[1:4])))
            elif line.startswith("vt "):
                vals = line.split()[1:3]
                texcoords.append((float(vals[0]),
                                  float(vals[1]) if len(vals) > 1 else 0.0))
            elif line.startswith("vn "):
                normals.append(tuple(map(float, line.split()[1:4])))
            elif line.startswith("f "):
                corners = [corner(s) for s in line.split()[1:]]
                for k in range(1, len(corners) - 1):  # fan triangulation
                    faces.append((corners[0], corners[k], corners[k + 1]))

    v = np.asarray(out_pos, np.float64)
    fc = np.asarray(faces, np.int32)
    uv = np.asarray(out_uv, np.float64) if texcoords else None
    nn = np.asarray(out_n, np.float64) if normals else None
    if nn is not None and not np.abs(nn).sum():
        nn = None
    return v, fc, uv, nn


def _ply_header(f):
    """(format, [[name, count, [(type, name) | ('list', ctype, itype,
    name)]]]) of an open PLY file, positioned after end_header."""
    if f.readline().strip() != b"ply":
        raise ValueError("not a PLY file")
    fmt, elements = None, []
    while True:
        line = f.readline()
        if not line:
            raise ValueError("PLY header has no end_header")
        line = line.decode("ascii", "replace").strip()
        if line.startswith("format"):
            fmt = line.split()[1]
        elif line.startswith("element"):
            _, name, cnt = line.split()
            elements.append([name, int(cnt), []])
        elif line.startswith("property"):
            parts = line.split()
            elements[-1][2].append(tuple(parts[1:5]) if parts[1] == "list"
                                   else (parts[1], parts[2]))
        elif line == "end_header":
            return fmt, elements


def _fan(idx):
    """Fan-triangulate [F, n] polygon indices, face by face."""
    n = idx.shape[1]
    tris = [np.stack([idx[:, 0], idx[:, k], idx[:, k + 1]], axis=1)
            for k in range(1, n - 1)]
    return np.stack(tris, axis=1).reshape(-1, 3)


def _binary_faces(f, count: int, ctype: str, itype: str):
    """The face element's triangles: read at once when every face has the
    first face's corner count, else face by face."""
    cdt, idt = np.dtype(PLY_TYPES[ctype]), np.dtype(PLY_TYPES[itype])
    start = f.tell()
    n0 = int(np.frombuffer(f.read(cdt.itemsize), cdt)[0]) if count else 0
    f.seek(start)
    row = np.dtype([("n", cdt), ("idx", idt, (n0,))])
    buf = f.read(row.itemsize * count)
    if len(buf) == row.itemsize * count:
        rows = np.frombuffer(buf, row, count=count)
        if (rows["n"] == n0).all():
            return _fan(rows["idx"].astype(np.int64)) if n0 >= 3 \
                else np.zeros((0, 3), np.int64)
    f.seek(start)
    faces = []
    for _ in range(count):
        n = int(np.frombuffer(f.read(cdt.itemsize), cdt)[0])
        idx = np.frombuffer(f.read(idt.itemsize * n), idt).astype(np.int64)
        faces.extend((idx[0], idx[k], idx[k + 1]) for k in range(1, n - 1))
    return np.asarray(faces, np.int64).reshape(-1, 3)


def load_ply(filename: str):
    """Returns (vertices [V,3], faces [F,3], uvs [V,2] | None,
    normals [V,3] | None)."""
    with open(filename, "rb") as f:
        fmt, elements = _ply_header(f)
        verts, vprops, faces = None, [], []
        for name, count, props in elements:
            if name == "vertex":
                vprops = [p[1] for p in props]
                if fmt == "ascii":
                    rows = [f.readline().split() for _ in range(count)]
                    verts = np.asarray(rows, np.float64).reshape(
                        count, len(props))
                else:
                    dt = np.dtype([(f"c{i}", PLY_TYPES[p[0]])
                                   for i, p in enumerate(props)])
                    rec = np.frombuffer(f.read(dt.itemsize * count), dt,
                                        count=count)
                    verts = np.stack([rec[f"c{i}"].astype(np.float64)
                                      for i in range(len(props))], axis=1)
            elif name == "face":
                lp = props[0]
                if fmt == "ascii":
                    for _ in range(count):
                        vals = list(map(int, f.readline().split()))
                        idx = vals[1:1 + vals[0]]
                        for k in range(1, len(idx) - 1):
                            faces.append((idx[0], idx[k], idx[k + 1]))
                else:
                    faces = _binary_faces(f, count, lp[1], lp[2])

    cols = {p: i for i, p in enumerate(vprops)}
    v = verts[:, [cols["x"], cols["y"], cols["z"]]]
    nn = verts[:, [cols["nx"], cols["ny"], cols["nz"]]] if "nx" in cols \
        else None
    uv = None
    for ux, vx in (("u", "v"), ("s", "t"), ("texture_u", "texture_v")):
        if ux in cols:
            uv = verts[:, [cols[ux], cols[vx]]]
            break
    return v, np.asarray(faces, np.int32).reshape(-1, 3), uv, nn


def load_mesh_file(filename: str, kind: str) -> MeshData:
    if kind == "obj" or filename.endswith(".obj"):
        v, fc, uv, nn = load_obj(filename)
    elif kind == "ply" or filename.endswith(".ply"):
        v, fc, uv, nn = load_ply(filename)
    else:
        raise ValueError(f"Unsupported mesh format: {filename}")
    return MeshData(v, fc, uv, nn)
