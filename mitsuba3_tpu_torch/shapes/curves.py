"""Curve shapes — the port's copy of ``mitsuba3_tpu/shapes/curves.py``
(``linearcurve`` and ``bsplinecurve``).

The JAX loader lowers a curve set to analytic round cones
(``curve_cone_rows``, ops/analytic.py type 3: the exact swept-sphere
surface per sub-segment) when it has at most MAX_CONES cones, no emitter
and no ``tessellate``. Every other curve set, hair-scale inputs among
them, becomes a swept-tube triangle mesh (``build_curve_mesh``):
parallel-transported frames, ``n_sides``-gon cross sections, per-point
radii, B-splines sampled ``subdiv`` times per span. As in JAX, the cone
rows ignore a ``to_world``; the tubes take it.

UV convention for the hair BSDF: uv.x is the arc-length parameter, uv.y
= (sin(ring angle) + 1) / 2, so that h = 2 uv.y - 1 spans the fiber's
cross-section.

File format (linearcurve.cpp:195-250): text lines ``x y z radius``; blank
lines separate curves.
"""
from __future__ import annotations

import numpy as np

MAX_CONES = 512   # above this many cones the JAX loader tessellates


def read_curve_file(filename):
    """-> list of (points [P, 3] f64, radii [P] f64)."""
    curves = []
    pts, rad = [], []
    with open(filename) as f:
        for line in f:
            line = line.strip()
            if not line:
                if len(pts) >= 2:
                    curves.append((np.asarray(pts, np.float64),
                                   np.asarray(rad, np.float64)))
                pts, rad = [], []
                continue
            vals = [float(v) for v in line.split()]
            if len(vals) != 4:
                raise ValueError(f"bad curve line: {line!r}")
            pts.append(vals[:3])
            rad.append(vals[3])
    if len(pts) >= 2:
        curves.append((np.asarray(pts, np.float64),
                       np.asarray(rad, np.float64)))
    if not curves:
        raise ValueError(f"{filename}: no curves read")
    return curves


def bspline_to_polyline(points, radii, subdiv: int = 4):
    """Cubic B-spline (bsplinecurve.cpp basis) evaluated at `subdiv`
    samples per span -> polyline control points. Endpoint-clamped by
    control-point replication (the reference's implicit behavior)."""
    p = np.asarray(points, np.float64)
    r = np.asarray(radii, np.float64)
    p = np.concatenate([p[:1], p[:1], p, p[-1:], p[-1:]], axis=0)
    r = np.concatenate([r[:1], r[:1], r, r[-1:], r[-1:]])
    out_p, out_r = [], []
    n_span = p.shape[0] - 3
    for i in range(n_span):
        ts = np.linspace(0.0, 1.0, subdiv, endpoint=False) \
            if i < n_span - 1 else np.linspace(0.0, 1.0, subdiv + 1)
        for t in ts:
            b0 = (1 - t) ** 3 / 6
            b1 = (3 * t ** 3 - 6 * t ** 2 + 4) / 6
            b2 = (-3 * t ** 3 + 3 * t ** 2 + 3 * t + 1) / 6
            b3 = t ** 3 / 6
            out_p.append(b0 * p[i] + b1 * p[i + 1] + b2 * p[i + 2]
                         + b3 * p[i + 3])
            out_r.append(b0 * r[i] + b1 * r[i + 1] + b2 * r[i + 2]
                         + b3 * r[i + 3])
    return np.asarray(out_p), np.asarray(out_r)


def _transport_frames(points):
    """Parallel-transported orthonormal frames along a polyline."""
    p = np.asarray(points, np.float64)
    tang = np.gradient(p, axis=0)
    tang /= np.maximum(np.linalg.norm(tang, axis=1, keepdims=True), 1e-12)
    frames = np.zeros((p.shape[0], 2, 3))
    t0 = tang[0]
    a = np.array([0.0, 1.0, 0.0]) if abs(t0[1]) < 0.9 else \
        np.array([1.0, 0.0, 0.0])
    u = np.cross(t0, a)
    u /= max(np.linalg.norm(u), 1e-12)
    v = np.cross(t0, u)
    frames[0] = (u, v)
    for i in range(1, p.shape[0]):
        # rotate the previous frame onto the new tangent (double
        # reflection / projection variant)
        u = frames[i - 1, 0]
        u = u - tang[i] * np.dot(u, tang[i])
        nu = np.linalg.norm(u)
        if nu < 1e-9:
            a = np.array([0.0, 1.0, 0.0]) \
                if abs(tang[i][1]) < 0.9 else np.array([1.0, 0.0, 0.0])
            u = np.cross(tang[i], a)
            nu = np.linalg.norm(u)
        u /= nu
        v = np.cross(tang[i], u)
        frames[i] = (u, v)
    return tang, frames


def curve_to_tube(points, radii, n_sides: int = 6):
    """One polyline curve -> (vertices, faces, uvs, normals) tube mesh."""
    p = np.asarray(points, np.float64)
    r = np.asarray(radii, np.float64)
    n = p.shape[0]
    _, frames = _transport_frames(p)
    arclen = np.concatenate(
        [[0.0], np.cumsum(np.linalg.norm(np.diff(p, axis=0), axis=1))])
    total = max(arclen[-1], 1e-12)

    ang = 2 * np.pi * (np.arange(n_sides) / n_sides)
    ca, sa = np.cos(ang), np.sin(ang)
    verts, uvs, normals = [], [], []
    for i in range(n):
        u_ax, v_ax = frames[i]
        ring_n = ca[:, None] * u_ax[None, :] + sa[:, None] * v_ax[None, :]
        verts.append(p[i][None, :] + r[i] * ring_n)
        normals.append(ring_n)
        uvs.append(np.stack([np.full(n_sides, arclen[i] / total),
                             (sa + 1.0) * 0.5], axis=1))
    verts = np.concatenate(verts, 0)
    uvs = np.concatenate(uvs, 0)
    normals = np.concatenate(normals, 0)
    faces = []
    for i in range(n - 1):
        for j in range(n_sides):
            a0 = i * n_sides + j
            a1 = i * n_sides + (j + 1) % n_sides
            b0 = (i + 1) * n_sides + j
            b1 = (i + 1) * n_sides + (j + 1) % n_sides
            faces.append([a0, b0, a1])
            faces.append([a1, b0, b1])
    return verts, np.asarray(faces, np.int64), uvs, normals


def build_curve_mesh(spec: dict, bspline: bool):
    """Lower a linearcurve/bsplinecurve spec to one merged MeshData."""
    from . import MeshData
    curves = _curves(spec)
    n_sides = int(spec.get("n_sides", 6))
    subdiv = int(spec.get("subdiv", 4))
    all_v, all_f, all_uv, all_n = [], [], [], []
    off = 0
    for pts, rad in curves:
        if bspline:
            pts, rad = bspline_to_polyline(pts, rad, subdiv)
        v, f, uv, nrm = curve_to_tube(pts, rad, n_sides)
        all_v.append(v)
        all_f.append(f + off)
        all_uv.append(uv)
        all_n.append(nrm)
        off += v.shape[0]
    return MeshData(np.concatenate(all_v, 0), np.concatenate(all_f, 0),
                    uvs=np.concatenate(all_uv, 0),
                    normals=np.concatenate(all_n, 0))


def _curves(spec: dict):
    """The spec's curves: [(points [P, 3], radii [P])]."""
    if "filename" in spec:
        return read_curve_file(spec["filename"])
    cp = np.asarray(spec["control_points"], np.float64).reshape(-1, 4)
    seg = list(spec.get("segment_indices", [0]))
    seg.append(cp.shape[0])
    return [(cp[a:b, :3], cp[a:b, 3])
            for a, b in zip(seg[:-1], seg[1:]) if b - a >= 2]


def curve_cone_rows(spec: dict, bspline: bool):
    """The curve set as round-cone analytic rows [M, 24] float32 (shape,
    BSDF and medium slots 0, the emitter slot -1: the loader fills them),
    one per sub-segment of nonzero length, or None where there is none or
    more than MAX_CONES (JAX's ``curve_cone_rows``)."""
    subdiv = int(spec.get("subdiv", 8 if bspline else 1))
    rows = []
    for pts, rad in _curves(spec):
        if bspline:
            pts, rad = bspline_to_polyline(pts, rad, max(subdiv, 2))
        p = np.asarray(pts, np.float64)
        r = np.asarray(rad, np.float64)
        seg_len = np.linalg.norm(np.diff(p, axis=0), axis=1)
        arc = np.concatenate([[0.0], np.cumsum(seg_len)])
        total = max(arc[-1], 1e-12)
        _, frames = _transport_frames(p)
        for i in range(p.shape[0] - 1):
            if seg_len[i] < 1e-9:
                continue
            axis = (p[i + 1] - p[i]) / seg_len[i]
            # the ring angle's frame, perpendicular to this segment's axis
            u = frames[i, 0] - axis * np.dot(frames[i, 0], axis)
            nu = np.linalg.norm(u)
            if nu < 1e-9:
                a = (np.array([0.0, 1.0, 0.0]) if abs(axis[1]) < 0.9
                     else np.array([1.0, 0, 0]))
                u = np.cross(axis, a)
                nu = np.linalg.norm(u)
            u /= nu
            row = np.zeros(24, np.float32)
            row[0] = 3.0
            row[1:4] = p[i]
            row[4:7] = axis
            row[7] = r[i]
            row[8] = seg_len[i]
            row[9:12] = u
            row[12:15] = np.cross(axis, u)
            row[17] = -1.0
            row[21] = r[i + 1]
            row[22] = arc[i] / total
            row[23] = arc[i + 1] / total
            rows.append(row)
    if not rows or len(rows) > MAX_CONES:
        return None
    return np.stack(rows, 0)
