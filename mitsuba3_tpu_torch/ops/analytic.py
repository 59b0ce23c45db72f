"""Analytic shape intersections — counterpart of
``mitsuba3_tpu/ops/analytic.py`` (sphere.cpp, disk.cpp, cylinder.cpp and
the round cones of linearcurve.cpp / bsplinecurve.cpp).

Implicit shapes live in a dense [A, 24] parameter table tested against
every ray after the triangle pass. Hits are encoded as prim_index >= F
(the face count); the surface interaction is recomputed analytically and
differentiably from the table.

Row layout (the JAX package's):
  0 type (0 sphere, 1 disk, 2 cylinder, 3 round cone — a swept-sphere
    curve segment)
  1:4 p        — center (sphere/disk) / axis base point (cylinder/cone)
  4:7 n        — unit: disk normal / cylinder+cone axis
  7  radius    — cone: radius at the base point
  8  length    — cylinder/cone axis length
  9:12  axis_u — unit tangent (uv frame)
  12:15 axis_v
  15 shape_idx   16 bsdf   17 emitter (-1: area-emitter analytic shapes
  are tessellated instead)   18 interior medium   19 exterior
  20 flip_normals
  21 radius_b  — cone: radius at the far endpoint
  22 u0  23 u1 — cone: curve-parameter range of this segment (uv.x)

Where JAX broadcasts one dense [A, N] block per temporary and evaluates
all four types on every row, ``intersect_analytic`` groups the rows by
type (one host read of the type column), evaluates each group's own type
only, in chunks of at most STEP_ELEMS row x lane entries, and keeps a
running (t, row, u, v) per lane. The selection is JAX's: the smallest t
wins, ties to the largest row index, t > maxt misses. A row's t, u and v
are the same elementwise operations as JAX's and JAX selects them by
`where`, so leaving out the other types changes no value. These are
plain PyTorch ops (JAX's are plain XLA).
"""
from __future__ import annotations

import math

import torch

from ..core.vec import Vec2, Vec3

N_COLS = 24
BIG = 3.4e38
STEP_ELEMS = 1 << 23   # row x lane entries per temporary
TWO_PI = 2.0 * math.pi


def _wrap_phi(phi):
    return torch.where(phi < 0.0, phi + TWO_PI, phi)


def _sphere(c, L, D):
    """t, u, v of sphere rows `c` (columns [C, 1]) for ray offsets
    L = o - p and directions D (each [1, N])."""
    lx, ly, lz = L
    dx, dy, dz = D
    r = c[7]
    b = lx * dx + ly * dy + lz * dz
    cc = lx * lx + ly * ly + lz * lz - r * r
    disc = b * b - cc
    sq = torch.sqrt(torch.clamp(disc, min=0.0))
    t0 = -b - sq
    t1 = -b + sq
    eps = 1e-4 * torch.clamp(r, min=1e-3)
    t = torch.where(t0 > eps, t0, torch.where(t1 > eps, t1, BIG))
    t = torch.where(disc >= 0.0, t, BIG)
    hx, hy, hz = lx + t * dx, ly + t * dy, lz + t * dz
    su = hx * c[9] + hy * c[10] + hz * c[11]
    sv = hx * c[12] + hy * c[13] + hz * c[14]
    sn = hx * c[4] + hy * c[5] + hz * c[6]
    inv_r = 1.0 / torch.clamp(r, min=1e-20)
    theta = torch.arccos(torch.clamp(sn * inv_r, -1.0, 1.0))
    phi = _wrap_phi(torch.atan2(sv, su))
    return t, phi * (0.5 / math.pi), theta / math.pi


def _disk(c, L, D):
    lx, ly, lz = L
    dx, dy, dz = D
    nx, ny, nz, r = c[4], c[5], c[6], c[7]
    denom = dx * nx + dy * ny + dz * nz
    t_pl = -(lx * nx + ly * ny + lz * nz) / torch.where(
        torch.abs(denom) < 1e-12, 1e-12, denom)
    qx, qy, qz = lx + t_pl * dx, ly + t_pl * dy, lz + t_pl * dz
    du = qx * c[9] + qy * c[10] + qz * c[11]
    dv = qx * c[12] + qy * c[13] + qz * c[14]
    rad2 = du * du + dv * dv
    ok = (t_pl > 1e-4) & (rad2 <= r * r) & (torch.abs(denom) > 1e-12)
    t = torch.where(ok, t_pl, BIG)
    rd = torch.sqrt(torch.clamp(rad2, min=0.0))
    inv_r = 1.0 / torch.clamp(r, min=1e-20)
    phi = _wrap_phi(torch.atan2(dv, du))
    return t, rd * inv_r, phi * (0.5 / math.pi)


def _cylinder(c, L, D):
    lx, ly, lz = L
    dx, dy, dz = D
    nx, ny, nz, r, length = c[4], c[5], c[6], c[7], c[8]
    d_par = dx * nx + dy * ny + dz * nz
    l_par = lx * nx + ly * ny + lz * nz
    cx, cy, cz = dx - d_par * nx, dy - d_par * ny, dz - d_par * nz
    wx, wy, wz = lx - l_par * nx, ly - l_par * ny, lz - l_par * nz
    a2 = cx * cx + cy * cy + cz * cz
    b2 = cx * wx + cy * wy + cz * wz
    c2 = wx * wx + wy * wy + wz * wz - r * r
    disc2 = b2 * b2 - a2 * c2
    sq2 = torch.sqrt(torch.clamp(disc2, min=0.0))
    inv_a2 = 1.0 / torch.where(a2 < 1e-12, 1e-12, a2)
    tc0 = (-b2 - sq2) * inv_a2
    tc1 = (-b2 + sq2) * inv_a2

    def ok(tc):
        h = l_par + tc * d_par
        return ((tc > 1e-4) & (h >= 0.0) & (h <= length) & (disc2 >= 0.0)
                & (a2 > 1e-12))

    t = torch.where(ok(tc0), tc0, torch.where(ok(tc1), tc1, BIG))
    h = l_par + t * d_par
    gx = lx + t * dx - h * nx
    gy = ly + t * dy - h * ny
    gz = lz + t * dz - h * nz
    pu = gx * c[9] + gy * c[10] + gz * c[11]
    pv = gx * c[12] + gy * c[13] + gz * c[14]
    phi = _wrap_phi(torch.atan2(pv, pu))
    return t, phi * (0.5 / math.pi), h / torch.clamp(length, min=1e-20)


def _cone(c, L, D):
    """The round cone: lateral quadratic and both sphere caps, each
    region-tested (a cap hit on the cone body is rejected)."""
    lx, ly, lz = L
    dx, dy, dz = D
    nx, ny, nz, r, length = c[4], c[5], c[6], c[7], c[8]
    rb, u0, u1 = c[21], c[22], c[23]
    bax, bay, baz = nx * length, ny * length, nz * length
    rr = r - rb
    m0 = length * length
    m1 = bax * lx + bay * ly + baz * lz
    m2 = bax * dx + bay * dy + baz * dz
    m3 = dx * lx + dy * ly + dz * lz
    m5 = lx * lx + ly * ly + lz * lz
    obx, oby, obz = lx - bax, ly - bay, lz - baz
    m6 = dx * obx + dy * oby + dz * obz
    m7 = obx * obx + oby * oby + obz * obz
    d2p = m0 - rr * rr
    k2 = d2p - m2 * m2
    k1 = d2p * m3 - m1 * m2 + m2 * rr * r
    k0 = d2p * m5 - m1 * m1 + 2.0 * m1 * rr * r - m0 * r * r
    hq = k1 * k1 - k0 * k2
    sqhq = torch.sqrt(torch.clamp(hq, min=0.0))
    k2s = torch.where(torch.abs(k2) < 1e-12, 1e-12, k2)
    eps = 1e-4

    def yy(tc):
        return m1 - r * rr + tc * m2

    def cand(tc, ok):
        return torch.where(ok, tc, BIG)

    def lat(tc):
        y = yy(tc)
        return cand(tc, (hq >= 0.0) & (y > 0.0) & (y < d2p) & (tc > eps))

    ha = m3 * m3 - m5 + r * r
    hb = m6 * m6 - m7 + rb * rb
    sq_a = torch.sqrt(torch.clamp(ha, min=0.0))
    sq_b = torch.sqrt(torch.clamp(hb, min=0.0))

    def cap_a(tc):
        return cand(tc, (ha >= 0.0) & (yy(tc) <= 0.0) & (tc > eps))

    def cap_b(tc):
        return cand(tc, (hb >= 0.0) & (yy(tc) >= d2p) & (tc > eps))

    t = torch.minimum(
        torch.minimum(lat((-k1 - sqhq) / k2s), lat((-k1 + sqhq) / k2s)),
        torch.minimum(
            torch.minimum(cap_a(-m3 - sq_a), cap_a(-m3 + sq_a)),
            torch.minimum(cap_b(-m6 - sq_b), cap_b(-m6 + sq_b))))
    # uv: x the curve parameter (the segment's range lerped), y (sin of the
    # ring angle + 1) / 2, the hair BSDF's h convention
    qx, qy, qz = lx + t * dx, ly + t * dy, lz + t * dz
    y_c = bax * qx + bay * qy + baz * qz - r * rr
    s_c = torch.clamp(y_c / torch.where(d2p <= 0, 1.0, d2p), 0.0, 1.0)
    rxx = qx - s_c * bax
    rxy = qy - s_c * bay
    rxz = qz - s_c * baz
    rnorm = torch.sqrt(torch.clamp(rxx * rxx + rxy * rxy + rxz * rxz,
                                   min=1e-20))
    sin_ring = (rxx * c[12] + rxy * c[13] + rxz * c[14]) / rnorm
    return (t, u0 + s_c * (u1 - u0),
            0.5 * (torch.clamp(sin_ring, -1.0, 1.0) + 1.0))


KINDS = (_sphere, _disk, _cylinder, _cone)   # by type id; any other: cone


def row_groups(table):
    """[(kind function, row ids [R] long)] of the table's rows by type
    (one host read of the type column)."""
    col = table[:, 0].detach()
    typ = torch.full(col.shape, 3, dtype=torch.int64, device=col.device)
    for k in range(3):
        typ = torch.where(col == k, k, typ)
    host = typ.cpu()
    return [(KINDS[k], torch.nonzero(typ == k).squeeze(1))
            for k in range(4) if bool((host == k).any())]


def intersect_analytic(table, o: Vec3, d: Vec3, maxt, active=None):
    """table [A, N_COLS] vs rays [N] -> (t [N], aidx [N] i32 (-1 = miss),
    uv Vec2, valid [N]). The nearest analytic hit only; the caller merges
    it with the triangle result."""
    n = o.x.shape[0]
    dev = o.x.device
    maxt = torch.as_tensor(maxt, dtype=torch.float32, device=dev).expand(n)
    if active is None:
        active = torch.ones(n, dtype=torch.bool, device=dev)
    bt = torch.full((n,), BIG, dtype=torch.float32, device=dev)
    bi = torch.full((n,), -1, dtype=torch.int64, device=dev)
    bu = torch.zeros(n, dtype=torch.float32, device=dev)
    bv = torch.zeros(n, dtype=torch.float32, device=dev)
    if n == 0 or table.shape[0] == 0:
        return bt, bi.to(torch.int32), Vec2(bu, bv), bt < BIG
    for kind, ids in row_groups(table):
        n_rows = ids.shape[0]
        rows_step = max(1, min(n_rows, STEP_ELEMS // n))
        for r0 in range(0, n_rows, rows_step):
            rid = ids[r0:r0 + rows_step]
            sub = table[rid]
            cols = [sub[:, j:j + 1] for j in range(N_COLS)]
            lanes = max(1, STEP_ELEMS // rid.shape[0])
            for s0 in range(0, n, lanes):
                s = slice(s0, s0 + lanes)
                D = (d.x[s][None], d.y[s][None], d.z[s][None])
                L = (o.x[s][None] - cols[1], o.y[s][None] - cols[2],
                     o.z[s][None] - cols[3])
                t, u, v = kind(cols, L, D)
                t = torch.where(active[s][None] & (t <= maxt[s][None]), t,
                                BIG)
                tmin = t.amin(dim=0)
                rows = rid[:, None].expand_as(t)
                win = t == tmin[None]
                row = torch.where(win, rows, -1).amax(dim=0)
                final = win & (rows == row[None])
                # ties in t go to the largest row index, in any group order
                take = (tmin < bt[s]) | ((tmin == bt[s]) & (row > bi[s]))
                bt[s] = torch.where(take, tmin, bt[s])
                bi[s] = torch.where(take, row, bi[s])
                bu[s] = torch.where(take, torch.where(final, u, 0.0).sum(0),
                                    bu[s])
                bv[s] = torch.where(take, torch.where(final, v, 0.0).sum(0),
                                    bv[s])
    valid = bt < BIG
    return (bt, torch.where(valid, bi, -1).to(torch.int32), Vec2(bu, bv),
            valid)


def surface_fields(table, aidx, uv: Vec2, ray_o: Vec3, ray_d: Vec3, t):
    """Analytic differentiable surface recomputation from (prim, uv)
    (sphere.cpp / disk.cpp / cylinder.cpp compute_surface_interaction).
    Each lane's row is gathered (JAX's one-hot matmul takes the same
    values, and the gather's backward gives the table the same gradient).
    Returns (p Vec3, ng Vec3, ns Vec3, rows [C, N]) with gradients attached
    to the table."""
    from ..core.gather import take_rows
    a = table.shape[0]
    rows = take_rows(table, torch.clamp(aidx, 0, a - 1)).T   # [C, N]
    typ = torch.round(rows[0]).to(torch.int32)
    p0 = Vec3(rows[1], rows[2], rows[3])
    nax = Vec3(rows[4], rows[5], rows[6])
    r = rows[7]
    length = rows[8]
    au = Vec3(rows[9], rows[10], rows[11])
    av = Vec3(rows[12], rows[13], rows[14])
    flip = rows[20] > 0.5

    # sphere: p = c + r * omega(uv)
    phi = uv.x * TWO_PI
    theta = uv.y * math.pi
    st, ct = torch.sin(theta), torch.cos(theta)
    sp, cp = torch.sin(phi), torch.cos(phi)
    w_sph = au * (st * cp) + av * (st * sp) + nax * ct
    p_sph = p0 + w_sph * r

    # disk: p = c + r u (cos phi au + sin phi av); phi = 2 pi v
    phi_d = uv.y * TWO_PI
    p_disk = p0 + (au * torch.cos(phi_d) + av * torch.sin(phi_d)) * (uv.x * r)

    # cylinder: p = base + v len axis + r (cos phi au + sin phi av)
    phi_c = uv.x * TWO_PI
    radial = au * torch.cos(phi_c) + av * torch.sin(phi_c)
    p_cyl = p0 + nax * (uv.y * length) + radial * r

    # round cone: the hit from the ray; the normal by region (cap a,
    # lateral, cap b)
    q = ray_o + ray_d * t
    ba = nax * length
    rr = r - rows[21]
    d2p = length * length - rr * rr
    qa = q - p0
    y_c = ba.dot(qa) - r * rr
    lat_n = qa * d2p - ba * y_c
    n_cone = Vec3.where(y_c <= 0.0, qa,
                        Vec3.where(y_c >= d2p, q - (p0 + ba),
                                   lat_n)).normalize()

    p = Vec3.where(typ == 0, p_sph,
                   Vec3.where(typ == 1, p_disk,
                              Vec3.where(typ == 2, p_cyl, q)))
    ng = Vec3.where(typ == 0, w_sph,
                    Vec3.where(typ == 1, nax,
                               Vec3.where(typ == 2, radial, n_cone)))
    ng = Vec3.where(flip, -ng, ng)
    return p, ng, ng, rows
