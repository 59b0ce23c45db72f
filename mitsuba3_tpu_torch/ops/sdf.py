"""Signed-distance-field grid shape — counterpart of
``mitsuba3_tpu/ops/sdf.py`` (src/shapes/sdfgrid.cpp: a trilinear SDF
grid, sphere-traced, with autodiff-able surface points).

Each SDF instance stores a world-to-local affine whose local unit cube
holds the grid. ``intersect_sdf`` marches JAX's N_STEPS sphere-tracing
steps, on the lanes whose ray meets the cube only (the others keep JAX's
outputs: no hit), and ends early once every lane has stopped, after which
JAX's steps change no output. Gradients: the hit point is re-attached
through the implicit-function normal, p(θ) = p_det − n̂ · sdf_θ(p_det),
which gives the grid values vertex-position-style gradients.
"""
from __future__ import annotations

import torch

from ..core.vec import Vec3

N_STEPS = 64
SDF_COLS = 20  # row: 0:12 world->local affine, 12 grid slot, 13 shape,
               # 14 bsdf, 15 medium-in, 16 medium-out
CHECK_EVERY = 8   # steps between the early end's checks (a host sync each)


def _sample_sdf(grid, p: Vec3):
    """Trilinear SDF fetch in local [0,1]^3; outside, the box distance plus
    the clamped border value (keeps sphere tracing convergent toward the
    domain)."""
    d, h, w = grid.shape
    fx = torch.clamp(p.x, 0.0, 1.0) * (w - 1)
    fy = torch.clamp(p.y, 0.0, 1.0) * (h - 1)
    fz = torch.clamp(p.z, 0.0, 1.0) * (d - 1)
    x0 = torch.clamp(torch.floor(fx), 0, w - 2).to(torch.int64)
    y0 = torch.clamp(torch.floor(fy), 0, h - 2).to(torch.int64)
    z0 = torch.clamp(torch.floor(fz), 0, d - 2).to(torch.int64)
    tx = fx - x0.to(torch.float32)
    ty = fy - y0.to(torch.float32)
    tz = fz - z0.to(torch.float32)
    flat = grid.reshape(-1)

    def at(zi, yi, xi):
        return flat[(zi * h + yi) * w + xi]

    c00 = at(z0, y0, x0) * (1 - tx) + at(z0, y0, x0 + 1) * tx
    c01 = at(z0, y0 + 1, x0) * (1 - tx) + at(z0, y0 + 1, x0 + 1) * tx
    c10 = at(z0 + 1, y0, x0) * (1 - tx) + at(z0 + 1, y0, x0 + 1) * tx
    c11 = at(z0 + 1, y0 + 1, x0) * (1 - tx) + at(z0 + 1, y0 + 1,
                                                 x0 + 1) * tx
    val = ((c00 * (1 - ty) + c01 * ty) * (1 - tz)
           + (c10 * (1 - ty) + c11 * ty) * tz)
    ex = torch.clamp(torch.maximum(-p.x, p.x - 1.0), min=0.0)
    ey = torch.clamp(torch.maximum(-p.y, p.y - 1.0), min=0.0)
    ez = torch.clamp(torch.maximum(-p.z, p.z - 1.0), min=0.0)
    outside = torch.sqrt(ex * ex + ey * ey + ez * ez)
    return torch.where(outside > 0.0, outside + torch.clamp(val, min=0.0),
                       val)


def sdf_normal(grid, p: Vec3) -> Vec3:
    """Central-difference SDF gradient (sdfgrid.cpp smooth normal)."""
    d, h, w = grid.shape
    e = 1.0 / max(d, h, w)
    gx = _sample_sdf(grid, Vec3(p.x + e, p.y, p.z)) \
        - _sample_sdf(grid, Vec3(p.x - e, p.y, p.z))
    gy = _sample_sdf(grid, Vec3(p.x, p.y + e, p.z)) \
        - _sample_sdf(grid, Vec3(p.x, p.y - e, p.z))
    gz = _sample_sdf(grid, Vec3(p.x, p.y, p.z + e)) \
        - _sample_sdf(grid, Vec3(p.x, p.y, p.z - e))
    g = Vec3(gx, gy, gz)
    return g * (1.0 / torch.clamp(g.norm(), min=1e-12))


def _to_local(row, p: Vec3) -> Vec3:
    return Vec3(row[0] * p.x + row[1] * p.y + row[2] * p.z + row[3],
                row[4] * p.x + row[5] * p.y + row[6] * p.z + row[7],
                row[8] * p.x + row[9] * p.y + row[10] * p.z + row[11])


def _to_local_dir(row, d: Vec3) -> Vec3:
    return Vec3(row[0] * d.x + row[1] * d.y + row[2] * d.z,
                row[4] * d.x + row[5] * d.y + row[6] * d.z,
                row[8] * d.x + row[9] * d.y + row[10] * d.z)


def _march(grid, ol: Vec3, dn: Vec3, t, t_out, tol: float):
    """JAX's sphere-tracing scan on the lanes given: (t, hit) after
    N_STEPS steps, or fewer once no lane is still marching."""
    n = t.shape[0]
    hit = torch.zeros(n, dtype=torch.bool, device=t.device)
    dead = torch.zeros_like(hit)
    armed = torch.zeros_like(hit)
    for i in range(N_STEPS):
        if i % CHECK_EVERY == 0 and bool(dead.all()):
            break
        s = _sample_sdf(grid, ol + dn * t)
        # rays spawned on the surface must first leave the tolerance band
        # before a hit counts (the secondary-ray self-intersection guard)
        armed = armed | (s > 2.0 * tol)
        new_hit = ~dead & armed & (s < tol)
        t_next = t + torch.clamp(s, min=tol * 0.5)
        t = torch.where(dead, t, torch.where(new_hit, t, t_next))
        hit = hit | new_hit
        dead = dead | new_hit | (t_next > t_out)
    return t, hit


def intersect_sdf(grid, row, o: Vec3, d: Vec3, maxt, active=None):
    """Sphere-trace one SDF instance: (t_world [N], uv x, uv y, valid)."""
    grid = grid.detach()
    n = o.x.shape[0]
    dev = o.x.device
    maxt = torch.as_tensor(maxt, dtype=torch.float32, device=dev).expand(n)
    if active is None:
        active = torch.ones(n, dtype=torch.bool, device=dev)
    ol = _to_local(row, o)
    dl = _to_local_dir(row, d)
    dlen = torch.clamp(dl.norm(), min=1e-20)
    dn = dl * (1.0 / dlen)

    # clip to the local unit cube
    eps = 1e-12

    def inv(c):
        return 1.0 / torch.where(torch.abs(c) < eps, eps, c)

    ix, iy, iz = inv(dn.x), inv(dn.y), inv(dn.z)
    t0x, t1x = (0.0 - ol.x) * ix, (1.0 - ol.x) * ix
    t0y, t1y = (0.0 - ol.y) * iy, (1.0 - ol.y) * iy
    t0z, t1z = (0.0 - ol.z) * iz, (1.0 - ol.z) * iz
    t_in = torch.maximum(torch.maximum(torch.minimum(t0x, t1x),
                                       torch.minimum(t0y, t1y)),
                         torch.minimum(t0z, t1z))
    t_out = torch.minimum(torch.minimum(torch.maximum(t0x, t1x),
                                        torch.maximum(t0y, t1y)),
                          torch.maximum(t0z, t1z))
    t_in = torch.where(t_in > 0.0, t_in, 0.0)
    feasible = active & (t_out > t_in) & (t_in * (1.0 / dlen) <= maxt)

    tol = 1.0 / (2.0 * max(grid.shape))
    t_loc = torch.zeros(n, dtype=torch.float32, device=dev)
    hit = torch.zeros(n, dtype=torch.bool, device=dev)
    idx = torch.nonzero(feasible).squeeze(1)
    if idx.shape[0]:
        t_s, hit_s = _march(grid, Vec3(ol.x[idx], ol.y[idx], ol.z[idx]),
                            Vec3(dn.x[idx], dn.y[idx], dn.z[idx]),
                            t_in[idx], t_out[idx], tol)
        t_loc[idx] = t_s
        hit[idx] = hit_s
    t_world = t_loc / dlen
    valid = hit & feasible & (t_world <= maxt)
    p_loc = ol + dn * t_loc
    return (torch.where(valid, t_world, 3.4e38),
            torch.clamp(p_loc.x, 0.0, 1.0), torch.clamp(p_loc.y, 0.0, 1.0),
            valid)


def surface_fields(grid, row, o: Vec3, d: Vec3, t, active=None):
    """Differentiable hit recomputation: the detached march point
    re-attached through the implicit function (one Newton projection along
    the normal, which carries d(hit)/d(grid values) as sdfgrid.cpp's
    differentiable compute_surface_interaction does). Returns (p, n)."""
    # inactive lanes get t = 1 (t = BIG would overflow to inf and poison
    # the backward through the branch not taken)
    if active is not None:
        t = torch.where(active, t, 1.0)
    t = torch.clamp(t, 0.0, 1e6)
    p_det = (o + d * t)
    p_det = Vec3(p_det.x.detach(), p_det.y.detach(), p_det.z.detach())
    pl = _to_local(row, p_det)
    n_loc = sdf_normal(grid, pl)
    s_val = _sample_sdf(grid, pl)
    # attached local hit: zero displacement in value, but d/d(grid) moves
    # the surface along the normal
    pl_att = pl - n_loc * s_val
    # the world normal: the inverse transpose of world->local's linear part
    # is that part transposed
    nw = Vec3(row[0] * n_loc.x + row[4] * n_loc.y + row[8] * n_loc.z,
              row[1] * n_loc.x + row[5] * n_loc.y + row[9] * n_loc.z,
              row[2] * n_loc.x + row[6] * n_loc.y + row[10] * n_loc.z)
    nw = nw * (1.0 / torch.clamp(nw.norm(), min=1e-12))
    # the world hit point: p_det plus the world displacement of
    # (pl_att - pl), for a rigid + uniform transform A^-1 = A^T / s^2
    disp = pl_att - pl
    dw = Vec3(row[0] * disp.x + row[4] * disp.y + row[8] * disp.z,
              row[1] * disp.x + row[5] * disp.y + row[9] * disp.z,
              row[2] * disp.x + row[6] * disp.y + row[10] * disp.z)
    scale2 = torch.clamp(row[0] ** 2 + row[4] ** 2 + row[8] ** 2, min=1e-20)
    pw = p_det + dw * (1.0 / scale2)
    return pw, nw
