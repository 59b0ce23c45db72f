"""Dense ray-triangle intersection — counterpart of
``mitsuba3_tpu/ops/intersect.py``.

Every ray is tested against every triangle (Möller–Trumbore), the
triangles in chunks of `chunk` and, unlike JAX, the rays in steps too, so
that the [chunk, rays] intermediates stay within a card's memory: a step
takes STEP_ELEMS // chunk rays, at least RAY_CHUNK (65,536 for 256-face
chunks; 419,430 for the Cornell box's one chunk of 40). The rules are
JAX's:

- a hit needs det != 0, u >= 0, v >= 0, u + v <= 1 and t in [0, maxt];
- inside a chunk the smallest t wins, ties to the largest prim id;
- a later chunk replaces the best only with a strictly smaller t;
- inactive lanes get maxt -inf, so they never hit;
- the triangles are one chunk when there are at most `chunk` of them;
  otherwise their count is a multiple of `chunk`, or one ragged chunk of
  at most 4096.

With one chunk, t on a miss is BIG; with several it is maxt (clipped to
BIG), as in JAX. These are plain PyTorch ops (JAX's are plain XLA): the
dense oracle of the accels' tests and of ``chip_smoke.py``.
"""
from __future__ import annotations

import torch

from ..core.vec import Vec2, Vec3

BIG = 3.4e38
RAY_CHUNK = 32768      # rays per step at least
STEP_ELEMS = 1 << 24   # [chunk, rays] elements per step (64 MB in f32)


def _mt_chunk(o, d, tri, mint, maxt):
    """Möller–Trumbore for [C] triangles x [N] rays. `o`, `d` are 3-tuples
    of [N], `tri` nine [C] tensors. Returns (t, u, v, hit), each [C, N]."""
    p0x, p0y, p0z, e1x, e1y, e1z, e2x, e2y, e2z = (a[:, None] for a in tri)
    ox, oy, oz = (a[None, :] for a in o)
    dx, dy, dz = (a[None, :] for a in d)
    pvx = dy * e2z - dz * e2y
    pvy = dz * e2x - dx * e2z
    pvz = dx * e2y - dy * e2x
    det = e1x * pvx + e1y * pvy + e1z * pvz
    det_ok = det != 0.0
    inv_det = torch.where(det_ok, 1.0 / torch.where(det_ok, det, 1.0), 0.0)
    tvx, tvy, tvz = ox - p0x, oy - p0y, oz - p0z
    u = (tvx * pvx + tvy * pvy + tvz * pvz) * inv_det
    qvx = tvy * e1z - tvz * e1y
    qvy = tvz * e1x - tvx * e1z
    qvz = tvx * e1y - tvy * e1x
    v = (dx * qvx + dy * qvy + dz * qvz) * inv_det
    t = (e2x * qvx + e2y * qvy + e2z * qvz) * inv_det
    hit = (det_ok & (u >= 0.0) & (v >= 0.0) & (u + v <= 1.0)
           & (t >= mint[None, :]) & (t <= maxt[None, :]))
    return t, u, v, hit


def _closest_in_chunk(o, d, tri, mint, maxt, base_prim: int):
    """One chunk's closest hit -> (tmin, prim (-1 = none), u, v), each
    [N]."""
    c = tri[0].shape[0]
    t, u, v, hit = _mt_chunk(o, d, tri, mint, maxt)
    t_m = torch.where(hit, t, BIG)
    tmin = t_m.amin(dim=0)
    winner = hit & (t_m == tmin[None, :])
    ids = base_prim + torch.arange(c, dtype=torch.int32,
                                   device=t.device)[:, None]
    # ties go to the largest prim id
    prim = torch.where(winner, ids, -1).amax(dim=0)
    final = winner & (ids == prim[None, :])
    return (tmin, prim, torch.where(final, u, 0.0).sum(dim=0),
            torch.where(final, v, 0.0).sum(dim=0))


def _chunking(t_total: int, chunk: int):
    chunk = min(chunk, t_total)
    if t_total % chunk != 0:
        if t_total > 4096:
            raise ValueError(f"{t_total} triangles: large triangle arrays "
                             f"must be padded to a multiple of {chunk}")
        chunk = t_total   # one ragged chunk for mid-size scenes
    return chunk, t_total // chunk


def _ray_step(chunk: int) -> int:
    return max(RAY_CHUNK, STEP_ELEMS // chunk)


def _lanes(o: Vec3, maxt, active):
    n = o.x.shape[0]
    maxt = torch.as_tensor(maxt, dtype=torch.float32,
                           device=o.x.device).expand(n)
    if active is not None:
        maxt = torch.where(active, maxt, -float("inf"))
    return n, maxt


def _tri_rows(p0: Vec3, e1: Vec3, e2: Vec3):
    return (p0.x, p0.y, p0.z, e1.x, e1.y, e1.z, e2.x, e2.y, e2.z)


def intersect_naive(o: Vec3, d: Vec3, maxt, p0: Vec3, e1: Vec3, e2: Vec3,
                    active=None, chunk: int = 256):
    """Closest hit over all triangles: o, d Vec3 of [N], maxt [N] (or a
    scalar), p0/e1/e2 Vec3 of [T] -> (t [N], prim [N] i32, uv Vec2,
    valid [N])."""
    n, maxt = _lanes(o, maxt, active)
    chunk, n_chunks = _chunking(p0.x.shape[0], chunk)
    tris = _tri_rows(p0, e1, e2)
    dev = o.x.device
    t_out = torch.empty(n, dtype=torch.float32, device=dev)
    prim = torch.empty(n, dtype=torch.int32, device=dev)
    uu = torch.empty(n, dtype=torch.float32, device=dev)
    vv = torch.empty(n, dtype=torch.float32, device=dev)
    step = _ray_step(chunk)
    for r0 in range(0, n, step):
        rs = slice(r0, r0 + step)
        ro = (o.x[rs], o.y[rs], o.z[rs])
        rd = (d.x[rs], d.y[rs], d.z[rs])
        mint = torch.zeros_like(ro[0])
        best_t = torch.clamp(maxt[rs], max=BIG)
        if n_chunks == 1:
            out = _closest_in_chunk(ro, rd, tris, mint, best_t, 0)
        else:
            out = (best_t, torch.full_like(mint, -1, dtype=torch.int32),
                   torch.zeros_like(mint), torch.zeros_like(mint))
            for c in range(n_chunks):
                tc = tuple(a[c * chunk:(c + 1) * chunk] for a in tris)
                tmin, pc, uc, vc = _closest_in_chunk(ro, rd, tc, mint,
                                                     out[0], c * chunk)
                closer = (pc >= 0) & (tmin < out[0])
                out = tuple(torch.where(closer, new, old) for new, old in
                            zip((tmin, pc, uc, vc), out))
        t_out[rs], prim[rs], uu[rs], vv[rs] = out
    return t_out, prim, Vec2(uu, vv), prim >= 0


def occluded_naive(o: Vec3, d: Vec3, maxt, p0: Vec3, e1: Vec3, e2: Vec3,
                   active=None, chunk: int = 256):
    """Any hit with t in [0, maxt] over all triangles -> bool [N]."""
    n, maxt = _lanes(o, maxt, active)
    chunk, n_chunks = _chunking(p0.x.shape[0], chunk)
    tris = _tri_rows(p0, e1, e2)
    occ = torch.zeros(n, dtype=torch.bool, device=o.x.device)
    step = _ray_step(chunk)
    for r0 in range(0, n, step):
        rs = slice(r0, r0 + step)
        ro = (o.x[rs], o.y[rs], o.z[rs])
        rd = (d.x[rs], d.y[rs], d.z[rs])
        mint = torch.zeros_like(ro[0])
        for c in range(n_chunks):
            tc = tuple(a[c * chunk:(c + 1) * chunk] for a in tris)
            occ[rs] |= _mt_chunk(ro, rd, tc, mint, maxt[rs])[3].any(dim=0)
    return occ
