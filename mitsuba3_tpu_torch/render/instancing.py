"""True instancing — counterpart of ``mitsuba3_tpu/render/instancing.py``
(the role of the reference's ``instance`` and ``shapegroup`` plugins and
their nested accels).

Prototype geometry and its accel are stored once; each instance adds a
3x4 transform pair, a normal matrix and a world AABB row. A query runs
JAX's rounds:
  1. candidates: per ray the lexicographic successor (t_entry, instance)
     of the last processed candidate over every instance AABB;
  2. the candidate's world->prototype 3x4 applied to (o, d); d stays
     unnormalised, so prototype-space t is world t;
  3. one query per prototype on the lanes that picked it: the dense test
     (``ops/intersect.py``) for a small prototype, its cellserve accel
     (K1) for one above 8192 faces;
  4. a ray retires when no candidate entry lies before its best hit
     (any-hit: on its first hit).
Each round runs on the rays still live only, with one host sync a round,
at most I rounds; the candidate test takes the instances in lane chunks
of at most STEP_ELEMS entries. A lane's candidate is the lexicographic
minimum over all instances, which JAX's chunked reduction also gives, so
the instances and prims are JAX's.
"""
from __future__ import annotations

import torch

from ..core.struct import struct
from ..core.vec import Vec2, Vec3

BIG = 3.4e38
STEP_ELEMS = 1 << 23    # lane x instance entries per candidate temporary


@struct
class InstanceTable:
    to_world: torch.Tensor   # [I, 12] row-major 3x4 prototype->world
    to_proto: torch.Tensor   # [I, 12] the inverse (world->prototype)
    n_mat: torch.Tensor      # [I, 9] inverse-transpose linear part (normals)
    aabb_lo: torch.Tensor    # [I, 3] world-space instance AABB
    aabb_hi: torch.Tensor    # [I, 3]
    proto_of: torch.Tensor   # [I] i32 prototype slot


INSTANCE_FIELDS = ("to_world", "to_proto", "n_mat", "aabb_lo", "aabb_hi",
                   "proto_of")


def affine_apply(m12, p: Vec3) -> Vec3:
    """[N, 12] row-major 3x4 applied to points."""
    return Vec3(
        m12[:, 0] * p.x + m12[:, 1] * p.y + m12[:, 2] * p.z + m12[:, 3],
        m12[:, 4] * p.x + m12[:, 5] * p.y + m12[:, 6] * p.z + m12[:, 7],
        m12[:, 8] * p.x + m12[:, 9] * p.y + m12[:, 10] * p.z + m12[:, 11])


def linear_apply(m12, v: Vec3) -> Vec3:
    return Vec3(m12[:, 0] * v.x + m12[:, 1] * v.y + m12[:, 2] * v.z,
                m12[:, 4] * v.x + m12[:, 5] * v.y + m12[:, 6] * v.z,
                m12[:, 8] * v.x + m12[:, 9] * v.y + m12[:, 10] * v.z)


def linear9_apply(m9, v: Vec3) -> Vec3:
    return Vec3(m9[:, 0] * v.x + m9[:, 1] * v.y + m9[:, 2] * v.z,
                m9[:, 3] * v.x + m9[:, 4] * v.y + m9[:, 5] * v.z,
                m9[:, 6] * v.x + m9[:, 7] * v.y + m9[:, 8] * v.z)


def _successor_candidate(inst: InstanceTable, o: Vec3, inv: Vec3, cap,
                         t_floor, j_floor):
    """Per ray: the least (t_entry, j) over the instance AABBs strictly
    after (t_floor, j_floor) in lexicographic order and with t_entry < cap.
    Returns (t_next [N], j_next [N]; t_next = BIG when exhausted)."""
    n_inst = inst.proto_of.shape[0]
    n = o.x.shape[0]
    lo, hi = inst.aabb_lo, inst.aabb_hi
    jidx = torch.arange(n_inst, dtype=torch.int32, device=lo.device)[None]
    t_next = torch.empty(n, dtype=torch.float32, device=lo.device)
    j_next = torch.empty(n, dtype=torch.int32, device=lo.device)
    step = max(1, STEP_ELEMS // max(n_inst, 1))
    for s0 in range(0, n, step):
        s = slice(s0, s0 + step)
        ox, oy, oz = o.x[s, None], o.y[s, None], o.z[s, None]
        ix, iy, iz = inv.x[s, None], inv.y[s, None], inv.z[s, None]
        t0x = (lo[None, :, 0] - ox) * ix
        t1x = (hi[None, :, 0] - ox) * ix
        t0y = (lo[None, :, 1] - oy) * iy
        t1y = (hi[None, :, 1] - oy) * iy
        t0z = (lo[None, :, 2] - oz) * iz
        t1z = (hi[None, :, 2] - oz) * iz
        z = torch.minimum(t0z, t1z)
        t_in = torch.maximum(torch.maximum(torch.minimum(t0x, t1x),
                                           torch.minimum(t0y, t1y)),
                             torch.where(z > 0.0, z, 0.0))
        t_out = torch.minimum(torch.minimum(torch.maximum(t0x, t1x),
                                            torch.maximum(t0y, t1y)),
                              torch.maximum(t0z, t1z))
        tf, jf = t_floor[s, None], j_floor[s, None]
        succ = (t_in > tf) | ((t_in == tf) & (jidx > jf))
        ok = (t_in <= t_out) & (t_out > 0.0) & succ & (t_in < cap[s, None])
        tc = torch.where(ok, t_in, BIG)
        tmin = tc.amin(dim=1)
        t_next[s] = tmin
        j_next[s] = torch.where(tc == tmin[:, None], jidx,
                                n_inst).amin(dim=1)
    return t_next, torch.clamp(j_next, max=n_inst - 1)


def _guard_inv(d: Vec3) -> Vec3:
    tiny = 1e-20

    def g(c):
        return 1.0 / torch.where(torch.abs(c) < tiny, tiny, c)
    return Vec3(g(d.x), g(d.y), g(d.z))


def _sub(v: Vec3, idx) -> Vec3:
    return Vec3(v.x[idx], v.y[idx], v.z[idx])


def _proto_query(scene, p: int, op: Vec3, dp: Vec3, maxt, closest: bool):
    """Prototype p's closest hit (t, prim, uv, valid) or any-hit on
    prototype-space rays that all picked it."""
    from ..ops import cellserve, intersect as ops_intersect
    acc = scene.proto_accels[p]
    if acc is not None:
        return (cellserve.intersect_cells(acc, op, dp, maxt) if closest
                else cellserve.occluded_cells(acc, op, dp, maxt))
    tris = scene.proto_soa(p)
    return (ops_intersect.intersect_naive(op, dp, maxt, *tris, chunk=256)
            if closest else
            ops_intersect.occluded_naive(op, dp, maxt, *tris, chunk=256))


def _round_rays(inst, o: Vec3, d: Vec3, inv: Vec3, cap, tf, jf):
    """One round's candidate per live lane: (t_next, j_next, the
    prototype-space origin and direction, the prototype slot)."""
    tn, jn = _successor_candidate(inst, o, inv, cap, tf, jf)
    m12 = inst.to_proto[jn.long()]
    pj = inst.proto_of[jn.long()]
    return tn, jn, affine_apply(m12, o), linear_apply(m12, d), pj


def intersect_instances(scene, o: Vec3, d: Vec3, maxt, active):
    """Closest instanced hit -> (t, prim, uv, inst, valid); prim is a
    global face-table index (prototype faces live in the table in
    prototype space)."""
    inst: InstanceTable = scene.instances
    n_inst = inst.proto_of.shape[0]
    o = Vec3(o.x.detach(), o.y.detach(), o.z.detach())
    d = Vec3(d.x.detach(), d.y.detach(), d.z.detach())
    n = o.x.shape[0]
    dev = o.x.device
    maxt = torch.as_tensor(maxt, dtype=torch.float32,
                           device=dev).detach().expand(n)
    inv = _guard_inv(d)
    bt = torch.full((n,), BIG, dtype=torch.float32, device=dev)
    bp = torch.full((n,), -1, dtype=torch.int32, device=dev)
    bu = torch.zeros(n, dtype=torch.float32, device=dev)
    bv = torch.zeros(n, dtype=torch.float32, device=dev)
    bi = torch.full((n,), -1, dtype=torch.int32, device=dev)
    tf = torch.full((n,), -1.0, dtype=torch.float32, device=dev)
    jf = torch.full((n,), -1, dtype=torch.int32, device=dev)
    live = torch.nonzero(active).squeeze(1)
    for _ in range(n_inst):
        if live.shape[0] == 0:
            break
        ol, dl = _sub(o, live), _sub(d, live)
        cap = torch.minimum(bt[live], maxt[live])
        tn, jn, op, dp, pj = _round_rays(inst, ol, dl, _sub(inv, live), cap,
                                         tf[live], jf[live])
        go = tn < BIG
        qt = torch.full_like(tn, BIG)
        qp = torch.full_like(jn, -1)
        qu = torch.zeros_like(tn)
        qv = torch.zeros_like(tn)
        for p, (base, _count) in enumerate(scene.proto_ranges):
            sel = torch.nonzero(go & (pj == p)).squeeze(1)
            if sel.shape[0] == 0:
                continue
            tp, prp, uvp, vp = _proto_query(scene, p, _sub(op, sel),
                                            _sub(dp, sel), cap[sel], True)
            better = vp & (tp < qt[sel])
            qt[sel] = torch.where(better, tp, qt[sel])
            qp[sel] = torch.where(better, base + prp, qp[sel])
            qu[sel] = torch.where(better, uvp.x, qu[sel])
            qv[sel] = torch.where(better, uvp.y, qv[sel])
        better = (qp >= 0) & (qt < bt[live])
        bt[live] = torch.where(better, qt, bt[live])
        bp[live] = torch.where(better, qp, bp[live])
        bu[live] = torch.where(better, qu, bu[live])
        bv[live] = torch.where(better, qv, bv[live])
        bi[live] = torch.where(better, jn, bi[live])
        tf[live] = torch.where(go, tn, BIG)
        jf[live] = torch.where(go, jn, n_inst)
        live = live[go]
    valid = (bp >= 0) & (bt < maxt) & active
    return (torch.where(valid, bt, BIG), torch.where(valid, bp, -1),
            Vec2(bu, bv), torch.where(valid, bi, -1), valid)


def occluded_instances(scene, o: Vec3, d: Vec3, maxt, active):
    """Any instanced hit strictly inside (0, maxt) -> bool [N]."""
    inst: InstanceTable = scene.instances
    n_inst = inst.proto_of.shape[0]
    o = Vec3(o.x.detach(), o.y.detach(), o.z.detach())
    d = Vec3(d.x.detach(), d.y.detach(), d.z.detach())
    n = o.x.shape[0]
    dev = o.x.device
    maxt = torch.as_tensor(maxt, dtype=torch.float32,
                           device=dev).detach().expand(n)
    inv = _guard_inv(d)
    occ = torch.zeros(n, dtype=torch.bool, device=dev)
    tf = torch.full((n,), -1.0, dtype=torch.float32, device=dev)
    jf = torch.full((n,), -1, dtype=torch.int32, device=dev)
    live = torch.nonzero(active).squeeze(1)
    for _ in range(n_inst):
        if live.shape[0] == 0:
            break
        tn, jn, op, dp, pj = _round_rays(inst, _sub(o, live), _sub(d, live),
                                         _sub(inv, live), maxt[live],
                                         tf[live], jf[live])
        go = tn < BIG
        hit = torch.zeros_like(go)
        for p in range(len(scene.proto_ranges)):
            sel = torch.nonzero(go & (pj == p)).squeeze(1)
            if sel.shape[0]:
                hit[sel] = _proto_query(scene, p, _sub(op, sel),
                                        _sub(dp, sel), maxt[live][sel],
                                        False)
        occ[live] = hit
        go = go & ~hit
        tf[live] = torch.where(go, tn, BIG)
        jf[live] = torch.where(go, jn, n_inst)
        live = live[go]
    return occ & active
