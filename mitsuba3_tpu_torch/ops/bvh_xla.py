"""Per-lane stackless BVH traversal (``MI3T_ACCEL=xla``, the default
above 8192 faces on a CPU device) — counterpart of
``mitsuba3_tpu/ops/bvh_xla.py``.

Every lane walks its own path through a binary SAH tree (leaves of KL = 4
triangles) with the parent-pointer state machine of Hapala et al. 2011:
the per-lane state is (node, came_from), and each step tests one node box,
or the four triangles of a leaf it enters, on every lane at once.

The build uses the SAH builder (``native.build_bvh``), the same C++ as the
JAX package's, so ``build`` is bit-equal to its build. Unlike JAX it never
falls back to the median split: a failed build raises.

Eager-PyTorch differences from the JAX package, none of which changes a
result: the host looks at the live lanes every CHECK_EVERY steps, not after
each (a finished lane is a no-op in a step), and once at most half of the
lanes in the loop are live, the loop goes on with those lanes only. A
leaf's four triangles are tested together and the first of the nearest
wins, as JAX's strict updates in order pick it.
"""
from __future__ import annotations

import numpy as np
import torch

from .. import native as native_bvh
from ..core.struct import struct
from ..core.vec import Vec2, Vec3

KL = 4            # leaf capacity
CHECK_EVERY = 8   # traversal steps between the host's looks at the lanes

# came_from states (Hapala et al. 2011)
FROM_PARENT = 0
FROM_SIBLING = 1
FROM_CHILD = 2

# Traversal steps run and queries made, by mode, summed over queries.
# Only the queries add to these; callers reset them to 0.
STEPS = {"closest": 0, "anyhit": 0}
QUERIES = {"closest": 0, "anyhit": 0}


@struct
class BVHXLA:
    bounds: torch.Tensor   # [Nn, 6] f32 (min.xyz, max.xyz)
    left: torch.Tensor     # [Nn] i32 (child, or -leaf-1 at a leaf)
    right: torch.Tensor    # [Nn] i32
    parent: torch.Tensor   # [Nn] i32 (-1 at the root)
    is_left: torch.Tensor  # [Nn] bool: the node is its parent's left child
    tri: torch.Tensor      # [9, L*KL] f32 component rows (p0, e1, e2)
    prim: torch.Tensor     # [L*KL] i32 original triangle id (-1 pad)
    n_nodes: int = 0


def build(p0, e1, e2, leaf_size=KL, *, device) -> BVHXLA:
    """SAH tree with parent links and leaf triangle rows on `device`, as
    the JAX build makes them."""
    p0 = np.asarray(p0, np.float32)
    e1 = np.asarray(e1, np.float32)
    e2 = np.asarray(e2, np.float32)
    v1, v2 = p0 + e1, p0 + e2
    bbmin = np.minimum(np.minimum(p0, v1), v2)
    bbmax = np.maximum(np.maximum(p0, v1), v2)
    order, nb, nm, lf, lc = native_bvh.build_bvh(bbmin, bbmax, leaf_size)
    n_nodes = nb.shape[0]
    m1, m2 = nm[:, 0].astype(np.int32), nm[:, 1].astype(np.int32)
    inner = np.nonzero(m1 >= 0)[0]
    # a leaf stores -(leaf id)-1 in left and right
    right = np.where(m1 >= 0, m2, m1).astype(np.int32)
    parent = np.full(n_nodes, -1, np.int32)
    parent[m1[inner]] = inner
    parent[m2[inner]] = inner
    is_left = np.zeros(n_nodes, bool)
    is_left[m1[inner]] = True

    slots = np.full((len(lf), leaf_size), -1, np.int64)
    k = np.arange(leaf_size)
    fill = k[None, :] < np.asarray(lc)[:, None]
    slots[fill] = order[(np.asarray(lf)[:, None] + k[None, :])[fill]]
    flat = slots.reshape(-1)
    valid = flat >= 0
    src = np.where(valid, flat, 0)
    tri = np.stack([np.where(valid, arr[src], 0.0).astype(np.float32)
                    for arr in (p0[:, 0], p0[:, 1], p0[:, 2],
                                e1[:, 0], e1[:, 1], e1[:, 2],
                                e2[:, 0], e2[:, 1], e2[:, 2])], 0)

    def t(a):
        return torch.as_tensor(a, device=device)

    return BVHXLA(bounds=t(np.asarray(nb, np.float32)), left=t(m1),
                  right=t(right), parent=t(parent), is_left=t(is_left),
                  tri=t(tri), prim=t(flat.astype(np.int32)),
                  n_nodes=n_nodes)


def _aabb_hit(bounds, node, o, inv, tmax):
    b = bounds[node]  # [N, 6]
    t0x = (b[:, 0] - o[0]) * inv[0]
    t1x = (b[:, 3] - o[0]) * inv[0]
    tn = torch.minimum(t0x, t1x)
    tf = torch.maximum(t0x, t1x)
    t0y = (b[:, 1] - o[1]) * inv[1]
    t1y = (b[:, 4] - o[1]) * inv[1]
    tn = torch.maximum(tn, torch.minimum(t0y, t1y))
    tf = torch.minimum(tf, torch.maximum(t0y, t1y))
    t0z = (b[:, 2] - o[2]) * inv[2]
    t1z = (b[:, 5] - o[2]) * inv[2]
    tn = torch.maximum(tn, torch.minimum(t0z, t1z))
    tf = torch.minimum(tf, torch.maximum(t0z, t1z))
    return (tn <= tf) & (tf >= 0.0) & (tn <= tmax)


def _leaf_intersect(leaf_rows, leaf, o, d, best_t):
    """The KL triangles of each lane's leaf (Möller–Trumbore, JAX's
    arithmetic) -> (t, slot, u, v); slot -1 where none is nearer than
    best_t. `leaf_rows` is [L, KL, 9]."""
    r = leaf_rows[leaf]  # [N, KL, 9]
    p0x, p0y, p0z = r[..., 0], r[..., 1], r[..., 2]
    e1x, e1y, e1z = r[..., 3], r[..., 4], r[..., 5]
    e2x, e2y, e2z = r[..., 6], r[..., 7], r[..., 8]
    ox, oy, oz = (a[:, None] for a in o)
    dx, dy, dz = (a[:, None] for a in d)
    pvx = dy * e2z - dz * e2y
    pvy = dz * e2x - dx * e2z
    pvz = dx * e2y - dy * e2x
    det = e1x * pvx + e1y * pvy + e1z * pvz
    ok = det != 0.0
    inv_det = torch.where(ok, 1.0 / torch.where(ok, det, 1.0), 0.0)
    tvx, tvy, tvz = ox - p0x, oy - p0y, oz - p0z
    u = (tvx * pvx + tvy * pvy + tvz * pvz) * inv_det
    qvx = tvy * e1z - tvz * e1y
    qvy = tvz * e1x - tvx * e1z
    qvz = tvx * e1y - tvy * e1x
    v = (dx * qvx + dy * qvy + dz * qvz) * inv_det
    t = (e2x * qvx + e2y * qvy + e2z * qvz) * inv_det
    hit = (ok & (u >= 0.0) & (v >= 0.0) & (u + v <= 1.0) & (t >= 1e-6)
           & (t < best_t[:, None]))
    t_m = torch.where(hit, t, float("inf"))
    t_min = t_m.amin(dim=1)
    # JAX updates in slot order on a strictly smaller t: the first of the
    # nearest wins
    k = (hit & (t_m == t_min[:, None])).to(torch.uint8).argmax(dim=1,
                                                               keepdim=True)
    any_hit = hit.any(dim=1)
    slot = torch.where(any_hit, leaf * KL + k[:, 0], -1)
    return (torch.where(any_hit, t_min, best_t), slot,
            u.gather(1, k)[:, 0], v.gather(1, k)[:, 0])


def _traverse(bvh: BVHXLA, o: Vec3, d: Vec3, maxt, any_hit: bool):
    """Every lane's walk -> (t, slot, u, v) [N] each (slot -1: no hit)."""
    mode = "anyhit" if any_hit else "closest"
    QUERIES[mode] += 1
    n = o.x.shape[0]
    dev = o.x.device
    eps = 1e-20

    def safe_inv(x):
        return 1.0 / torch.where(x.abs() < eps,
                                 torch.where(x >= 0, eps, -eps), x)

    left = bvh.left.long()
    right = bvh.right.long()
    parent = bvh.parent.long()
    leaf_rows = bvh.tri.T.reshape(-1, KL, 9)
    best_t = torch.where(maxt > 0.0, maxt, -1.0)
    t_out = best_t.clone()
    slot_out = torch.full((n,), -1, dtype=torch.int64, device=dev)
    u_out = torch.zeros(n, dtype=torch.float32, device=dev)
    v_out = torch.zeros(n, dtype=torch.float32, device=dev)

    # the loop's lanes: their ids and state
    lanes = torch.nonzero(maxt > 0.0)[:, 0]
    if lanes.numel() == 0:
        return t_out, slot_out, u_out, v_out
    o3 = tuple(a[lanes] for a in (o.x, o.y, o.z))
    d3 = tuple(a[lanes] for a in (d.x, d.y, d.z))
    inv = tuple(safe_inv(a) for a in d3)
    w = lanes.numel()
    node = torch.zeros(w, dtype=torch.int64, device=dev)
    come = torch.full((w,), FROM_PARENT, dtype=torch.int64, device=dev)
    act = torch.ones(w, dtype=torch.bool, device=dev)
    t = best_t[lanes]
    slot = torch.full((w,), -1, dtype=torch.int64, device=dev)
    u = torch.zeros(w, dtype=torch.float32, device=dev)
    v = torch.zeros(w, dtype=torch.float32, device=dev)
    steps = 0
    while True:
        for _ in range(CHECK_EVERY):
            entering = come != FROM_CHILD
            lchild = left[node]
            par = parent[node]
            i_am_left = bvh.is_left[node]
            is_leaf = lchild < 0
            hit = _aabb_hit(bvh.bounds, node, o3, inv, t) & entering & act
            do_leaf = hit & is_leaf
            t2, slot2, u2, v2 = _leaf_intersect(
                leaf_rows, torch.clamp(-lchild - 1, min=0), o3, d3, t)
            upd = do_leaf & (slot2 >= 0)
            t = torch.where(upd, t2, t)
            slot = torch.where(upd, slot2, slot)
            u = torch.where(upd, u2, u)
            v = torch.where(upd, v2, v)
            if any_hit:
                # the first hit ends the lane
                act = act & ~upd
            descend = hit & ~is_leaf & act
            go_up = act & ~descend   # a miss, a leaf done, or from a child
            # a left child's sibling is its parent's right child
            sib = torch.where(i_am_left, right[torch.clamp(par, min=0)],
                              par)
            next_come = torch.where(i_am_left, FROM_SIBLING, FROM_CHILD)
            done = go_up & (par < 0)
            new_node = torch.where(descend, lchild,
                                   torch.where(go_up, sib, node))
            new_come = torch.where(descend, FROM_PARENT,
                                   torch.where(go_up, next_come, come))
            act = act & ~done
            node = torch.where(act, new_node, node)
            come = torch.where(act, new_come, come)
        steps += CHECK_EVERY
        live = torch.nonzero(act)[:, 0]
        n_live = live.numel()
        if n_live == 0 or 2 * n_live <= act.shape[0]:
            t_out[lanes], slot_out[lanes] = t, slot
            u_out[lanes], v_out[lanes] = u, v
            if n_live == 0:
                break
            lanes = lanes[live]
            o3, d3, inv = (tuple(a[live] for a in g) for g in (o3, d3, inv))
            node, come, act, t, slot, u, v = (
                a[live] for a in (node, come, act, t, slot, u, v))
    STEPS[mode] += steps
    return t_out, slot_out, u_out, v_out


def _lanes_maxt(o: Vec3, maxt, active):
    """maxt per lane (detached), -1 on the inactive lanes."""
    maxt = torch.as_tensor(maxt, dtype=torch.float32,
                           device=o.x.device).detach().expand(o.x.shape[0])
    if active is not None:
        maxt = torch.where(active, maxt, -1.0)
    return maxt


def intersect_bvh(bvh: BVHXLA, o: Vec3, d: Vec3, maxt, active=None):
    """Closest hit -> (t [N], prim [N] i32 (original ids), uv Vec2,
    valid [N])."""
    t, slot, u, v = _traverse(
        bvh, o.detach(), d.detach(),
        torch.clamp(_lanes_maxt(o, maxt, active), max=3e38), any_hit=False)
    valid = slot >= 0
    prim = torch.where(valid, bvh.prim[torch.clamp(slot, min=0)], -1)
    return t, prim, Vec2(u, v), valid


def occluded_bvh(bvh: BVHXLA, o: Vec3, d: Vec3, maxt, active=None):
    """Any hit within maxt -> bool [N]."""
    _, slot, _, _ = _traverse(bvh, o.detach(), d.detach(),
                              _lanes_maxt(o, maxt, active), any_hit=True)
    return slot >= 0
