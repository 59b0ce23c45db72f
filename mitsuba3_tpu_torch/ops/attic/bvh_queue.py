"""K-queue round traversal — counterpart of
``mitsuba3_tpu/ops/attic/bvh_queue.py``.

bvh_serve's leaves (the same build), with each cull amortised over up to
KQ leaf visits:

  1. CULL (kernel K6: K2's ``csrc/bvh_serve_cull.cu`` with KQ keys): each
     ray's KQ nearest unvisited leaves as packed keys (entry bits >> 16
     << 16 | leaf id + 1), ascending;
  2. SORT the ray state by the head of its queue (stable);
  3. SCHEDULE (plain torch): per 128-ray block, T steps of popping the
     block's smallest head leaf (and pruning heads whose entry is past the
     ray's best t) give a schedule of T leaf ids;
  4. SERVE (kernel K7, ``csrc/bvh_queue_serve.cu``): per block, every
     scheduled slab is folded into every ray of the block; at widths up to
     2 * MIN_W an exact per-lane gather of each ray's own queue serves
     instead.
  Rays whose queue ran dry with more candidates left (the sign bit of the
  cursor) are culled again; the width ladder compacts the live rays into
  narrower levels.

The round loop is a host loop that reads the live count (JAX's
``lax.while_loop`` and ``lax.cond``), and the sorts are stable, as JAX's
``lax.sort`` is. The ray state is bvh_serve's float rows (OX..V) and int
rows (PRIM, LK, RID) with the KQ queue rows after them, permuted together
by each sort.
"""
from __future__ import annotations

import functools

import torch

from ...core.vec import Vec2, Vec3
from .. import bvh_serve as bs
from .. import native
from ..bvh_serve import (BIG, BLK, LK, MIN_W, NONE, PRIM, RCHUNK, RID,
                         SHRINK_DIV, TB, U, V, BVHServe, _lanes, _mt_best)
from ..bvh_tiled import real_tris

KQ = 8             # queued nearest leaves per ray per cull
T = 16             # scheduled leaf slabs per 128-ray block per serve
K = bs.K           # triangles per leaf
Q0 = 3             # int rows Q0 .. Q0 + KQ - 1: the queue, ascending
SIGN = -0x80000000  # cursor flag: the last cull filled all KQ slots
MASK31 = 0x7FFFFFFF
INT32_MIN = -0x80000000
PLAIN_BLOCKS = 256   # blocks per step of serve_multi_plain ([256, 128, 128])
GATHER_LANES = 8192  # lanes per step of the gather serve ([8192, 10, K])

build = bs.build   # bvh_serve's leaves and layout

# Kernel launches of `cull_topk` (K6) and `serve_multi` (K7). Only the
# wrappers add to these, and only where they launch a CUDA kernel; callers
# reset them to 0.
LAUNCHES = {"cull": 0, "serve": 0}


# ---------------------------------------------------------------------------
# Cull: kernel K6 and its plain version
# ---------------------------------------------------------------------------

def cull_topk_plain(acc: BVHServe, geo, lk, stats: dict | None = None):
    """Plain PyTorch version of K6: geo [R >= 7, npad] f32 (rows ox oy oz
    dx dy dz tb), lk [npad] i32 -> [KQ, npad] i32, each ray's KQ smallest
    valid keys ascending, NONE-padded: bvh_serve's cull with KQ ranks (its
    `stats` too)."""
    return bs.cull_plain(acc.replace(topk=KQ), geo, lk, stats)


def cull_topk(acc: BVHServe, geo, lk):
    """K6 (arguments as cull_topk_plain's). CPU tensors take the plain
    version; CUDA tensors launch K2's kernel of csrc/bvh_serve_cull.cu with
    KQ keys on the current stream."""
    if native.on_cpu(geo, lk, acc.bounds, acc.sup):
        return cull_topk_plain(acc, geo, lk)
    dev = geo.device
    if dev.type != "cuda":
        raise ValueError(f"cull_topk: rays on {dev}; the kernel needs every "
                         f"tensor on one CUDA device")
    npad = geo.shape[1]
    if npad % RCHUNK:
        raise ValueError(f"cull_topk: width {npad} is not a multiple of "
                         f"{RCHUNK}")
    check = functools.partial(native.check, "cull_topk")
    check("geo", geo, torch.float32, (geo.shape[0], npad), dev)
    if geo.shape[0] < 7:
        raise ValueError("cull_topk: geo needs rows ox oy oz dx dy dz tb")
    check("lk", lk, torch.int32, (npad,), dev)
    check("bounds", acc.bounds, torch.float32, (8, acc.m_pad), dev)
    check("sup", acc.sup, torch.float32, tuple(acc.sup.shape), dev)
    queue = torch.empty((KQ, npad), dtype=torch.int32, device=dev)
    if npad == 0:
        return queue
    native.launch("bvh_serve_cull", "ppiiippipi", acc.bounds.data_ptr(),
                  acc.sup.data_ptr(), acc.m_pad, acc.sup.shape[1],
                  acc.n_leaves, geo.data_ptr(), lk.data_ptr(),
                  npad // RCHUNK, queue.data_ptr(), KQ, dev=dev)
    LAUNCHES["cull"] += 1
    return queue


# ---------------------------------------------------------------------------
# Schedule: the per-block pop simulation (plain torch, as JAX's is XLA)
# ---------------------------------------------------------------------------

def _entry_lb(keys):
    """A key's entry distance rounded down to its top 16 bits (f32)."""
    return (keys & -65536).view(torch.float32)


def simulate(queue, tb):
    """queue [KQ, npad] ascending keys, tb [npad] -> (lids [nblk, T] leaf
    ids or -1, q_after [KQ, npad], lk_pop [npad], the largest popped key or
    INT32_MIN). Each of T steps pops, per ray, a head whose entry is >= its
    tb (pruned) or whose leaf is its block's smallest head leaf (served)."""
    npad = queue.shape[1]
    nblk = npad // BLK
    q = queue.reshape(KQ, nblk, BLK)
    tb2 = tb.reshape(nblk, BLK)
    lkm = torch.full((nblk, BLK), INT32_MIN, dtype=torch.int32,
                     device=queue.device)
    none_row = torch.full((1, nblk, BLK), NONE, dtype=torch.int32,
                          device=queue.device)
    lids = []
    for _ in range(T):
        head = q[0]
        has = head != NONE
        prunable = has & (_entry_lb(head) >= tb2)
        valid = has & ~prunable
        leaf = torch.where(valid, (head & 0xFFFF) - 1, 2 ** 30)
        lid = leaf.amin(dim=1)
        pop = (valid & (leaf == lid[:, None])) | prunable
        lkm = torch.maximum(lkm, torch.where(pop, head, INT32_MIN))
        q = torch.where(pop[None], torch.cat([q[1:], none_row]), q)
        lids.append(torch.where(lid < 2 ** 30, lid, -1))
    return (torch.stack(lids, dim=1), q.reshape(KQ, npad),
            lkm.reshape(npad))


# ---------------------------------------------------------------------------
# Serve: kernel K7 and its plain version
# ---------------------------------------------------------------------------

def serve_multi_plain(acc: BVHServe, lids, rays, stats: dict | None = None):
    """Plain PyTorch version of K7: lids [nblk, T] i32 (leaf id or -1),
    rays [R >= 7, npad] f32 (ox oy oz dx dy dz tb) -> (t, prim, u, v)
    [npad]: every scheduled slab of a block folded into every ray of it,
    a slab replacing the running result only with a strictly smaller t,
    the t bound dropping to the running t after each. Runs PLAIN_BLOCKS
    blocks at a time. With `stats`, adds to stats["slots"] the (block, slot)
    pairs taken and to stats["tests"] the ray-triangle tests this data
    needs: per taken slot and ray whose bound is >= 0, the slab's real
    triangles."""
    npad = rays.shape[1]
    nb = npad // BLK
    dev = rays.device
    t_o = torch.full((nb, BLK), BIG, dtype=torch.float32, device=dev)
    p_o = torch.full((nb, BLK), -1, dtype=torch.int32, device=dev)
    u_o = torch.zeros((nb, BLK), dtype=torch.float32, device=dev)
    v_o = torch.zeros_like(u_o)
    rs = rays[:7].reshape(7, nb, BLK)
    tbc = rs[TB].clone()
    for c0 in range(0, nb, PLAIN_BLOCKS):
        c1 = min(c0 + PLAIN_BLOCKS, nb)
        for s in range(T):
            lid = lids[c0:c1, s]
            rows = c0 + torch.nonzero(lid >= 0).squeeze(1)
            if rows.numel() == 0:
                continue
            r = [rs[a, rows][:, None, :] for a in range(6)]
            tb = tbc[rows]
            slab = acc.tris[lids[rows, s].long()]
            tmin, prim, uu, vv = _mt_best(slab, tuple(r[:3]), tuple(r[3:6]),
                                          tb[:, None, :])
            if stats is not None:
                stats["slots"] = stats.get("slots", 0) + rows.numel()
                stats["tests"] = stats.get("tests", 0) + int(
                    ((tb >= 0.0).sum(dim=1) * real_tris(slab)).sum())
            better = (prim >= 0) & (tmin < t_o[rows])
            t_o[rows] = torch.where(better, tmin, t_o[rows])
            p_o[rows] = torch.where(better, prim, p_o[rows])
            u_o[rows] = torch.where(better, uu, u_o[rows])
            v_o[rows] = torch.where(better, vv, v_o[rows])
            tbc[rows] = torch.minimum(tb, t_o[rows])
    return tuple(x.reshape(-1) for x in (t_o, p_o, u_o, v_o))


def serve_multi(acc: BVHServe, lids, rays):
    """K7: fold each 128-ray block's schedule (arguments as
    serve_multi_plain's). CPU tensors take the plain version; CUDA tensors
    launch the kernel of csrc/bvh_queue_serve.cu on the current stream."""
    if native.on_cpu(lids, rays, acc.tris):
        return serve_multi_plain(acc, lids, rays)
    dev = rays.device
    if dev.type != "cuda":
        raise ValueError(f"serve_multi: rays on {dev}; the kernel needs "
                         f"every tensor on one CUDA device")
    npad = rays.shape[1]
    nb = npad // BLK
    if npad % BLK:
        raise ValueError(f"serve_multi: width {npad} is not a multiple of "
                         f"{BLK}")
    check = functools.partial(native.check, "serve_multi")
    check("lids", lids, torch.int32, (nb, T), dev)
    check("rays", rays, torch.float32, (rays.shape[0], npad), dev)
    if rays.shape[0] < 7:
        raise ValueError("serve_multi: rays needs rows ox oy oz dx dy dz tb")
    check("tris", acc.tris, torch.float32, (acc.tris.shape[0], 16, K), dev)
    t = torch.empty(npad, dtype=torch.float32, device=dev)
    p = torch.empty(npad, dtype=torch.int32, device=dev)
    u = torch.empty_like(t)
    v = torch.empty_like(t)
    if nb == 0:
        return t, p, u, v
    native.launch("bvh_queue_serve", "pppipppp", lids.data_ptr(),
                  acc.tris.data_ptr(), rays.data_ptr(), nb, t.data_ptr(),
                  p.data_ptr(), u.data_ptr(), v.data_ptr(), dev=dev)
    LAUNCHES["serve"] += 1
    return t, p, u, v


def _gather_serve_queue(acc: BVHServe, f, queue):
    """The exact narrow-width serve: per lane, a row gather of each queued
    leaf in turn, skipping keys whose entry is past the lane's bound."""
    npad = f.shape[1]
    dev = f.device
    t_o = torch.full((npad,), BIG, dtype=torch.float32, device=dev)
    p_o = torch.full((npad,), -1, dtype=torch.int32, device=dev)
    u_o = torch.zeros(npad, dtype=torch.float32, device=dev)
    v_o = torch.zeros_like(u_o)
    for c0 in range(0, npad, GATHER_LANES):
        c1 = min(c0 + GATHER_LANES, npad)
        r = [f[a, c0:c1][:, None, None] for a in range(6)]
        tc, pc, uc, vc = t_o[c0:c1], p_o[c0:c1], u_o[c0:c1], v_o[c0:c1]
        tbc = f[TB, c0:c1]
        for k in range(KQ):
            key = queue[k, c0:c1]
            act = (key != NONE) & (_entry_lb(key) < tbc)
            lf = torch.clamp(torch.where(act, (key & 0xFFFF) - 1, 0), 0,
                             acc.n_leaves - 1)
            tt, pp, ut, vt = (x[:, 0] for x in _mt_best(
                acc.tris[lf.long(), :10], tuple(r[:3]), tuple(r[3:6]),
                tbc[:, None, None]))
            better = act & (pp >= 0) & (tt < tc)
            tc.copy_(torch.where(better, tt, tc))
            pc.copy_(torch.where(better, pp, pc))
            uc.copy_(torch.where(better, ut, uc))
            vc.copy_(torch.where(better, vt, vc))
            tbc = torch.minimum(tbc, tc)
    return t_o, p_o, u_o, v_o


# ---------------------------------------------------------------------------
# Round loop: cull -> [sort -> simulate -> serve -> re-cull]*
# ---------------------------------------------------------------------------

def _live(i):
    """A lane is live with a queued key, or with a full last cull (sign
    flag of the cursor): more candidates may lie past its cursor."""
    return (i[Q0] != NONE) | (i[LK] < 0)


def fresh_cull(acc: BVHServe, f, i):
    """Re-cull the lanes whose queue is empty (keeping the others) -> new
    int rows."""
    q = cull_topk(acc, f, (i[LK] & MASK31).contiguous())
    keep = i[Q0] != NONE
    i = i.clone()
    i[Q0:] = torch.where(keep[None], i[Q0:], q)
    qfull = q[KQ - 1] != NONE
    i[LK] = torch.where(keep, i[LK], torch.where(qfull, i[LK] | SIGN,
                                                 i[LK] & MASK31))
    return i


def sort_by_head(acc: BVHServe, f, i):
    """The state sorted (stable) by the leaf at the head of each queue;
    lanes with an empty queue last."""
    head = i[Q0]
    leaf = torch.where(head != NONE, (head & 0xFFFF) - 1, acc.m_pad)
    _, perm = torch.sort(leaf, stable=True)
    return f[:, perm], i[:, perm]


def _serve_cycle(acc: BVHServe, f, i, closest: bool):
    """One sort + simulate + serve cycle over the current queues."""
    npad = f.shape[1]
    f, i = sort_by_head(acc, f, i)
    queue = i[Q0:]
    if npad <= 2 * MIN_W:
        # narrow widths: each lane's own queue, KQ pops deep, exactly (JAX
        # also simulates a schedule here, and drops it)
        ct, cp, cu, cv = _gather_serve_queue(acc, f, queue)
        lk_pop = torch.where(queue != NONE, queue, INT32_MIN).amax(dim=0)
        q_after = torch.full_like(queue, NONE)
    else:
        lids, q_after, lk_pop = simulate(queue, f[TB])
        ct, cp, cu, cv = serve_multi(acc, lids, f)
    hit = (cp >= 0) & (ct < f[TB])
    f[TB] = torch.where(hit, ct, f[TB])
    i[PRIM] = torch.where(hit, cp, i[PRIM])
    f[U] = torch.where(hit, cu, f[U])
    f[V] = torch.where(hit, cv, f[V])
    # the cursor passes every popped key (pruned or served); the sign flag
    # of the last cull stays
    i[LK] = torch.maximum(i[LK] & MASK31, lk_pop) | (i[LK] & SIGN)
    i[Q0:] = q_after
    if not closest:
        done = (i[PRIM] >= 0) | (i[RID] < 0)
        i[LK] = torch.where(done, NONE, i[LK])
        i[Q0:] = torch.where(done[None], NONE, i[Q0:])
    return f, i


def _run_level(acc: BVHServe, f, i, closest: bool, max_rounds: int):
    """Cycles at this width; once the live lanes fit in width / SHRINK_DIV,
    compact them into a prefix and recurse one level narrower."""
    npad = f.shape[1]
    thresh = -(-(npad // SHRINK_DIV) // RCHUNK) * RCHUNK
    shrink = MIN_W <= thresh < npad
    loop_thresh = thresh if shrink else 0
    i = fresh_cull(acc, f, i)
    n_live = int(_live(i).sum())
    r = 0
    while n_live > loop_thresh and r < max_rounds:
        f, i = _serve_cycle(acc, f, i, closest)
        n_live = int(_live(i).sum())
        # the re-cull only matters if another cycle runs at this width
        if n_live > loop_thresh:
            i = fresh_cull(acc, f, i)
        r += 1
    if not shrink:
        return f, i
    _, perm = torch.sort(torch.where(_live(i), 0, 1), stable=True)
    f = f[:, perm]
    i = i[:, perm]
    f_sub, i_sub = _run_level(acc, f[:, :thresh].contiguous(),
                              i[:, :thresh].contiguous(), closest,
                              max_rounds)
    return (torch.cat([f_sub, f[:, thresh:]], dim=1),
            torch.cat([i_sub, i[:, thresh:]], dim=1))


def initial_state(o: Vec3, d: Vec3, maxt):
    """bvh_serve's padded ray state with KQ empty queue rows."""
    f, i = bs.initial_state(o, d, maxt)
    queue = torch.full((KQ, f.shape[1]), NONE, dtype=torch.int32,
                       device=f.device)
    return f, torch.cat([i, queue])


def _trace(acc: BVHServe, o: Vec3, d: Vec3, maxt, closest: bool):
    """-> (t, prim, u, v) [N] in the caller's order; t is the final best
    distance bound."""
    n = o.x.shape[0]
    f, i = initial_state(o, d, maxt)
    f, i = _run_level(acc, f, i, closest, 4 * acc.n_leaves + 8)
    real = i[RID] >= 0
    rid = i[RID][real].long()
    outs = []
    for x in (f[TB], i[PRIM], f[U], f[V]):
        y = torch.empty(n, dtype=x.dtype, device=x.device)
        y[rid] = x[real]
        outs.append(y)
    return tuple(outs)


def intersect_bvh(acc: BVHServe, o: Vec3, d: Vec3, maxt, active=None):
    """Closest hit -> (t [N] (maxt where none), prim [N], uv Vec2,
    valid [N])."""
    maxt, mt = _lanes(o, maxt, active)
    t, prim, u, v = _trace(acc, o, d, mt, closest=True)
    valid = prim >= 0
    return torch.where(valid, t, maxt), prim, Vec2(u, v), valid


def occluded_bvh(acc: BVHServe, o: Vec3, d: Vec3, maxt, active=None):
    """Any hit with t in [0, maxt] -> bool [N]."""
    _, mt = _lanes(o, maxt, active)
    return _trace(acc, o, d, mt, closest=False)[1] >= 0
