"""Round-based nearest-leaf intersector — counterpart of
``mitsuba3_tpu/ops/bvh_serve.py`` (``MI3T_ACCEL=serve``).

Every ray converges on its own nearest unvisited leaf each round, and
leaves are served to dense ray blocks:

  round:
    1. CULL (kernel K2, ``csrc/bvh_serve_cull.cu``): per ray, the TOPK
       smallest packed keys (f32 entry bits >> 16 << 16 | leaf id + 1) over
       the leaves it enters with entry < its best t and key > its last
       served key. The kernel skips a 128-leaf chunk for 32 rays none of
       which enters it, and a ray whose cursor is NONE (it is done).
    2. SORT by requested leaf (stable): rays wanting the same leaf become
       contiguous, and the inert ones sort to the end.
    3. SERVE:
       - many live rays: kernel K3 (``csrc/bvh_serve_serve.cu``) tests each
         128-ray block against its first and last requested leaf per rank;
         a ray whose leaf is neither retries next round (its cursor only
         advances when served);
       - few live rays (at most a TAIL_DIV-th of the width): they form a
         prefix, and a per-lane leaf gather serves every one exactly.
  The width ladder halves the state (prefix compaction) once the live rays
  fit, so straggler rounds run narrow. A final scatter by ray id restores
  the caller's order.

The leaves are ``bvh_tiled``'s SAH build. Eager-PyTorch differences from
the JAX package, none of which changes a hit: the sorts are stable, the
gather serve runs on exactly the live prefix, in chunks, and the round
loops are host loops that read the live count. Ties between equal-t hits
in different leaves follow the order in which leaves are served.
"""
from __future__ import annotations

import functools

import numpy as np
import torch

from ..core.struct import struct
from ..core.vec import Vec2, Vec3
from . import bvh_tiled, native

K = 128          # triangles per leaf
LC = 128         # leaves per cull chunk
RCHUNK = 512     # rays per cull block; width granularity
BLK = 128        # rays per serve block (one CTA of K3)
TAIL_DIV = 8     # gather serve when live rays <= width / TAIL_DIV
TOPK = 1         # default leaf visits per round
MAX_TOPK = 2     # K2 and K3 are built for topk 1 and 2
NONE = 0x7FFFFFFF  # no key (keys fit in 31 bits: entry >= 0)
BIG = 3.4e38
MIN_W = 4096     # narrowest ladder width
SHRINK_DIV = 2   # drop a level when live rays fit in width / SHRINK_DIV
PLAIN_RAYS = 32768   # rays per step of cull_plain ([M6, 32768])
PLAIN_BLOCKS = 256   # blocks per step of serve_blocks_plain
GATHER_LANES = 8192  # lanes per step of the gather serve ([8192, 10, K])

# ray state: float rows and int rows, permuted together by each sort
OX, OY, OZ, DX, DY, DZ, TB, U, V = range(9)
PRIM, LK, RID = range(3)

# Kernel launches of `cull` (K2) and `serve_blocks` (K3). Only the wrappers
# add to these, and only where they launch a CUDA kernel; callers reset
# them to 0.
LAUNCHES = {"cull": 0, "serve": 0}


@struct
class BVHServe:
    tris: torch.Tensor     # [M, 16, K] f32 (rows 0-8 p0/e1/e2, 9 prim id)
    bounds: torch.Tensor   # [8, M6] f32 rows lox loy loz hix hiy hiz (pad 2)
    sup: torch.Tensor      # [8, max(M6 // LC, 8)] chunk-union AABBs
    n_leaves: int = 0
    m_pad: int = 0
    topk: int = TOPK       # leaf visits per round


def build(p0, e1, e2, leaf_size=K, topk=TOPK, *, device) -> BVHServe:
    """SAH leaves via the bvh_tiled builder, repacked for the round
    traversal: transposed bounds rows + per-chunk union AABBs."""
    if topk not in range(1, MAX_TOPK + 1):
        raise ValueError(f"bvh_serve: topk {topk} is not supported; the "
                         f"kernels take 1 to {MAX_TOPK}")
    lb, comp, _, _, _ = bvh_tiled.build_arrays(p0, e1, e2, leaf_size)
    m = lb.shape[0]
    m6 = -(-m // LC) * LC
    bounds = np.zeros((8, m6), np.float32)
    bounds[:3, :] = BIG          # pad slots: inverted boxes, masked by id
    bounds[3:6, :] = -BIG
    bounds[:6, :m] = lb.T
    supw = max(m6 // LC, 8)
    sup = np.zeros((8, supw), np.float32)
    sup[:3, :] = BIG
    sup[3:6, :] = -BIG
    for c in range(m6 // LC):
        seg = lb[c * LC:min((c + 1) * LC, m)]
        if len(seg):
            sup[:3, c] = seg[:, :3].min(axis=0)
            sup[3:6, c] = seg[:, 3:].max(axis=0)
    return BVHServe(tris=torch.as_tensor(comp, device=device),
                    bounds=torch.as_tensor(bounds, device=device),
                    sup=torch.as_tensor(sup, device=device),
                    n_leaves=m, m_pad=m6, topk=topk)


# ---------------------------------------------------------------------------
# Cull: kernel K2 and its plain version
# ---------------------------------------------------------------------------

def _inv(c):
    return 1.0 / torch.where(c.abs() < 1e-9,
                             torch.where(c < 0, -1e-9, 1e-9), c)


def _slab(b, o, inv):
    """Slab test of boxes b (6 rows lo xyz, hi xyz) against rays o/inv
    (3-tuples), broadcasting -> (t_near, t_far)."""
    tn = tf = None
    for a in range(3):
        t0 = (b[a] - o[a]) * inv[a]
        t1 = (b[a + 3] - o[a]) * inv[a]
        lo, hi = torch.minimum(t0, t1), torch.maximum(t0, t1)
        tn = lo if tn is None else torch.maximum(tn, lo)
        tf = hi if tf is None else torch.minimum(tf, hi)
    return tn, tf


def _cull_work(acc: BVHServe, o, inv, tb, lk, stats: dict):
    """The box tests a cull of these rays needs, added to `stats`. A ray
    is inert when its cursor is NONE or its best t is not > 0: no key can
    pass, and it needs no test. Every other ray tests each chunk's union
    box ("sup_tests") and the real leaves of each chunk whose union box it
    enters ("box_tests"); "chunks_taken" and "warps_taken" count the
    (RCHUNK-ray block, chunk) and (32-ray warp, chunk) pairs in which some
    ray enters. A leaf box lies inside its chunk's box, so no other leaf
    can pass."""
    n_chunks = acc.m_pad // LC
    busy = (lk != NONE) & (tb > 0.0)                              # [1, R]
    tn, tf = _slab([acc.sup[r, :n_chunks, None] for r in range(6)], o, inv)
    enters = busy & (tn <= tf) & (torch.where(tn > 0.0, tn, 0.0) < tb)
    real = torch.clamp(acc.n_leaves - LC * torch.arange(
        n_chunks, device=tb.device), 0, LC)
    for key, n in (("sup_tests", n_chunks * int(busy.sum())),
                   ("box_tests", int((enters * real[:, None]).sum())),
                   ("chunks_taken", int(enters.reshape(
                       n_chunks, -1, RCHUNK).any(dim=2).sum())),
                   ("warps_taken", int(enters.reshape(
                       n_chunks, -1, 32).any(dim=2).sum()))):
        stats[key] = stats.get(key, 0) + n


def cull_plain(acc: BVHServe, geo, lk, stats: dict | None = None):
    """Plain PyTorch version of K2: geo [R >= 7, npad] f32 (rows ox oy oz
    dx dy dz tb), lk [npad] i32 -> [topk, npad] i32, each ray's topk
    smallest valid keys ascending, NONE-padded. The supernode pretest only
    skips chunks in which no key can pass, so it is left out here. Runs
    PLAIN_RAYS rays at a time. With `stats`, adds the box tests this data
    needs (`_cull_work`)."""
    npad = geo.shape[1]
    dev = geo.device
    out = torch.empty((acc.topk, npad), dtype=torch.int32, device=dev)
    ids = torch.arange(1, acc.m_pad + 1, dtype=torch.int32,
                       device=dev)[:, None]
    b = [acc.bounds[r, :, None] for r in range(6)]
    for r0 in range(0, npad, PLAIN_RAYS):
        g = geo[:7, r0:r0 + PLAIN_RAYS]
        o = (g[OX][None], g[OY][None], g[OZ][None])
        inv = (_inv(g[DX])[None], _inv(g[DY])[None], _inv(g[DZ])[None])
        if stats is not None:
            _cull_work(acc, o, inv, g[TB][None],
                       lk[None, r0:r0 + PLAIN_RAYS], stats)
        tn, tf = _slab(b, o, inv)                       # [M6, R]
        # where(> 0) rather than maximum(., 0): -0.0 becomes +0.0, as in JAX
        entry = torch.where(tn > 0.0, tn, 0.0)
        keys = (entry.view(torch.int32) & -65536) | ids
        ok = ((tn <= tf) & (entry < g[TB][None])
              & (keys > lk[None, r0:r0 + PLAIN_RAYS]) & (ids <= acc.n_leaves))
        keys = torch.where(ok, keys, NONE)
        out[:, r0:r0 + PLAIN_RAYS] = torch.topk(
            keys, acc.topk, dim=0, largest=False, sorted=True).values
    return out


def cull(acc: BVHServe, geo, lk):
    """K2: each ray's topk nearest unvisited leaf keys (arguments as
    cull_plain's). CPU tensors take the plain version; CUDA tensors launch
    the kernel of csrc/bvh_serve_cull.cu on the current stream."""
    if native.on_cpu(geo, lk, acc.bounds, acc.sup):
        return cull_plain(acc, geo, lk)
    dev = geo.device
    if dev.type != "cuda":
        raise ValueError(f"cull: rays on {dev}; the kernel needs every "
                         f"tensor on one CUDA device")
    npad = geo.shape[1]
    if npad % RCHUNK:
        raise ValueError(f"cull: width {npad} is not a multiple of {RCHUNK}")
    check = functools.partial(native.check, "cull")
    check("geo", geo, torch.float32, (geo.shape[0], npad), dev)
    if geo.shape[0] < 7:
        raise ValueError("cull: geo needs rows ox oy oz dx dy dz tb")
    check("lk", lk, torch.int32, (npad,), dev)
    check("bounds", acc.bounds, torch.float32, (8, acc.m_pad), dev)
    check("sup", acc.sup, torch.float32, tuple(acc.sup.shape), dev)
    best = torch.empty((acc.topk, npad), dtype=torch.int32, device=dev)
    if npad == 0:
        return best
    native.launch("bvh_serve_cull", "ppiiippipi", acc.bounds.data_ptr(),
                  acc.sup.data_ptr(), acc.m_pad, acc.sup.shape[1],
                  acc.n_leaves, geo.data_ptr(), lk.data_ptr(),
                  npad // RCHUNK, best.data_ptr(), acc.topk, dev=dev)
    LAUNCHES["cull"] += 1
    return best


# ---------------------------------------------------------------------------
# Serve: kernel K3 and its plain version
# ---------------------------------------------------------------------------

def _mt_best(slab, o, d, tb):
    """Best hit per ray of slabs [S, 16, K] against rays (o, d: 3-tuples
    and tb, each [S, 1, R]) -> (tmin, prim, u, v) [S, R]: hits need t in
    [0, tb] and id >= 0; the smallest t wins, ties to the largest id."""
    t, u, v, ok = bvh_tiled._mt_slabs(slab, o, d)
    ids = slab[:, 9, :, None].to(torch.int32)
    hit = ok & (t >= 0.0) & (t <= tb) & (ids >= 0)
    t_m = torch.where(hit, t, BIG)
    tmin = t_m.amin(dim=1)
    winner = hit & (t_m == tmin[:, None])
    prim = torch.where(winner, ids, -1).amax(dim=1)
    final = winner & (ids == prim[:, None])
    return (tmin, prim, torch.where(final, u, 0.0).sum(dim=1),
            torch.where(final, v, 0.0).sum(dim=1))


def serve_blocks_plain(acc: BVHServe, blk_ids, rays, leaf,
                       stats: dict | None = None):
    """Plain PyTorch version of K3: blk_ids [NB, 2 * topk] i32 (per
    128-ray block and rank, the first and last requested leaf), rays
    [R >= 7, npad] f32 (ox oy oz dx dy dz tb), leaf [topk, npad] i32 ->
    (t, prim, u, v, srv) [npad], srv the served-rank bitmask. A slab is
    skipped if its id repeats an earlier one of the block or no ray of the
    block wants it; a later slab replaces only with a strictly smaller t.
    Runs PLAIN_BLOCKS blocks at a time. With `stats`, adds to
    stats["tests"] the ray-triangle tests this data needs: per ray and
    slab it wants, the slab's real triangles."""
    npad = rays.shape[1]
    nb = npad // BLK
    nsl = 2 * acc.topk
    dev = rays.device
    t_o = torch.full((nb, BLK), BIG, dtype=torch.float32, device=dev)
    p_o = torch.full((nb, BLK), -1, dtype=torch.int32, device=dev)
    u_o = torch.zeros((nb, BLK), dtype=torch.float32, device=dev)
    v_o = torch.zeros((nb, BLK), dtype=torch.float32, device=dev)
    srv = torch.zeros((nb, BLK), dtype=torch.int32, device=dev)
    rs = rays[:7].reshape(7, nb, BLK)
    lf = leaf.reshape(acc.topk, nb, BLK)
    for c0 in range(0, nb, PLAIN_BLOCKS):
        c1 = min(c0 + PLAIN_BLOCKS, nb)
        blk = blk_ids[c0:c1]
        for j in range(nsl):
            lid = blk[:, j]
            dup = torch.zeros_like(lid, dtype=torch.bool)
            for j2 in range(j):
                dup = dup | (lid == blk[:, j2])
            bits = torch.zeros((c1 - c0, BLK), dtype=torch.int32, device=dev)
            for t in range(acc.topk):
                bits = bits | ((lf[t, c0:c1] == lid[:, None]).to(torch.int32)
                               << t)
            want = bits != 0
            sel = torch.nonzero(want.any(dim=1) & ~dup).squeeze(1)
            if sel.numel() == 0:
                continue
            rows = c0 + sel
            r = [rs[i, rows][:, None, :] for i in range(7)]
            slab = acc.tris[lid[sel].long()]
            tmin, prim, uu, vv = _mt_best(slab, tuple(r[:3]), tuple(r[3:6]),
                                          r[6])
            w = want[sel]
            if stats is not None:
                stats["tests"] = stats.get("tests", 0) + int(
                    (w.sum(dim=1) * bvh_tiled.real_tris(slab)).sum())
            better = w & (tmin < t_o[rows])
            t_o[rows] = torch.where(better, tmin, t_o[rows])
            p_o[rows] = torch.where(better, prim, p_o[rows])
            u_o[rows] = torch.where(better, uu, u_o[rows])
            v_o[rows] = torch.where(better, vv, v_o[rows])
            srv[rows] = srv[rows] | bits[sel]
    return tuple(x.reshape(-1) for x in (t_o, p_o, u_o, v_o, srv))


def serve_blocks(acc: BVHServe, blk_ids, rays, leaf):
    """K3: serve every 128-ray block its first and last requested leaf
    per rank (arguments as serve_blocks_plain's). CPU tensors take the
    plain version; CUDA tensors launch the kernel of
    csrc/bvh_serve_serve.cu on the current stream."""
    if native.on_cpu(blk_ids, rays, leaf, acc.tris):
        return serve_blocks_plain(acc, blk_ids, rays, leaf)
    dev = rays.device
    if dev.type != "cuda":
        raise ValueError(f"serve_blocks: rays on {dev}; the kernel needs "
                         f"every tensor on one CUDA device")
    npad = rays.shape[1]
    nb = npad // BLK
    if npad % BLK:
        raise ValueError(f"serve_blocks: width {npad} is not a multiple "
                         f"of {BLK}")
    check = functools.partial(native.check, "serve_blocks")
    check("blk_ids", blk_ids, torch.int32, (nb, 2 * acc.topk), dev)
    check("rays", rays, torch.float32, (rays.shape[0], npad), dev)
    if rays.shape[0] < 7:
        raise ValueError("serve_blocks: rays needs rows ox oy oz dx dy dz "
                         "tb")
    check("leaf", leaf, torch.int32, (acc.topk, npad), dev)
    check("tris", acc.tris, torch.float32, (acc.tris.shape[0], 16, K), dev)
    t = torch.empty(npad, dtype=torch.float32, device=dev)
    p = torch.empty(npad, dtype=torch.int32, device=dev)
    u = torch.empty_like(t)
    v = torch.empty_like(t)
    srv = torch.empty_like(p)
    if nb == 0:
        return t, p, u, v, srv
    native.launch("bvh_serve_serve", "ppppiippppp", acc.tris.data_ptr(),
                  blk_ids.data_ptr(), rays.data_ptr(), leaf.data_ptr(), nb,
                  acc.topk, t.data_ptr(), p.data_ptr(), u.data_ptr(),
                  v.data_ptr(), srv.data_ptr(), dev=dev)
    LAUNCHES["serve"] += 1
    return t, p, u, v, srv


# ---------------------------------------------------------------------------
# Gather serve (tail): per-lane leaf fetch, plain torch as in JAX
# ---------------------------------------------------------------------------

def _serve_gather(acc: BVHServe, leaf_all, f, ns: int):
    """Serve the first `ns` (sorted, hence live-first) lanes exactly: per
    lane and candidate rank, a leaf-row gather and Möller-Trumbore over
    its K triangles. Returns full-width (t, prim, u, v, srv)."""
    npad = leaf_all.shape[1]
    dev = f.device
    t_o = torch.full((npad,), BIG, dtype=torch.float32, device=dev)
    p_o = torch.full((npad,), -1, dtype=torch.int32, device=dev)
    u_o = torch.zeros(npad, dtype=torch.float32, device=dev)
    v_o = torch.zeros(npad, dtype=torch.float32, device=dev)
    srv = torch.zeros(npad, dtype=torch.int32, device=dev)
    for c0 in range(0, ns, GATHER_LANES):
        c1 = min(c0 + GATHER_LANES, ns)
        r = [f[i, c0:c1][:, None, None] for i in range(7)]
        tmin, prim, uu, vv, bits = (t_o[c0:c1], p_o[c0:c1], u_o[c0:c1],
                                    v_o[c0:c1], srv[c0:c1])
        for t in range(acc.topk):
            lf = leaf_all[t, c0:c1]
            act = lf < acc.m_pad
            rows = acc.tris[torch.clamp(lf, 0, acc.n_leaves - 1).long(), :10]
            tt, pp, ut, vt = (x[:, 0] for x in _mt_best(
                rows, tuple(r[:3]), tuple(r[3:6]), r[6]))
            better = act & (tt < tmin)
            tmin.copy_(torch.where(better, tt, tmin))
            prim.copy_(torch.where(better, pp, prim))
            uu.copy_(torch.where(better, ut, uu))
            vv.copy_(torch.where(better, vt, vv))
            bits.copy_(bits | (act.to(torch.int32) << t))
    return t_o, p_o, u_o, v_o, srv


# ---------------------------------------------------------------------------
# Round loop
# ---------------------------------------------------------------------------

def _cull_state(acc: BVHServe, f, i):
    best = cull(acc, f, i[LK])                       # [topk, npad]
    return best, (best[0] != NONE) & (i[RID] >= 0)


def _leaf_of(key, m6: int, live):
    """0-based leaf of a packed key; m6 (sorts last) where not live."""
    return torch.where(live, (key & 0xFFFF) - 1, m6)


def sort_requests(acc: BVHServe, f, i, best, live):
    """Sort the ray state by requested leaf (stable). best [topk, npad]
    ascending keys. Returns the sorted (f, i) with the rank-0 key in
    i[LK], the candidate leaf table leaf_all [topk, npad] i32 (m6 where a
    rank has none), the keys of ranks 1.. and the sorted live mask."""
    m6, topk = acc.m_pad, acc.topk
    leaf = _leaf_of(best[0], m6, live)
    # a ray that is not live never changes again (the serve is masked by
    # live_s), so every later cull returns NONE for it whatever its cursor
    # is: NONE tells K2 so, and it skips the ray
    lk_in = torch.where(live, best[0], NONE)
    leaf_s, perm = torch.sort(leaf, stable=True)
    f = f[:, perm]
    i = i[:, perm]
    i[LK] = lk_in[perm]
    best_s = [torch.where(live, best[t], NONE)[perm] for t in range(1, topk)]
    live_s = (leaf_s < m6) & (i[RID] >= 0)
    leaf_all = torch.stack(
        [leaf_s] + [_leaf_of(bt, m6, live_s & (bt != NONE))
                    for bt in best_s], dim=0)
    return f, i, leaf_all, best_s, live_s


def block_ids(acc: BVHServe, leaf_all):
    """[nb, 2 * topk] i32: per 128-ray block, rank-major, the first and
    last requested leaf, clipped to real leaves."""
    topk, npad = leaf_all.shape
    nb = npad // BLK
    blk = leaf_all.reshape(topk, nb, BLK)[:, :, [0, BLK - 1]]
    return torch.clamp(blk.permute(1, 0, 2).reshape(nb, 2 * topk), 0,
                       acc.n_leaves - 1).contiguous()


def _round_once(acc: BVHServe, f, i, best, live, n_live: int,
                closest: bool):
    """Sort by requested leaf, serve all topk candidate ranks, fold the
    results into the state. Returns the new (f, i), in leaf order."""
    npad = f.shape[1]
    f, i, leaf_all, best_s, live_s = sort_requests(acc, f, i, best, live)
    key_rows = [i[LK]] + best_s
    if npad > 2 * MIN_W and n_live > max(npad // TAIL_DIV, RCHUNK):
        ct, cp, cu, cv, srv = serve_blocks(acc, block_ids(acc, leaf_all), f,
                                           leaf_all)
    else:
        # narrow widths and the tail: the exact gather serve of every live
        # lane (the live lanes are the sorted prefix)
        ct, cp, cu, cv, srv = _serve_gather(acc, leaf_all, f, n_live)

    srv = torch.where(live_s, srv, 0)
    served0 = (srv & 1) != 0
    hit = (srv > 0) & (cp >= 0) & (ct < f[TB])
    f[TB] = torch.where(hit, ct, f[TB])
    i[PRIM] = torch.where(hit, cp, i[PRIM])
    f[U] = torch.where(hit, cu, f[U])
    f[V] = torch.where(hit, cv, f[V])
    # the cursor advances to the longest served prefix of the candidate
    # ranks; an unserved lane steps back to best - 1 so the next cull
    # re-selects the same leaf. A NONE rank after a fully served prefix
    # proves the lane is done.
    lk_new = torch.where(live_s & ~served0, i[LK] - 1, i[LK])
    prefix = served0
    done = torch.zeros_like(served0)
    for t in range(1, acc.topk):
        kt = key_rows[t]
        has_t = kt != NONE
        done = done | (prefix & ~has_t)
        prefix = prefix & has_t & ((srv & (1 << t)) != 0)
        lk_new = torch.where(prefix, kt, lk_new)
    lk_new = torch.where(done & live_s, NONE, lk_new)
    if not closest:
        lk_new = torch.where((i[PRIM] >= 0) | (i[RID] < 0), NONE, lk_new)
    i[LK] = lk_new
    return f, i


def _run_level(acc: BVHServe, f, i, closest: bool, max_rounds: int):
    """Round loop at this width; once the live rays fit in
    width / SHRINK_DIV, compact them into a prefix and recurse one level
    narrower."""
    npad = f.shape[1]
    thresh = -(-(npad // SHRINK_DIV) // RCHUNK) * RCHUNK
    shrink = MIN_W <= thresh < npad
    loop_thresh = thresh if shrink else 0

    best, live = _cull_state(acc, f, i)
    n_live = int(live.sum())
    r = 0
    while n_live > loop_thresh and r < max_rounds:
        f, i = _round_once(acc, f, i, best, live, n_live, closest)
        best, live = _cull_state(acc, f, i)
        n_live = int(live.sum())
        r += 1
    if not shrink:
        return f, i
    # compact the live rays into a prefix, recurse narrower
    _, perm = torch.sort(_leaf_of(best[0], acc.m_pad, live), stable=True)
    f = f[:, perm]
    i = i[:, perm]
    f_sub, i_sub = _run_level(acc, f[:, :thresh].contiguous(),
                              i[:, :thresh].contiguous(), closest,
                              max_rounds)
    return (torch.cat([f[:, thresh:], f_sub], dim=1),
            torch.cat([i[:, thresh:], i_sub], dim=1))


def initial_state(o: Vec3, d: Vec3, maxt):
    """The ray state of a query, padded to whole cull blocks: f [9, npad]
    f32 (rows OX..V), i [3, npad] i32 (rows PRIM, LK, RID); padding lanes
    have rid -1 and tb -1."""
    n = o.x.shape[0]
    dev = o.x.device
    npad = -(-n // RCHUNK) * RCHUNK
    f = torch.zeros((9, npad), dtype=torch.float32, device=dev)
    for row, x in zip((OX, OY, OZ, DX, DY, DZ),
                      (o.x, o.y, o.z, d.x, d.y, d.z)):
        f[row, :n] = x
    f[DZ, n:] = 1.0
    f[TB, :n] = torch.clamp(maxt, max=3e38)
    f[TB, n:] = -1.0
    i = torch.zeros((3, npad), dtype=torch.int32, device=dev)
    i[PRIM] = -1
    i[RID] = -1
    i[RID, :n] = torch.arange(n, dtype=torch.int32, device=dev)
    return f, i


def _trace(acc: BVHServe, o: Vec3, d: Vec3, maxt, closest: bool):
    """-> (t, prim, u, v) [N] in the caller's order; t is the final best
    distance bound (maxt where nothing was hit)."""
    n = o.x.shape[0]
    dev = o.x.device
    f, i = initial_state(o, d, maxt)
    f, i = _run_level(acc, f, i, closest, 4 * acc.n_leaves + 8)
    # back to the caller's lane order
    real = i[RID] >= 0
    rid = i[RID][real].long()
    outs = []
    for x in (f[TB], i[PRIM], f[U], f[V]):
        y = torch.empty(n, dtype=x.dtype, device=dev)
        y[rid] = x[real]
        outs.append(y)
    return tuple(outs)


def _lanes(o: Vec3, maxt, active):
    maxt = torch.as_tensor(maxt, dtype=torch.float32,
                           device=o.x.device).expand(o.x.shape[0])
    mt = maxt if active is None else torch.where(active, maxt, -1.0)
    return maxt, mt


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
