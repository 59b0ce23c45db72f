"""Grouped-supernode traversal — counterpart of
``mitsuba3_tpu/ops/attic/bvh2.py``.

  1. SUPERNODES: SAH leaves of at most 32 triangles, packed [M, 10, 32]
     (rows p0/e1/e2 xyz and the prim id, -1 for an empty slot).
  2. CULL + TOP-K (plain torch, as JAX's is XLA): each ray's K_SLOTS nearest
     supernodes by slab entry, packed (entry bits >> 16 << 16 | id) in
     uint32 order, and the entry of the next one (`rest_min`).
  3. One stable sort of the rays by (first supernode, entry); the state
     then lives chunk-major, [n_chunks, 128].
  4. ROUNDS: the C_SUB chunks with the most pending lanes each get their
     N_SERVE smallest wanted ids served (kernel K8, ``csrc/bvh2_serve.cu``)
     and the served lanes' cursors advance. A lane stops pending when its
     best hit is nearer than its next entry, its queue is exhausted, or
     (any-hit) it hit.
  5. REFILL: rays whose queue overflowed and may still hit nearer are
     tested against every supernode, REFILL_B rays at a time.
  6. Back to the caller's lane order.

JAX's uint32 keys are carried in int64 lanes holding values below 2^32.
The cull pads the supernodes to a multiple of NODE_CHUNK with inverted
boxes; as in JAX, those boxes pass the slab test of every ray (their
per-axis intervals span everything) with entry 0, so their ids can fill a
queue, and serving one hits nothing (JAX's out-of-range gather gives rows
of NaN). The round loop is a host loop; the refill's scan over supernodes
runs REFILL_NODES supernodes at a time with the scan's tie rule.
"""
from __future__ import annotations

import functools

import numpy as np
import torch

from ... import native as native_bvh
from ...core.struct import struct
from ...core.vec import Vec2, Vec3
from .. import native
from ..bvh_serve import _mt_best
from ..bvh_tiled import _lanes, real_tris

LEAF = 32          # triangles per supernode
CHUNK = 128        # rays per serving chunk (one CTA of K8)
K_SLOTS = 8        # per-ray supernode queue depth
N_SERVE = 4        # distinct supernode ids served per chunk per round
C_SUB = 1024       # chunks served per round
NODE_CHUNK = 32    # the cull pads the supernodes to a multiple of this
REFILL_B = 4096    # overflow rays refilled per batch
MAX_ROUNDS = 4096  # safety bound; the pending check exits far earlier
BIG = 3.4e38
EPS = 1e-20        # |d| below this counts as +-EPS in 1 / d
INVALID = 0xFFFFFFFF   # no key (uint32)
NONE_ID = 0x7FFFFFFF   # no wanted supernode
CULL_RAYS = 8192       # rays per step of cull_topk ([8192, M] keys)
REFILL_NODES = 64      # supernodes per step of the refill scan

# Kernel launches of `serve` (K8). Only the wrapper adds to it, and only
# where it launches the CUDA kernel; callers reset it to 0.
LAUNCHES = {"serve": 0}


@struct
class BVH2:
    bounds: torch.Tensor   # [M, 6] f32 supernode boxes (lo xyz, hi xyz)
    tris: torch.Tensor     # [M, 10, LEAF] f32 (row 9 = prim id, -1 pad)
    n_nodes: int = 0


def build(p0, e1, e2, leaf_size=LEAF, *, device) -> BVH2:
    p0 = np.asarray(p0, np.float32)
    e1 = np.asarray(e1, np.float32)
    e2 = np.asarray(e2, np.float32)
    v1, v2 = p0 + e1, p0 + e2
    bbmin = np.minimum(np.minimum(p0, v1), v2)
    bbmax = np.maximum(np.maximum(p0, v1), v2)
    order, _, _, lf, lc = native_bvh.build_bvh(bbmin, bbmax, leaf_size)
    m = len(lf)
    slots = np.full((m, leaf_size), -1, np.int64)
    for L in range(m):
        ids = order[lf[L]:lf[L] + lc[L]]
        slots[L, :len(ids)] = ids
    flat = slots.reshape(-1)
    valid = flat >= 0
    src = np.where(valid, flat, 0)
    comp = np.zeros((m, 10, leaf_size), np.float32)
    for r, arr in enumerate([p0[:, 0], p0[:, 1], p0[:, 2],
                             e1[:, 0], e1[:, 1], e1[:, 2],
                             e2[:, 0], e2[:, 1], e2[:, 2]]):
        comp[:, r, :] = np.where(valid, arr[src], 0.0).reshape(m, leaf_size)
    comp[:, 9, :] = np.where(valid, flat, -1).reshape(m, leaf_size)
    lb = np.zeros((m, 6), np.float32)
    for L in range(m):
        ids = slots[L][slots[L] >= 0]
        lb[L, :3] = bbmin[ids].min(axis=0)
        lb[L, 3:] = bbmax[ids].max(axis=0)
    return BVH2(bounds=torch.as_tensor(lb, device=device),
                tris=torch.as_tensor(comp, device=device), n_nodes=m)


# ---------------------------------------------------------------------------
# Packed keys (uint32 values in int64 lanes)
# ---------------------------------------------------------------------------

def _bits(x):
    """f32 -> its bits as an int64 in [0, 2^32)."""
    return x.view(torch.int32).to(torch.int64) & 0xFFFFFFFF


def _f32(bits):
    """int64 in [0, 2^32) -> the f32 with those bits."""
    return torch.where(bits >= 2 ** 31, bits - 2 ** 32, bits).to(
        torch.int32).view(torch.float32)


def _pack(ents, ids):
    """(entry f32, id) -> key: the entry, clamped at 0 and rounded down to
    its top 16 bits, in the high half, the id in the low half; INVALID
    where id < 0. where(> 0) rather than maximum(., 0): -0.0 becomes +0.0,
    as in JAX."""
    b = _bits(torch.where(ents > 0.0, ents, 0.0)) >> 16
    return torch.where(ids >= 0, (b << 16) | ids.to(torch.int64), INVALID)


def _unpack(p):
    """key -> (entry lower bound, BIG where none; id i32, -1 where none)."""
    idx = torch.where(p == INVALID, -1, p & 0xFFFF).to(torch.int32)
    return torch.where(idx >= 0, _f32((p >> 16) << 16), BIG), idx


# ---------------------------------------------------------------------------
# Cull + top-K (plain torch)
# ---------------------------------------------------------------------------

def _inv(c):
    return 1.0 / torch.where(c.abs() < EPS, torch.where(c >= 0, EPS, -EPS), c)


def cull_topk(acc: BVH2, ox, oy, oz, dx, dy, dz, mt):
    """Rays [N] each -> (packed [N, K_SLOTS] int64 keys ascending, INVALID
    padded; rest_min [N] f32, the entry of the (K_SLOTS + 1)-th key, BIG
    when none). A supernode counts when t_near <= t_far * 1.0001,
    t_far >= 0 and t_near <= mt."""
    n = ox.shape[0]
    m = acc.n_nodes
    mpad = -(-m // NODE_CHUNK) * NODE_CHUNK
    pad = torch.tensor([[1e30, 1e30, 1e30, -1e30, -1e30, -1e30]],
                       dtype=torch.float32,
                       device=ox.device).expand(mpad - m, 6)
    b = torch.cat([acc.bounds, pad]).T[:, None, :]        # [6, 1, mpad]
    ids = torch.arange(mpad, dtype=torch.int64, device=ox.device)
    packed = torch.empty((n, K_SLOTS), dtype=torch.int64, device=ox.device)
    rest_min = torch.empty(n, dtype=torch.float32, device=ox.device)
    for r0 in range(0, n, CULL_RAYS):
        rs = slice(r0, r0 + CULL_RAYS)
        t_near = t_far = None
        for a, (o, d) in enumerate(((ox, dx), (oy, dy), (oz, dz))):
            inv = _inv(d[rs])[:, None]
            t1 = (b[a] - o[rs, None]) * inv
            t2 = (b[a + 3] - o[rs, None]) * inv
            lo, hi = torch.minimum(t1, t2), torch.maximum(t1, t2)
            t_near = lo if t_near is None else torch.maximum(t_near, lo)
            t_far = hi if t_far is None else torch.minimum(t_far, hi)
        hit = ((t_near <= t_far * 1.0001) & (t_far >= 0.0)
               & (t_near <= mt[rs, None]))
        keys = _pack(t_near, torch.where(hit, ids, -1))
        best = torch.topk(keys, K_SLOTS + 1, dim=1, largest=False,
                          sorted=True).values
        packed[rs] = best[:, :K_SLOTS]
        rest_min[rs] = _unpack(best[:, K_SLOTS])[0]
    return packed, rest_min


# ---------------------------------------------------------------------------
# Serve: kernel K8 and its plain version
# ---------------------------------------------------------------------------

def _mt_block(tri, ox, oy, oz, dx, dy, dz, maxt):
    """tri [C, 10, LEAF] vs rays [C, R] -> best (t, prim, u, v) [C, R]:
    hits need t in [0, maxt] and id >= 0; the smallest t wins, ties to the
    largest id."""
    def r(a):
        return a[:, None, :]

    return _mt_best(tri, (r(ox), r(oy), r(oz)), (r(dx), r(dy), r(dz)),
                    r(maxt))


def serve_plain(acc: BVH2, ids, rays, want, stats: dict | None = None):
    """Plain PyTorch version of K8: ids [C, N_SERVE] i32 served ids
    (NONE_ID = none), rays [C, 8, CHUNK] f32 (rows ox oy oz dx dy dz, 6
    unused, 7 tbest), want [C, CHUNK] i32 -> (t, prim, u, v) [C, CHUNK]:
    the lanes that want a served id take that supernode's best hit, a miss
    (BIG, -1, 0, 0) included; an id past the table hits nothing. With
    `stats`, adds to stats["lanes"] the (lane, id) pairs served from the
    table and to stats["tests"] the ray-triangle tests this data needs: for
    each pair, the supernode's real triangles."""
    c = ids.shape[0]
    dev = rays.device
    t = torch.full((c, CHUNK), BIG, dtype=torch.float32, device=dev)
    p = torch.full((c, CHUNK), -1, dtype=torch.int32, device=dev)
    u = torch.zeros((c, CHUNK), dtype=torch.float32, device=dev)
    v = torch.zeros_like(u)
    ray = [rays[:, a] for a in range(8)]
    for k in range(N_SERVE):
        sid = ids[:, k]
        ok = sid != NONE_ID
        inb = ok & (sid < acc.n_nodes)
        blk = acc.tris[torch.where(inb, sid, 0).long()]
        tk, pk, uk, vk = _mt_block(blk, *ray[:6], ray[7])
        miss = ~inb[:, None]
        lane = (want == sid[:, None]) & ok[:, None]
        if stats is not None:
            n = (lane & ~miss).sum(dim=1)
            stats["lanes"] = stats.get("lanes", 0) + int(n.sum())
            stats["tests"] = stats.get("tests", 0) + int(
                (n * real_tris(blk)).sum())
        t = torch.where(lane, torch.where(miss, BIG, tk), t)
        p = torch.where(lane, torch.where(miss, -1, pk), p)
        u = torch.where(lane, torch.where(miss, 0.0, uk), u)
        v = torch.where(lane, torch.where(miss, 0.0, vk), v)
    return t, p, u, v


def serve(acc: BVH2, ids, rays, want):
    """K8 (arguments as serve_plain's). CPU tensors take the plain version;
    CUDA tensors launch the kernel of csrc/bvh2_serve.cu on the current
    stream."""
    if native.on_cpu(ids, rays, want, acc.tris):
        return serve_plain(acc, ids, rays, want)
    dev = rays.device
    if dev.type != "cuda":
        raise ValueError(f"serve: rays on {dev}; the kernel needs every "
                         f"tensor on one CUDA device")
    c = ids.shape[0]
    check = functools.partial(native.check, "serve")
    check("ids", ids, torch.int32, (c, N_SERVE), dev)
    check("rays", rays, torch.float32, (c, 8, CHUNK), dev)
    check("want", want, torch.int32, (c, CHUNK), dev)
    check("tris", acc.tris, torch.float32, (acc.n_nodes, 10, LEAF), dev)
    t = torch.empty((c, CHUNK), dtype=torch.float32, device=dev)
    p = torch.empty((c, CHUNK), dtype=torch.int32, device=dev)
    u = torch.empty_like(t)
    v = torch.empty_like(t)
    if c == 0:
        return t, p, u, v
    native.launch("bvh2_serve", "pipppipppp", acc.tris.data_ptr(),
                  acc.n_nodes, ids.data_ptr(), rays.data_ptr(),
                  want.data_ptr(), c, t.data_ptr(), p.data_ptr(),
                  u.data_ptr(), v.data_ptr(), dev=dev)
    LAUNCHES["serve"] += 1
    return t, p, u, v


# ---------------------------------------------------------------------------
# The trace
# ---------------------------------------------------------------------------

def _serve_ids(want_s):
    """[c, CHUNK] wanted ids -> [c, N_SERVE] the N_SERVE smallest distinct
    ones, ascending, NONE_ID padded."""
    out = []
    prev = None
    for s in range(N_SERVE):
        cand = want_s if s == 0 else torch.where(
            want_s > prev[:, None], want_s, NONE_ID)
        prev = cand.amin(dim=1)
        out.append(prev)
    return torch.stack(out, dim=1)


def first_round(acc: BVH2, o: Vec3, d: Vec3, maxt):
    """K8's arguments (ids, rays, want) in the first round of a closest-hit
    query: the cull, the sort and the chunk selection."""
    st = _setup(acc, o, d, maxt)
    return _round_args(st, _pending(st, True))[1:]


def _setup(acc: BVH2, o: Vec3, d: Vec3, maxt):
    """Cull, sort by first supernode, chunk-major state (a dict)."""
    maxt = torch.clamp(maxt, max=BIG)
    n = o.x.shape[0]
    npad = -(-n // CHUNK) * CHUNK
    n_chunks = npad // CHUNK
    dev = o.x.device

    def pad(x, fill):
        y = torch.full((npad,), fill, dtype=torch.float32, device=dev)
        y[:n] = x
        return y

    rows = [pad(o.x, 0.0), pad(o.y, 0.0), pad(o.z, 0.0), pad(d.x, 0.0),
            pad(d.y, 0.0), pad(d.z, 1.0), pad(maxt, -1.0)]
    packed, rest_min = cull_topk(acc, *rows)
    # id-major key: group a chunk's rays by supernode, then by entry
    head = packed[:, 0]
    key = ((head << 16) & 0xFFFFFFFF) | (head >> 16)
    _, lane = torch.sort(key, stable=True)
    ray = torch.stack(rows)[:, lane].reshape(7, n_chunks, CHUNK)
    mt_c = ray[6]
    return {"acc": acc, "n": n, "lane": lane, "ray": ray,
            "rest": rest_min[lane],
            "packed": packed[lane].reshape(n_chunks, CHUNK, K_SLOTS),
            "t": torch.where(mt_c < 0, -1.0, mt_c),
            "prim": torch.full((n_chunks, CHUNK), -1, dtype=torch.int32,
                               device=dev),
            "u": torch.zeros((n_chunks, CHUNK), dtype=torch.float32,
                             device=dev),
            "v": torch.zeros((n_chunks, CHUNK), dtype=torch.float32,
                             device=dev),
            "cursor": torch.zeros((n_chunks, CHUNK), dtype=torch.int64,
                                  device=dev)}


def _current(st):
    """(entry, id) of each lane's next queued supernode."""
    cur = st["packed"].gather(
        2, torch.clamp(st["cursor"], max=K_SLOTS - 1)[..., None])[..., 0]
    return _unpack(torch.where(st["cursor"] >= K_SLOTS, INVALID, cur))


def _pending(st, closest: bool):
    cur_ent, cur_id = _current(st)
    pend = (st["ray"][6] >= 0) & (cur_id >= 0)
    pend &= (st["t"] > cur_ent) if closest else (st["prim"] < 0)
    return pend, cur_id


def _round_args(st, pending_id):
    """This round's chunk selection and K8's arguments: (csel, ids [c,
    N_SERVE], rays [c, 8, CHUNK], want [c, CHUNK])."""
    pending, cur_id = pending_id
    want = torch.where(pending, cur_id, NONE_ID)
    # the chunks with the most pending lanes (stable: ties by chunk index)
    _, csel = torch.sort(-pending.sum(dim=1), stable=True)
    csel = csel[:C_SUB]
    want_s = want[csel]
    ray = st["ray"][:, csel]
    rays = torch.stack([*ray[:6], torch.zeros_like(ray[0]), st["t"][csel]],
                       dim=1)
    return csel, _serve_ids(want_s).contiguous(), rays, want_s.contiguous()


def _refill(acc: BVH2, ray, t, prim, u, v, act):
    """One batch of rays (ray [6, B], best t/prim/u/v [B], act [B]) against
    every supernode in order, REFILL_NODES at a time: a supernode replaces
    the best only with a strictly smaller t, so among equal ts the lowest
    supernode wins (JAX's scan)."""
    r = tuple(x[None, None, :] for x in ray)
    for g0 in range(0, acc.n_nodes, REFILL_NODES):
        tk, pk, uk, vk = _mt_best(acc.tris[g0:g0 + REFILL_NODES], r[:3],
                                  r[3:], t[None, None, :])      # [G, B]
        tg = torch.where(pk >= 0, tk, float("inf"))
        j = tg.argmin(dim=0, keepdim=True)          # the first of equal ts
        tj = tk.gather(0, j)[0]
        pj = pk.gather(0, j)[0]
        better = act & (pj >= 0) & (tj < t)
        t = torch.where(better, tj, t)
        prim = torch.where(better, pj, prim)
        u = torch.where(better, uk.gather(0, j)[0], u)
        v = torch.where(better, vk.gather(0, j)[0], v)
    return t, prim, u, v


def _trace(acc: BVH2, o: Vec3, d: Vec3, maxt, closest: bool):
    st = _setup(acc, o, d, maxt)
    r = 0
    while r < MAX_ROUNDS:
        pending = _pending(st, closest)
        if not bool(pending[0].any()):
            break
        csel, ids, rays, want = _round_args(st, pending)
        tn, pn, un, vn = serve(acc, ids, rays, want)
        tcs = rays[:, 7]
        better = (pn >= 0) & (tn < tcs)
        st["t"][csel] = torch.where(better, tn, tcs)
        for name, new in (("prim", pn), ("u", un), ("v", vn)):
            st[name][csel] = torch.where(better, new, st[name][csel])
        served = (want[:, :, None] == ids[:, None, :]).any(dim=2) \
            & (want != NONE_ID)
        st["cursor"][csel] += served.to(torch.int64)
        r += 1

    # refill for queue overflow: rays with candidates left past their queue
    # that may still hit nearer, densely against every supernode
    ray = st["ray"].reshape(7, -1)
    t, prim, u, v = (st[name].reshape(-1) for name in ("t", "prim", "u",
                                                       "v"))
    rest = st["rest"]
    need = (ray[6] >= 0) & (rest < BIG)
    need &= (rest < t) if closest else (prim < 0)
    nb = min(REFILL_B, need.shape[0])
    while bool(need.any()):
        _, perm = torch.sort(torch.where(need, 0, 1), stable=True)
        sel = perm[:nb]
        out = _refill(acc, ray[:6, sel], t[sel], prim[sel], u[sel], v[sel],
                      need[sel])
        for x, y in zip((t, prim, u, v), out):
            x[sel] = y
        need[sel] = False

    # back to the caller's lane order
    outs = []
    for x in (t, prim, u, v):
        y = torch.empty_like(x)
        y[st["lane"]] = x
        outs.append(y[:st["n"]])
    return tuple(outs)


def intersect_bvh(acc: BVH2, o: Vec3, d: Vec3, maxt, active=None):
    """Closest hit -> (t [N] (the best bound where none), prim [N], uv
    Vec2, valid [N])."""
    t, prim, u, v = _trace(acc, o, d, _lanes(o, maxt, active), closest=True)
    return t, prim, Vec2(u, v), prim >= 0


def occluded_bvh(acc: BVH2, o: Vec3, d: Vec3, maxt, active=None):
    """Any hit with t in [0, maxt] -> bool [N]."""
    return _trace(acc, o, d, _lanes(o, maxt, active), closest=False)[1] >= 0
