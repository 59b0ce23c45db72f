"""Two-phase tiled intersector (``MI3T_ACCEL=tiled``) — counterpart of
``mitsuba3_tpu/ops/bvh_tiled.py``.

  Phase 0  rays are co-sorted by direction octant + origin Morton cell
           + direction Morton cell (one stable sort, then gathers);
  Phase 1  per 1024-ray TILE, a conservative interval-arithmetic frustum
           is tested against all M leaf AABBs at once ([T, M] dense), and
           each tile's leaves are sorted by entry distance;
  Phase 2  rounds of kernel K4 (``csrc/bvh_tiled_mt.cu``): per tile, 16
           entry-sorted leaf slots, each skipped once its entry is beyond
           the tile's worst running t, else Möller-Trumbore against the
           leaf's 128 triangles. The host loop stops when no tile's next
           entry is within its worst t.

The leaves come from the SAH builder (``native.build_bvh``), the same C++
as the JAX package's, so ``build`` is bit-equal to its build. Unlike JAX
it never falls back to the median split: a failed build raises.

Eager-PyTorch differences from the JAX package, none of which changes a
hit: rays are padded to a multiple of one tile (not eight), leaf lists to a
multiple of 16 slots (not 128), and sorts are stable. Ties between equal-t
hits in different leaves may resolve differently when lane order differs.
"""
from __future__ import annotations

import functools

import numpy as np
import torch

from .. import native as native_bvh
from ..core.struct import struct
from ..core.vec import Vec2, Vec3
from . import native

TILE = 1024   # rays per tile (one CTA of K4)
KT = 128      # triangles per leaf
LB_USE = 16   # leaf slots per tile per round (K4's loop trip count)
BIG = 3.4e38
PLAIN_TILES = 16  # tiles per step of run_round_plain ([16, 128, 1024])

# Kernel launches of `run_round` by mode. Only the wrapper adds to these,
# and only where it launches the CUDA kernel; callers reset them to 0.
LAUNCHES = {"closest": 0, "anyhit": 0}


@struct
class BVHTiled:
    leaf_bounds: torch.Tensor  # [M, 6] f32
    tris: torch.Tensor         # [M, 16, KT] f32 component rows (9 = prim id)
    prim: torch.Tensor         # [M * KT] i32 original ids (-1 pad)
    scene_lo: torch.Tensor     # [3]
    scene_span: torch.Tensor   # [3]
    n_leaves: int = 0


def build_arrays(p0, e1, e2, leaf_size=KT):
    """SAH leaves as numpy arrays (leaf_bounds [M, 6], tris [M, 16, K],
    prim [M * K], scene_lo [3], scene_span [3]), as the JAX build makes
    them."""
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
    comp = np.zeros((m, 16, leaf_size), np.float32)
    for r, arr in enumerate([p0[:, 0], p0[:, 1], p0[:, 2],
                             e1[:, 0], e1[:, 1], e1[:, 2],
                             e2[:, 0], e2[:, 1], e2[:, 2]]):
        comp[:, r, :] = np.where(valid, arr[src], 0.0).reshape(m, leaf_size)
    # row 9: original triangle ids as exact f32 (< 2^24)
    comp[:, 9, :] = np.where(valid, flat, -1).reshape(m, leaf_size)
    lb = np.zeros((m, 6), np.float32)
    for L in range(m):
        ids = slots[L][slots[L] >= 0]
        lb[L, :3] = bbmin[ids].min(axis=0)
        lb[L, 3:] = bbmax[ids].max(axis=0)
    lo = lb[:, :3].min(axis=0)
    hi = lb[:, 3:].max(axis=0)
    return lb, comp, flat.astype(np.int32), lo, np.maximum(hi - lo, 1e-6)


def build(p0, e1, e2, leaf_size=KT, *, device) -> BVHTiled:
    """Cluster triangles into SAH leaves; keep the leaf boxes and triangle
    blocks (no interior nodes)."""
    lb, comp, prim, lo, span = build_arrays(p0, e1, e2, leaf_size)

    def t(a):
        return torch.as_tensor(a, device=device)

    return BVHTiled(leaf_bounds=t(lb), tris=t(comp), prim=t(prim),
                    scene_lo=t(lo), scene_span=t(span), n_leaves=lb.shape[0])


# ---------------------------------------------------------------------------
# Phase 0: coherence sort
# ---------------------------------------------------------------------------

def _coherence_key(bvh: BVHTiled, o: Vec3, d: Vec3):
    """Octant-major key, refined by origin Morton then direction Morton
    (JAX's uint32 arithmetic in int64 lanes masked to 32 bits)."""
    def b(x):
        return x.to(torch.int64)

    oct_ = b(d.x >= 0) | (b(d.y >= 0) << 1) | (b(d.z >= 0) << 2)

    def q(x, lo, span):
        return b(torch.clamp((x - lo) / span * 16.0, 0.0, 15.0))

    def qd(x):
        return b(torch.clamp((x * 0.5 + 0.5) * 16.0, 0.0, 15.0))

    def part4(v):  # spread 4 bits to every 3rd position
        v = (v | (v << 8)) & 0x0F00F
        v = (v | (v << 4)) & 0xC30C3
        return (v | (v << 2)) & 0x249249

    lo, span = bvh.scene_lo, bvh.scene_span
    mo = (part4(q(o.x, lo[0], span[0])) | (part4(q(o.y, lo[1], span[1])) << 1)
          | (part4(q(o.z, lo[2], span[2])) << 2))
    md = part4(qd(d.x)) | (part4(qd(d.y)) << 1) | (part4(qd(d.z)) << 2)
    key = ((oct_ << 24) | ((mo & 0xFFF) << 12) | (md & 0xFFF)) & 0xFFFFFFFF
    return key.to(torch.int32)


def _pack_sorted(bvh: BVHTiled, o: Vec3, d: Vec3, maxt):
    """Rays in coherence order, padded to whole tiles: (ox, oy, oz, dx,
    dy, dz, maxt) [npad] each and the sorted lane ids [n]."""
    n = o.x.shape[0]
    npad = -(-n // TILE) * TILE
    _, lane_s = torch.sort(_coherence_key(bvh, o, d), stable=True)
    out = []
    for x, fill in ((o.x, 0.0), (o.y, 0.0), (o.z, 0.0), (d.x, 0.0),
                    (d.y, 0.0), (d.z, 1.0), (maxt, -1.0)):
        p = torch.full((npad,), fill, dtype=torch.float32, device=x.device)
        p[:n] = x[lane_s]
        out.append(p)
    return out, lane_s


# ---------------------------------------------------------------------------
# Phase 1: per-tile frustum vs leaf boxes
# ---------------------------------------------------------------------------

def _tile_leaf_lists(bvh: BVHTiled, ox, oy, oz, dx, dy, dz, mt):
    """[T * TILE] sorted rays -> per-tile leaf entry distances [T, M]
    (inf where the tile's conservative interval frustum misses the leaf)."""
    t_tiles = ox.shape[0] // TILE

    def tile_minmax(x):
        xr = x.reshape(t_tiles, TILE)
        return xr.amin(dim=1), xr.amax(dim=1)

    eps = 1e-20

    def inv_interval(dl, dh):
        # interval of 1/d over [dl, dh]; if the sign changes, widen to all
        mixed = (dl < 0.0) & (dh > 0.0)

        def safe(x):
            return torch.where(x.abs() < eps,
                               torch.where(x >= 0, eps, -eps), x)

        a = 1.0 / safe(dl)
        b = 1.0 / safe(dh)
        return (torch.where(mixed, -1e30, torch.minimum(a, b)),
                torch.where(mixed, 1e30, torch.maximum(a, b)))

    def axis_interval(bl, bh, ol, oh, il, ih):
        # interval of (b - o) * i over box slab b, o and i intervals
        c1l, c1h = bl[None, :] - oh[:, None], bh[None, :] - ol[:, None]
        p1 = c1l * il[:, None]
        p2 = c1l * ih[:, None]
        p3 = c1h * il[:, None]
        p4 = c1h * ih[:, None]
        return (torch.minimum(torch.minimum(p1, p2), torch.minimum(p3, p4)),
                torch.maximum(torch.maximum(p1, p2), torch.maximum(p3, p4)))

    lb = bvh.leaf_bounds
    t_near = t_far = None
    for ax, (o_ax, d_ax) in enumerate(((ox, dx), (oy, dy), (oz, dz))):
        ol, oh = tile_minmax(o_ax)
        il, ih = inv_interval(*tile_minmax(d_ax))
        nl, nh = axis_interval(lb[:, ax], lb[:, ax], ol, oh, il, ih)
        fl, fh = axis_interval(lb[:, ax + 3], lb[:, ax + 3], ol, oh, il, ih)
        tn, tf = torch.minimum(nl, fl), torch.maximum(nh, fh)
        t_near = tn if t_near is None else torch.maximum(t_near, tn)
        t_far = tf if t_far is None else torch.minimum(t_far, tf)
    mt_hi = mt.reshape(t_tiles, TILE).amax(dim=1)
    hit = (t_near <= t_far) & (t_far >= 0.0) & (t_near <= mt_hi[:, None])
    # where(> 0) rather than maximum(., 0): -0.0 becomes +0.0, as in JAX
    return torch.where(hit, torch.where(t_near > 0.0, t_near, 0.0),
                       float("inf"))


def _sort_leaf_lists(dist):
    """One batched sort of the per-tile leaf distances -> (leaf ids [T, C]
    i32, -1 pad; entries [T, C] f32, BIG pad), C a multiple of LB_USE."""
    t_tiles, m = dist.shape
    dist_s, ids_s = torch.sort(dist, dim=1, stable=True)
    fin = torch.isfinite(dist_s)
    ids_s = torch.where(fin, ids_s.to(torch.int32), -1)
    ents = torch.where(fin, dist_s, BIG)
    padc = -(-m // LB_USE) * LB_USE - m
    if padc:
        ids_s = torch.nn.functional.pad(ids_s, (0, padc), value=-1)
        ents = torch.nn.functional.pad(ents, (0, padc), value=BIG)
    return ids_s, ents


# ---------------------------------------------------------------------------
# Phase 2: kernel K4 and its plain version
# ---------------------------------------------------------------------------

def real_tris(slab):
    """Triangles with a prim id >= 0 (row 9) per slab [S, rows, K] -> [S]
    int64: the tests a ray needs against each slab, as its padding (id -1)
    never hits. Counts the work the kernels' bounds are taken from."""
    return (slab[:, 9] >= 0).sum(dim=1)


def _mt_slabs(slab, o, d):
    """Möller-Trumbore of slabs [S, 16, KT] against tiles of rays
    (o, d: 3-tuples of [S, 1, R]) -> (t, u, v, ok), each [S, KT, R]; the
    operation order is the kernels'."""
    def c(i):
        return slab[:, i, :, None]

    ox, oy, oz = o
    dx, dy, dz = d
    e2x, e2y, e2z = c(6), c(7), c(8)
    pvx = dy * e2z - dz * e2y
    pvy = dz * e2x - dx * e2z
    pvz = dx * e2y - dy * e2x
    e1x, e1y, e1z = c(3), c(4), c(5)
    det = e1x * pvx + e1y * pvy + e1z * pvz
    ok = det != 0.0
    dinv = torch.where(ok, 1.0 / torch.where(ok, det, 1.0), 0.0)
    tvx, tvy, tvz = ox - c(0), oy - c(1), oz - c(2)
    u = (tvx * pvx + tvy * pvy + tvz * pvz) * dinv
    qvx = tvy * e1z - tvz * e1y
    qvy = tvz * e1x - tvx * e1z
    qvz = tvx * e1y - tvy * e1x
    v = (dx * qvx + dy * qvy + dz * qvz) * dinv
    t = (e2x * qvx + e2y * qvy + e2z * qvz) * dinv
    ok = ok & (u >= 0.0) & (v >= 0.0) & (u + v <= 1.0)
    return t, u, v, ok


def run_round_plain(leaf_ids, entries, tris, o3, d3, t, prim, u, v,
                    closest: bool, stats: dict | None = None):
    """Plain PyTorch version of K4: leaf_ids [T, LB_USE] i32, entries
    [T, LB_USE] f32, tris [M, 16, KT], o3/d3 [3, T * TILE], running best
    t/prim/u/v [T * TILE] -> the updated (t, prim, u, v). Slot by slot a
    tile skips a leaf < 0 or one whose entry is beyond its worst t; hits
    need t in [0, best], a closest hit replaces at equal t and ties inside
    a leaf go to the largest id. Runs PLAIN_TILES tiles at a time. With
    `stats`, adds the (tile, slot) pairs taken to stats["slots"] and the
    ray-triangle tests this data needs to stats["tests"]: in each taken
    slot, every ray whose best t is >= 0 tests the leaf's real triangles,
    and in any-hit mode only those up to its first hit."""
    n_tiles = leaf_ids.shape[0]
    dev = o3.device
    t = t.clone().reshape(n_tiles, TILE)
    prim = prim.clone().reshape(n_tiles, TILE)
    u = u.clone().reshape(n_tiles, TILE)
    v = v.clone().reshape(n_tiles, TILE)
    o = o3.reshape(3, n_tiles, TILE)
    d = d3.reshape(3, n_tiles, TILE)
    for c0 in range(0, n_tiles, PLAIN_TILES):
        c1 = min(c0 + PLAIN_TILES, n_tiles)
        for slot in range(leaf_ids.shape[1]):
            leaf = leaf_ids[c0:c1, slot]
            worst = t[c0:c1].amax(dim=1)
            sel = torch.nonzero((leaf >= 0) & (entries[c0:c1, slot] <= worst)
                                ).squeeze(1)
            if sel.numel() == 0:
                continue
            rows = c0 + sel
            slab = tris[leaf[sel].long()]
            best = t[rows][:, None, :]
            tt, uu, vv, ok = _mt_slabs(
                slab, tuple(o[i, rows][:, None, :] for i in range(3)),
                tuple(d[i, rows][:, None, :] for i in range(3)))
            hit = ok & (tt >= 0.0) & (tt <= best)
            if stats is not None:
                # a ray with best t < 0 can hit nothing
                n = real_tris(slab)[:, None].expand(-1, best.shape[2])
                if not closest:
                    n = torch.where(hit.any(dim=1),
                                    hit.to(torch.int8).argmax(dim=1) + 1, n)
                stats["slots"] = stats.get("slots", 0) + sel.numel()
                stats["tests"] = stats.get("tests", 0) + int(
                    n[best[:, 0] >= 0.0].sum())
            if closest:
                t_m = torch.where(hit, tt, BIG)
                tmin = t_m.amin(dim=1)
                winner = hit & (t_m == tmin[:, None, :])
                ids = slab[:, 9, :, None].to(torch.int32)
                pw = torch.where(winner, ids, -1).amax(dim=1)
                final = winner & (ids == pw[:, None, :])
                better = pw >= 0
                t[rows] = torch.where(better, tmin, best[:, 0])
                prim[rows] = torch.where(better, pw, prim[rows])
                u[rows] = torch.where(
                    better, torch.where(final, uu, 0.0).sum(dim=1), u[rows])
                v[rows] = torch.where(
                    better, torch.where(final, vv, 0.0).sum(dim=1), v[rows])
            else:
                occ = hit.any(dim=1)
                prim[rows] = torch.where(occ, 1, prim[rows])
                t[rows] = torch.where(occ, -1.0, t[rows])
    return t.reshape(-1), prim.reshape(-1), u.reshape(-1), v.reshape(-1)


def run_round(leaf_ids, entries, tris, o3, d3, t, prim, u, v,
              closest: bool):
    """K4: one round of LB_USE leaf slots per 1024-ray tile (arguments as
    run_round_plain's). CPU tensors take the plain version; CUDA tensors
    launch the kernel of csrc/bvh_tiled_mt.cu on the current stream. In
    any-hit mode u and v come back as given."""
    dev = o3.device
    tensors = (leaf_ids, entries, tris, o3, d3, t, prim, u, v)
    if native.on_cpu(*tensors):
        return run_round_plain(*tensors, closest)
    if dev.type != "cuda":
        raise ValueError(f"run_round: rays on {dev}; the kernel needs "
                         f"every tensor on one CUDA device")
    n_tiles = leaf_ids.shape[0]
    npad = n_tiles * TILE
    check = functools.partial(native.check, "run_round")
    check("leaf_ids", leaf_ids, torch.int32, (n_tiles, LB_USE), dev)
    check("entries", entries, torch.float32, (n_tiles, LB_USE), dev)
    check("tris", tris, torch.float32, (tris.shape[0], 16, KT), dev)
    check("o3", o3, torch.float32, (3, npad), dev)
    check("d3", d3, torch.float32, (3, npad), dev)
    check("t", t, torch.float32, (npad,), dev)
    check("prim", prim, torch.int32, (npad,), dev)
    check("u", u, torch.float32, (npad,), dev)
    check("v", v, torch.float32, (npad,), dev)
    t_o, p_o = torch.empty_like(t), torch.empty_like(prim)
    u_o, v_o = (torch.empty_like(u), torch.empty_like(v)) if closest \
        else (u, v)
    if n_tiles == 0:
        return t_o, p_o, u_o, v_o
    native.launch(
        "bvh_tiled_mt", "pppppppppippppi", leaf_ids.data_ptr(),
        entries.data_ptr(), tris.data_ptr(), o3.data_ptr(), d3.data_ptr(),
        t.data_ptr(), prim.data_ptr(), u.data_ptr(), v.data_ptr(), n_tiles,
        t_o.data_ptr(), p_o.data_ptr(), u_o.data_ptr(), v_o.data_ptr(),
        int(closest), dev=dev)
    LAUNCHES["closest" if closest else "anyhit"] += 1
    return t_o, p_o, u_o, v_o


# ---------------------------------------------------------------------------
# Queries
# ---------------------------------------------------------------------------

def _trace_sorted(bvh: BVHTiled, ox, oy, oz, dx, dy, dz, mt_s,
                  closest: bool):
    dist = _tile_leaf_lists(bvh, ox, oy, oz, dx, dy, dz, mt_s)  # [T, M]
    ids_s, ents_s = _sort_leaf_lists(dist)
    n_rounds = ids_s.shape[1] // LB_USE
    o3 = torch.stack([ox, oy, oz], dim=0)
    d3 = torch.stack([dx, dy, dz], dim=0)
    t_c = mt_s
    prim_c = torch.full_like(mt_s, -1, dtype=torch.int32)
    u_c = torch.zeros_like(mt_s)
    v_c = torch.zeros_like(mt_s)
    for r in range(n_rounds):
        tile_best = t_c.reshape(-1, TILE).amax(dim=1)
        if not bool((ents_s[:, r * LB_USE] <= tile_best).any()):
            break
        win = slice(r * LB_USE, (r + 1) * LB_USE)
        t_c, prim_c, u_c, v_c = run_round(
            ids_s[:, win].contiguous(), ents_s[:, win].contiguous(),
            bvh.tris, o3, d3, t_c, prim_c, u_c, v_c, closest)
    return t_c, prim_c, u_c, v_c


def _trace(bvh: BVHTiled, o: Vec3, d: Vec3, maxt, closest: bool):
    n = o.x.shape[0]
    if n == 0:
        e = torch.zeros(0, dtype=torch.float32, device=o.x.device)
        return e, e.to(torch.int32), e, e
    maxt = torch.clamp(maxt, max=3e38)
    (ox, oy, oz, dx, dy, dz, mt_s), lane_s = _pack_sorted(bvh, o, d, maxt)
    t, prim, u, v = _trace_sorted(bvh, ox, oy, oz, dx, dy, dz, mt_s,
                                  closest)
    # back to the caller's lane order
    outs = []
    for x in (t, prim, u, v):
        y = torch.empty_like(x[:n])
        y[lane_s] = x[:n]
        outs.append(y)
    return tuple(outs)


def _lanes(o: Vec3, maxt, active):
    maxt = torch.as_tensor(maxt, dtype=torch.float32,
                           device=o.x.device).expand(o.x.shape[0])
    if active is not None:
        maxt = torch.where(active, maxt, -1.0)
    return maxt


def intersect_bvh(bvh: BVHTiled, o: Vec3, d: Vec3, maxt, active=None):
    """Closest hit -> (t [N], prim [N], uv Vec2, valid [N])."""
    t, prim, u, v = _trace(bvh, o, d, _lanes(o, maxt, active), closest=True)
    return t, prim, Vec2(u, v), prim >= 0


def occluded_bvh(bvh: BVHTiled, o: Vec3, d: Vec3, maxt, active=None):
    """Any hit with t in [0, maxt] -> bool [N]."""
    _, slot, _, _ = _trace(bvh, o, d, _lanes(o, maxt, active),
                           closest=False)
    return slot >= 0
