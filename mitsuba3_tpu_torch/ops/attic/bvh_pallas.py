"""Packet BVH traversal — counterpart of
``mitsuba3_tpu/ops/attic/bvh_pallas.py``.

The SAH builder (``native.build_bvh``, the JAX package's C++) makes a
binary BVH whose leaves hold at most 128 triangles, stored leaf-major as
[M, 16, 128] component rows. Rays go in tiles of 1024, and each tile walks
the tree as one packet (kernel K5, ``csrc/bvh_pallas_traverse.cu``): a
node is visited if any ray of the tile enters its box before its best t,
and a visited leaf runs a dense Möller–Trumbore test of its triangles
against the whole tile. ``intersect_bvh_sorted`` first sorts the rays by a
direction-octant and origin-Morton key, so that a tile's rays agree on a
region of the tree.

As in the JAX package's build, node bounds are padded to 8 columns and
slab rows 9-15 stay zero. Unlike JAX it never falls back to the median
split (a failed build raises), and it refuses a tree deeper than its
128-slot stack holds. The sorts are stable, as JAX's ``lax.sort`` is.
"""
from __future__ import annotations

import functools

import numpy as np
import torch

from ... import native as native_bvh
from ...core.struct import struct
from ...core.vec import Vec2, Vec3
from .. import bvh_tiled, native
from ..bvh_tiled import _lanes

TILE = 1024        # rays per tile (one CTA of K5)
STACK = 128        # traversal stack slots
K = 128            # leaf capacity
BIG = 3.4e38
EPS = 1e-20        # |d| below this counts as +-EPS in 1 / d
PLAIN_TILES = 64   # tiles per step of traverse_plain ([64, 128, 1024])

# Kernel launches of `traverse` by mode. Only the wrapper adds to these,
# and only where it launches the CUDA kernel; callers reset them to 0.
LAUNCHES = {"closest": 0, "anyhit": 0}


@struct
class BVHData:
    node_bounds: torch.Tensor  # [Nn, 8] f32 lo xyz, hi xyz, 2 zero columns
    node_meta: torch.Tensor    # [Nn, 2] i32 children, or (-leaf - 1, count)
    tris: torch.Tensor         # [M, 16, K] f32 rows 0-8 p0/e1/e2 xyz
    prim_order: torch.Tensor   # [M * K] i32 triangle id of each slot, -1 pad
    n_leaves: int = 0


def _depth(node_meta) -> int:
    """Depth of the tree (the root is at depth 0); children follow their
    parent in the builder's node order."""
    depth = np.zeros(len(node_meta), np.int64)
    for node, (a, b) in enumerate(node_meta):
        if a >= 0:
            depth[[a, b]] = depth[node] + 1
    return int(depth.max())


def build(p0, e1, e2, leaf_size=K, *, device) -> BVHData:
    """SAH BVH of world-space triangles (numpy [T, 3] each)."""
    p0 = np.asarray(p0, np.float32)
    e1 = np.asarray(e1, np.float32)
    e2 = np.asarray(e2, np.float32)
    v1, v2 = p0 + e1, p0 + e2
    bbmin = np.minimum(np.minimum(p0, v1), v2)
    bbmax = np.maximum(np.maximum(p0, v1), v2)
    order, nb, nm, lf, lc = native_bvh.build_bvh(bbmin, bbmax, leaf_size)
    # a walk holds at most depth + 1 ids on its stack
    if _depth(nm) + 1 > STACK:
        raise ValueError(f"bvh_pallas: tree depth {_depth(nm)} overflows "
                         f"the {STACK}-slot traversal stack")
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
    nb8 = np.zeros((nb.shape[0], 8), np.float32)
    nb8[:, :6] = nb

    def t(a):
        return torch.as_tensor(a, device=device)

    return BVHData(node_bounds=t(nb8), node_meta=t(nm), tris=t(comp),
                   prim_order=t(flat.astype(np.int32)), n_leaves=m)


# ---------------------------------------------------------------------------
# Kernel K5 and its plain version
# ---------------------------------------------------------------------------

def _inv(c):
    return 1.0 / torch.where(c.abs() < EPS, torch.where(c >= 0, EPS, -EPS), c)


def _visit(nb, o, inv, best):
    """Slab test of boxes nb [S, 8] against tiles of rays (o, inv: [3, S,
    TILE]; best [S, TILE]) -> [S]: does any ray of the tile enter?"""
    tn = tf = None
    for a in range(3):
        t0 = (nb[:, a, None] - o[a]) * inv[a]
        t1 = (nb[:, a + 3, None] - o[a]) * inv[a]
        lo, hi = torch.minimum(t0, t1), torch.maximum(t0, t1)
        tn = lo if tn is None else torch.maximum(tn, lo)
        tf = hi if tf is None else torch.minimum(tf, hi)
    return ((tn <= tf) & (tf >= 0.0) & (tn <= best)).any(dim=1)


def _add(stats, key, n):
    if stats is not None:
        stats[key] = stats.get(key, 0) + int(n)


def _add_tiles(stats, key, per_tile):
    """Add a per-tile count (a tensor [n_tiles]) to the list stats[key]."""
    old = stats.get(key)
    counts = per_tile.tolist()
    stats[key] = counts if old is None else [a + b for a, b in
                                             zip(old, counts)]


def traverse_plain(acc: BVHData, o3, d3, mt, closest: bool,
                   stats: dict | None = None):
    """Plain PyTorch version of K5: o3, d3 [3, T * TILE], mt [T * TILE] ->
    (t, slot, u, v) [T * TILE]; slot is leaf * K + column (-1 none) in
    closest mode, 1 for an occluded ray in any-hit mode (t then -1); u and
    v stay 0 in any-hit mode. The tiles walk in lockstep, PLAIN_TILES at a
    time, each with its own stack, one node per tile per step, so each
    keeps the kernel's visit order (which decides ties between leaves).
    With `stats`, adds the (tile, node) visits to stats["nodes"], their
    box tests (TILE each) to stats["box_tests"], the (tile, leaf) pairs
    tested to stats["leaves"] and the ray-triangle tests this data needs
    to stats["tests"]: in each tested leaf, every ray whose best t is >= 0
    tests the leaf's triangles, in any-hit mode only those up to its first
    hit. It also adds each tile's node visits and tests to the lists
    stats["tile_nodes"] and stats["tile_tests"] (one entry per tile)."""
    npad = o3.shape[1]
    n_tiles = npad // TILE
    dev = o3.device
    o = o3.reshape(3, n_tiles, TILE)
    d = d3.reshape(3, n_tiles, TILE)
    inv = _inv(d)
    t = mt.reshape(n_tiles, TILE).clone()
    slot = torch.full((n_tiles, TILE), -1, dtype=torch.int32, device=dev)
    u = torch.zeros((n_tiles, TILE), dtype=torch.float32, device=dev)
    v = torch.zeros_like(u)
    col = torch.arange(K, dtype=torch.int64, device=dev)
    if stats is not None:
        tile_nodes = torch.zeros(n_tiles, dtype=torch.int64, device=dev)
        tile_tests = torch.zeros_like(tile_nodes)
    for c0 in range(0, n_tiles, PLAIN_TILES):
        w = min(PLAIN_TILES, n_tiles - c0)
        stack = torch.zeros((w, STACK), dtype=torch.int64, device=dev)
        sp = torch.ones(w, dtype=torch.int64, device=dev)
        while True:
            live = torch.nonzero(sp > 0).squeeze(1)
            if live.numel() == 0:
                break
            sp[live] -= 1
            node = stack[live, sp[live]]
            tiles = c0 + live
            enter = _visit(acc.node_bounds[node], o[:, tiles], inv[:, tiles],
                           t[tiles])
            _add(stats, "nodes", live.numel())
            _add(stats, "box_tests", live.numel() * TILE)
            if stats is not None:
                tile_nodes[tiles] += 1
            meta = acc.node_meta[node].to(torch.int64)
            push = enter & (meta[:, 0] >= 0)
            rows = live[push]
            stack[rows, sp[rows]] = meta[push, 0]
            stack[rows, sp[rows] + 1] = meta[push, 1]
            sp[rows] += 2
            is_leaf = enter & (meta[:, 0] < 0)
            if not bool(is_leaf.any()):
                continue
            lrows = tiles[is_leaf]
            leaf = -meta[is_leaf, 0] - 1
            best = t[lrows]
            tt, uu, vv, ok = bvh_tiled._mt_slabs(
                acc.tris[leaf], tuple(o[a, lrows][:, None] for a in range(3)),
                tuple(d[a, lrows][:, None] for a in range(3)))
            hit = ok & (tt >= 0.0) & (tt <= best[:, None])   # [L, K, TILE]
            if stats is not None:
                n = meta[is_leaf, 1][:, None].expand_as(best)
                if not closest:
                    n = torch.where(hit.any(dim=1),
                                    hit.to(torch.int8).argmax(dim=1) + 1, n)
                per_tile = torch.where(best >= 0.0, n, 0).sum(dim=1)
                _add(stats, "leaves", lrows.numel())
                _add(stats, "tests", per_tile.sum())
                tile_tests[lrows] += per_tile
            if closest:
                t_m = torch.where(hit, tt, BIG)
                tmin = t_m.amin(dim=1)
                winner = hit & (t_m == tmin[:, None])
                ids = (leaf[:, None] * K + col[None, :])[:, :, None]
                pw = torch.where(winner, ids, -1).amax(dim=1)
                final = winner & (ids == pw[:, None])
                better = pw >= 0     # tmin <= best already, via the hit test
                t[lrows] = torch.where(better, tmin, best)
                slot[lrows] = torch.where(better, pw.to(torch.int32),
                                          slot[lrows])
                u[lrows] = torch.where(
                    better, torch.where(final, uu, 0.0).sum(dim=1), u[lrows])
                v[lrows] = torch.where(
                    better, torch.where(final, vv, 0.0).sum(dim=1), v[lrows])
            else:
                occ = hit.any(dim=1)
                slot[lrows] = torch.where(occ, 1, slot[lrows])
                t[lrows] = torch.where(occ, -1.0, best)
    if stats is not None:
        _add_tiles(stats, "tile_nodes", tile_nodes)
        _add_tiles(stats, "tile_tests", tile_tests)
    return t.reshape(-1), slot.reshape(-1), u.reshape(-1), v.reshape(-1)


def traverse(acc: BVHData, o3, d3, mt, closest: bool):
    """K5: the packet walk of every 1024-ray tile (arguments and results as
    traverse_plain's). CPU tensors take the plain version; CUDA tensors
    launch the kernel of csrc/bvh_pallas_traverse.cu on the current
    stream."""
    tensors = (acc.node_bounds, acc.node_meta, acc.tris, o3, d3, mt)
    if native.on_cpu(*tensors):
        return traverse_plain(acc, o3, d3, mt, closest)
    dev = o3.device
    if dev.type != "cuda":
        raise ValueError(f"traverse: rays on {dev}; the kernel needs every "
                         f"tensor on one CUDA device")
    npad = o3.shape[1]
    if npad % TILE:
        raise ValueError(f"traverse: width {npad} is not a multiple of "
                         f"{TILE}")
    n_nodes = acc.node_bounds.shape[0]
    check = functools.partial(native.check, "traverse")
    check("node_bounds", acc.node_bounds, torch.float32, (n_nodes, 8), dev)
    check("node_meta", acc.node_meta, torch.int32, (n_nodes, 2), dev)
    check("tris", acc.tris, torch.float32, (acc.tris.shape[0], 16, K), dev)
    check("o3", o3, torch.float32, (3, npad), dev)
    check("d3", d3, torch.float32, (3, npad), dev)
    check("mt", mt, torch.float32, (npad,), dev)
    t = torch.empty(npad, dtype=torch.float32, device=dev)
    slot = torch.empty(npad, dtype=torch.int32, device=dev)
    u = torch.zeros(npad, dtype=torch.float32, device=dev)
    v = torch.zeros_like(u)
    if npad == 0:
        return t, slot, u, v
    native.launch("bvh_pallas_traverse", "ppppppippppi",
                  acc.node_bounds.data_ptr(), acc.node_meta.data_ptr(),
                  acc.tris.data_ptr(), o3.data_ptr(), d3.data_ptr(),
                  mt.data_ptr(), npad // TILE, t.data_ptr(), slot.data_ptr(),
                  u.data_ptr(), v.data_ptr(), int(closest), dev=dev)
    LAUNCHES["closest" if closest else "anyhit"] += 1
    return t, slot, u, v


# ---------------------------------------------------------------------------
# Queries
# ---------------------------------------------------------------------------

def pack_rays(o: Vec3, d: Vec3, maxt):
    """(o3, d3 [3, npad], mt [npad]) padded to whole tiles: padding lanes
    have d = (0, 0, 1) and maxt -1."""
    n = o.x.shape[0]
    npad = -(-n // TILE) * TILE
    dev = o.x.device
    o3 = torch.zeros((3, npad), dtype=torch.float32, device=dev)
    d3 = torch.zeros((3, npad), dtype=torch.float32, device=dev)
    d3[2] = 1.0
    for i, (oc, dc) in enumerate(((o.x, d.x), (o.y, d.y), (o.z, d.z))):
        o3[i, :n] = oc
        d3[i, :n] = dc
    mt = torch.full((npad,), -1.0, dtype=torch.float32, device=dev)
    mt[:n] = maxt
    return o3, d3, mt


def _closest(acc: BVHData, o: Vec3, d: Vec3, mt):
    n = o.x.shape[0]
    t, slot, u, v = traverse(acc, *pack_rays(o, d, mt), True)
    slot = slot[:n]
    valid = slot >= 0
    prim = torch.where(valid, acc.prim_order[torch.clamp(slot, min=0).long()],
                       -1)
    return t[:n], prim, u[:n], v[:n], valid


def intersect_bvh(acc: BVHData, o: Vec3, d: Vec3, maxt, active=None):
    """Closest hit -> (t [N] (maxt, clipped to 3e38, where none), prim [N]
    (original ids), uv Vec2, valid [N])."""
    mt = torch.clamp(_lanes(o, maxt, active), max=3e38)
    t, prim, u, v, valid = _closest(acc, o, d, mt)
    return t, prim, Vec2(u, v), valid


def occluded_bvh(acc: BVHData, o: Vec3, d: Vec3, maxt, active=None):
    """Any hit with t in [0, maxt] -> bool [N]."""
    n = o.x.shape[0]
    mt = _lanes(o, maxt, active)
    return traverse(acc, *pack_rays(o, d, mt), False)[1][:n] > 0


# ---------------------------------------------------------------------------
# Sorted traversal
# ---------------------------------------------------------------------------

def _coherence_key(acc: BVHData, o: Vec3, d: Vec3):
    """3-bit direction octant under a 9-bit Morton cell of the origin in the
    root box (JAX's uint32 arithmetic in int64 lanes) -> int32 [N]."""
    def b(x):
        return x.to(torch.int64)

    root = acc.node_bounds[0]
    lo = root[:3]
    span = torch.clamp(root[3:6] - root[:3], min=1e-6)
    oct_ = b(d.x >= 0) | (b(d.y >= 0) << 1) | (b(d.z >= 0) << 2)

    def q3(x, a):
        return b(torch.clamp((x - lo[a]) / span[a] * 8.0, 0.0, 7.0))

    def part(v):  # spread 3 bits to every 3rd position
        v = (v | (v << 4)) & 0x0C3
        return (v | (v << 2)) & 0x249

    morton = (part(q3(o.x, 0)) | (part(q3(o.y, 1)) << 1)
              | (part(q3(o.z, 2)) << 2))
    return ((morton << 3) | oct_).to(torch.int32)


def _sorted(acc: BVHData, o: Vec3, d: Vec3, mt):
    """Rays co-sorted by the coherence key (stable) and the sort's lane
    ids."""
    _, lane = torch.sort(_coherence_key(acc, o, d), stable=True)
    return (Vec3(o.x[lane], o.y[lane], o.z[lane]),
            Vec3(d.x[lane], d.y[lane], d.z[lane]), mt[lane], lane)


def _unsort(lane, *xs):
    outs = []
    for x in xs:
        y = torch.empty_like(x)
        y[lane] = x
        outs.append(y)
    return outs


def intersect_bvh_sorted(acc: BVHData, o: Vec3, d: Vec3, maxt, active=None):
    """intersect_bvh over coherence-sorted tiles, results in the caller's
    order."""
    mt = torch.clamp(_lanes(o, maxt, active), max=3e38)
    os_, ds, mt_s, lane = _sorted(acc, o, d, mt)
    t, prim, u, v, valid = _unsort(lane, *_closest(acc, os_, ds, mt_s))
    return t, prim, Vec2(u, v), valid


def occluded_bvh_sorted(acc: BVHData, o: Vec3, d: Vec3, maxt, active=None):
    os_, ds, mt_s, lane = _sorted(acc, o, d, _lanes(o, maxt, active))
    return _unsort(lane, occluded_bvh(acc, os_, ds, mt_s))[0]
