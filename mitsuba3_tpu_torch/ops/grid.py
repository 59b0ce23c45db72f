"""Uniform-grid DDA intersector with empty-space skipping
(``MI3T_ACCEL=grid``, and the closest-hit side of a ``HybridAccel``) —
counterpart of ``mitsuba3_tpu/ops/grid.py``.

Table layout ([res^3 + spill, 128] f32; one row per cell, then the spill
rows of cells holding more than K = 8 triangles):
  cols 0..71   K triangles SoA (p0, e1, e2 components)
  cols 72..79  prim ids (int32 bit patterns, -1 pad)
  col  80      link (int32 bit pattern): >= 0 chain row | -1 end |
               <= -2 empty cell, skip = -link - 2 cells (a Chebyshev
               distance transform of the occupancy, capped at MAX_SKIP)
Each step of a lane recomputes its cell from its position, reads that
row (or its chain's next row), tests the row's K triangles, and advances
to the cell's exit (occupied) or by the skip radius (empty), for at most
``max_steps`` steps: a lane still marching then keeps what it found.

The build is bit-equal to the JAX package's: the per-cell loop that fills
the rows is done as one scatter of the sorted (cell, triangle) pairs.

Differences from the JAX package:
- a closest query clamps maxt to 3e38, as bvh_xla's does. JAX's takes an
  infinite maxt as it comes; a lane whose first row holds no hit then
  keeps that row's first prim id with t 3.4e38, and a ray that leaves the
  grid after starting in an occupied cell reports a hit there. With a
  finite maxt the two agree bit for bit;
- the host looks at the lanes every CHECK_EVERY steps, not after each (a
  finished lane is a no-op in a step), and once at most half of the lanes
  in the loop are live, the loop goes on with those lanes only.
"""
from __future__ import annotations

import numpy as np
import torch

from ..core.struct import struct
from ..core.vec import Vec2, Vec3

K_DEFAULT = 8    # triangles per row
ROW_OF = {8: 128, 24: 256, 50: 512}   # padded row widths
BIG = 3.4e38
MAX_SKIP = 14
CHECK_EVERY = 8  # DDA steps between the host's looks at the lanes

# DDA steps run and queries made, by mode, summed over queries. Only the
# queries add to these; callers reset them to 0.
STEPS = {"closest": 0, "anyhit": 0}
QUERIES = {"closest": 0, "anyhit": 0}


@struct
class GridAccel:
    table: torch.Tensor      # [res^3 + spill, ROW] f32
    lo: torch.Tensor         # [3] f32 grid origin
    inv_cell: torch.Tensor   # [3] f32 1 / cell size
    res: int = 0
    max_steps: int = 0
    k: int = 8


def build(p0, e1, e2, res: int | None = None, k: int = K_DEFAULT, *,
          device) -> GridAccel:
    """The grid's table on `device`, as the JAX build makes it."""
    from scipy import ndimage
    p0 = np.asarray(p0, np.float32)
    e1 = np.asarray(e1, np.float32)
    e2 = np.asarray(e2, np.float32)
    f = p0.shape[0]
    v1, v2 = p0 + e1, p0 + e2
    bbmin = np.minimum(np.minimum(p0, v1), v2)
    bbmax = np.maximum(np.maximum(p0, v1), v2)
    lo = bbmin.min(axis=0)
    hi = bbmax.max(axis=0)
    span = np.maximum(hi - lo, 1e-6)
    lo = lo - span * 1e-4
    hi = hi + span * 1e-4
    span = hi - lo
    if res is None:
        # ~4 cells per triangle, capped to keep the dense table small
        res = int(np.clip(round((4.0 * f) ** (1.0 / 3.0)), 16, 48))
    cell = span / res
    inv_cell = 1.0 / cell

    clo = np.clip(((bbmin - lo) * inv_cell).astype(np.int64), 0, res - 1)
    chi = np.clip(((bbmax - lo) * inv_cell).astype(np.int64), 0, res - 1)
    counts = (chi - clo + 1).prod(axis=1)
    total = int(counts.sum())
    tri_ids = np.repeat(np.arange(f), counts)
    start = np.zeros(f + 1, np.int64)
    np.cumsum(counts, out=start[1:])
    within = np.arange(total) - start[tri_ids]
    nx = (chi[:, 0] - clo[:, 0] + 1)[tri_ids]
    ny = (chi[:, 1] - clo[:, 1] + 1)[tri_ids]
    cx = clo[tri_ids, 0] + within % nx
    cy = clo[tri_ids, 1] + (within // nx) % ny
    cz = clo[tri_ids, 2] + within // (nx * ny)
    cell_ids = (cz * res + cy) * res + cx

    order = np.argsort(cell_ids, kind="stable")
    cell_sorted = cell_ids[order]
    tri_sorted = tri_ids[order]
    uniq, seg_start, seg_count = np.unique(cell_sorted,
                                           return_index=True,
                                           return_counts=True)
    row_w = ROW_OF[k]
    link_col = 10 * k
    n_blocks_per = (seg_count + k - 1) // k
    n_cells = res ** 3
    n_spill = int(np.maximum(n_blocks_per - 1, 0).sum())
    n_rows = n_cells + max(n_spill, 1)
    table = np.zeros((n_rows, row_w), np.float32)
    prim_col = np.full((n_rows, k), -1, np.int32)
    link = np.full(n_rows, -1, np.int32)

    # Chebyshev distance transform for empty-space skipping
    occ = np.zeros((res, res, res), bool)
    occ.reshape(-1)[uniq] = True
    dist = ndimage.distance_transform_cdt(
        ~occ, metric="chessboard").astype(np.int32)
    skip = np.clip(dist - 1, 0, MAX_SKIP)  # safe L-inf radius of empties
    empty_flat = ~occ.reshape(-1)
    link[:n_cells][empty_flat] = -2 - skip.reshape(-1)[empty_flat]

    # block b of occupied cell s: the cell's own row for b = 0, else spill
    # row spill0[s] + b - 1 (spill rows in cell order); a block links to
    # the next block's row, the last one to -1
    spill0 = n_cells + np.concatenate(
        [[0], np.cumsum(n_blocks_per - 1)[:-1]]).astype(np.int64)
    seg = np.repeat(np.arange(uniq.shape[0]), seg_count)
    w = np.arange(total) - seg_start[seg]
    blk, col = w // k, w % k

    def row_of(s, b):
        return np.where(b == 0, uniq[s], spill0[s] + b - 1)

    rows = row_of(seg, blk)
    tri9 = np.concatenate([p0, e1, e2], axis=1)  # [F, 9]
    for comp in range(9):
        table[rows, comp * k + col] = tri9[tri_sorted, comp]
    prim_col[rows, col] = tri_sorted
    bs = np.repeat(np.arange(uniq.shape[0]), n_blocks_per)
    bb = np.arange(bs.shape[0]) - np.repeat(
        np.cumsum(n_blocks_per) - n_blocks_per, n_blocks_per)
    link[row_of(bs, bb)] = np.where(bb + 1 < n_blocks_per[bs],
                                    row_of(bs, bb + 1), -1)
    table[:, 9 * k: 10 * k] = prim_col.view(np.float32)
    table[:, link_col] = link.view(np.float32)

    def t(a):
        return torch.as_tensor(np.asarray(a, np.float32), device=device)

    return GridAccel(table=t(table), lo=t(lo), inv_cell=t(inv_cell),
                     res=int(res),
                     max_steps=int(3 * res + int(n_blocks_per.max(initial=1))
                                   + 8), k=k)


def _mt_rows(o, d, row, mint, maxt, k: int):
    """Möller–Trumbore on per-lane triangle rows: row [N, ROW] -> (t, u,
    v, prim, hit), each [N, K]."""
    def comp(i):
        return row[:, i * k:(i + 1) * k]
    p0x, p0y, p0z = comp(0), comp(1), comp(2)
    e1x, e1y, e1z = comp(3), comp(4), comp(5)
    e2x, e2y, e2z = comp(6), comp(7), comp(8)
    prim = row[:, 9 * k:10 * k].contiguous().view(torch.int32)
    ox, oy, oz = (a[:, None] for a in o)
    dx, dy, dz = (a[:, None] for a in d)
    pvx = dy * e2z - dz * e2y
    pvy = dz * e2x - dx * e2z
    pvz = dx * e2y - dy * e2x
    det = e1x * pvx + e1y * pvy + e1z * pvz
    ok = det.abs() > 1e-12
    inv = torch.where(ok, 1.0 / det, 0.0)
    tvx, tvy, tvz = ox - p0x, oy - p0y, oz - p0z
    u = (tvx * pvx + tvy * pvy + tvz * pvz) * inv
    qx = tvy * e1z - tvz * e1y
    qy = tvz * e1x - tvx * e1z
    qz = tvx * e1y - tvy * e1x
    v = (dx * qx + dy * qy + dz * qz) * inv
    t = (e2x * qx + e2y * qy + e2z * qz) * inv
    hit = (ok & (u >= 0) & (v >= 0) & (u + v <= 1) & (t > mint[:, None])
           & (t < maxt[:, None]) & (prim >= 0))
    return t, u, v, prim, hit


def _setup(g: GridAccel, o: Vec3, d: Vec3, maxt_v):
    """The rays in grid space and their clip: (og, dg, inv_d, max_comp,
    t_in, t_out), og, dg and inv_d 3-tuples of [N]."""
    res = g.res
    lo, ic = g.lo, g.inv_cell
    og = ((o.x - lo[0]) * ic[0], (o.y - lo[1]) * ic[1],
          (o.z - lo[2]) * ic[2])
    tiny = 1e-12
    # zero components guarded (the DDA divides by dg)
    dg = tuple(torch.where(c.abs() < tiny, tiny, c)
               for c in (d.x * ic[0], d.y * ic[1], d.z * ic[2]))
    inv_d = tuple(1.0 / c for c in dg)
    max_comp = torch.maximum(torch.maximum(dg[0].abs(), dg[1].abs()),
                             dg[2].abs())
    t0 = [(0.0 - og[i]) * inv_d[i] for i in range(3)]
    t1 = [(res - og[i]) * inv_d[i] for i in range(3)]
    t_in = torch.maximum(
        torch.maximum(torch.minimum(t0[0], t1[0]),
                      torch.minimum(t0[1], t1[1])),
        torch.clamp(torch.minimum(t0[2], t1[2]), min=0.0))
    t_out = torch.minimum(
        torch.minimum(torch.maximum(t0[0], t1[0]),
                      torch.maximum(t0[1], t1[1])),
        torch.maximum(t0[2], t1[2]))
    return og, dg, inv_d, max_comp, t_in, torch.minimum(t_out, maxt_v)


def _march(g: GridAccel, o: Vec3, d: Vec3, maxt_v, active, any_hit: bool):
    """The DDA of every lane -> (best_t, best_p, u, v) for a closest
    query, (occluded,) for an any-hit one; each [N]."""
    mode = "anyhit" if any_hit else "closest"
    QUERIES[mode] += 1
    n = o.x.shape[0]
    dev = o.x.device
    res, k = g.res, g.k
    og, dg, inv_d, max_comp, t_in, t_out = _setup(g, o, d, maxt_v)
    miss = (t_in > t_out) | ~active
    eps_t = 1e-4 / torch.clamp(max_comp, min=1e-12)
    o3, d3 = (o.x, o.y, o.z), (d.x, d.y, d.z)
    # per-lane constants and state, compacted together
    const = [*o3, *d3, *og, *dg, *inv_d, max_comp, eps_t, t_out, maxt_v]
    t_cur = t_in + eps_t
    chain = torch.full((n,), -2, dtype=torch.int64, device=dev)
    if any_hit:
        outs = [torch.zeros(n, dtype=torch.bool, device=dev)]
    else:
        outs = [maxt_v.clone(), torch.full((n,), -1, dtype=torch.int32,
                                           device=dev),
                torch.zeros(n, dtype=torch.float32, device=dev),
                torch.zeros(n, dtype=torch.float32, device=dev)]
    lanes = torch.nonzero(~miss)[:, 0]
    if lanes.numel() == 0:
        return outs
    const = [c[lanes] for c in const]
    state = [t_cur[lanes], chain[lanes]] + [x[lanes] for x in outs]
    done = torch.zeros(lanes.numel(), dtype=torch.bool, device=dev)
    kk = torch.arange(k, device=dev)[None, :]
    table = g.table
    link_col = 10 * k
    it = 0
    while it < g.max_steps:
        (ox, oy, oz, dx, dy, dz, ogx, ogy, ogz, dgx, dgy, dgz,
         idx, idy, idz, mc, eps, t_o, mx) = const
        for _ in range(min(CHECK_EVERY, g.max_steps - it)):
            t_cur, chain = state[0], state[1]
            px = ogx + dgx * t_cur
            py = ogy + dgy * t_cur
            pz = ogz + dgz * t_cur
            # floor as JAX computes it: truncation less one below zero
            cx = torch.clamp(px.to(torch.int32) - (px < 0).to(torch.int32),
                             0, res - 1).long()
            cy = torch.clamp(py.to(torch.int32) - (py < 0).to(torch.int32),
                             0, res - 1).long()
            cz = torch.clamp(pz.to(torch.int32) - (pz < 0).to(torch.int32),
                             0, res - 1).long()
            bid = torch.where(chain >= 0, chain, (cz * res + cy) * res + cx)
            # the one row read of a step
            row = table[torch.where(done, 0, bid)]
            link = row[:, link_col].contiguous().view(torch.int32)
            is_empty = (chain < 0) & (link <= -2)
            skip = torch.where(is_empty, (-link - 2).to(torch.float32), 0.0)
            live_row = (~done & ~is_empty)[:, None]
            nbx = torch.where(dgx > 0, cx + 1, cx).to(torch.float32)
            nby = torch.where(dgy > 0, cy + 1, cy).to(torch.float32)
            nbz = torch.where(dgz > 0, cz + 1, cz).to(torch.float32)
            t_exit = torch.minimum(torch.minimum((nbx - ogx) * idx,
                                                 (nby - ogy) * idy),
                                   (nbz - ogz) * idz)
            # empty-space skip: cells within L-inf radius `skip` are
            # empty, so advancing the position by skip cells is hit-free
            t_next = torch.maximum(t_exit, t_cur + skip / mc) + eps
            if any_hit:
                occ = state[2]
                hit = _mt_rows((ox, oy, oz), (dx, dy, dz), row,
                               torch.full_like(t_cur, 1e-6), mx, k)[4]
                hit_any = (hit & live_row).any(dim=1)
                occ = occ | hit_any
                in_chain = ~is_empty & (link >= 0) & ~hit_any
                done2 = done | hit_any | (~in_chain & (t_next > t_o))
                extra = [occ]
            else:
                best_t, best_p, bu, bv = state[2:]
                t, u, v, prim, hit = _mt_rows(
                    (ox, oy, oz), (dx, dy, dz), row,
                    torch.full_like(best_t, 1e-6), best_t, k)
                hit = hit & live_row
                t_m = torch.where(hit, t, BIG)
                t_j = t_m.amin(dim=1)
                # argmin's first index on ties, as JAX's
                j = (t_m == t_j[:, None]).to(torch.uint8).argmax(dim=1)
                better = t_j < best_t
                onehot = kk == j[:, None]
                best_t = torch.where(better, t_j, best_t)
                best_p = torch.where(better, torch.where(
                    onehot, prim, 0).sum(dim=1, dtype=torch.int32), best_p)
                bu = torch.where(better, torch.where(onehot, u, 0.0).sum(
                    dim=1), bu)
                bv = torch.where(better, torch.where(onehot, v, 0.0).sum(
                    dim=1), bv)
                in_chain = ~is_empty & (link >= 0)
                cell_done = ~in_chain & (best_t <= t_exit + 1e-6)
                done2 = done | cell_done | (~in_chain & (t_next > t_o))
                extra = [best_t, best_p, bu, bv]
            t_cur2 = torch.where(in_chain | done2, t_cur, t_next)
            chain2 = torch.where(done2, -2, torch.where(in_chain,
                                                        link.long(), -2))
            state = [t_cur2, chain2] + extra
            done = done2
            it += 1
        live = torch.nonzero(~done)[:, 0]
        n_live = live.numel()
        if n_live == 0 or it >= g.max_steps or 2 * n_live <= done.shape[0]:
            for x, s in zip(outs, state[2:]):
                x[lanes] = s
            if n_live == 0 or it >= g.max_steps:
                break
            lanes = lanes[live]
            const = [c[live] for c in const]
            state = [s[live] for s in state]
            done = done[live]
    STEPS[mode] += it
    return outs


def _lanes(o: Vec3, maxt, active):
    """(maxt [N], detached; active [N])."""
    n = o.x.shape[0]
    maxt_v = torch.as_tensor(maxt, dtype=torch.float32,
                             device=o.x.device).detach().expand(n)
    act = (torch.ones(n, dtype=torch.bool, device=o.x.device)
           if active is None else active)
    return maxt_v, act


def intersect_grid(g: GridAccel, o: Vec3, d: Vec3, maxt, active=None):
    """Closest hit -> (t [N], prim [N] i32, uv Vec2, valid [N])."""
    maxt_v, act = _lanes(o, maxt, active)
    best_t, best_p, bu, bv = _march(g, o.detach(), d.detach(),
                                    torch.clamp(maxt_v, max=3e38), act,
                                    any_hit=False)
    valid = (best_p >= 0) & act
    return torch.where(valid, best_t, BIG), best_p, Vec2(bu, bv), valid


def occluded_grid(g: GridAccel, o: Vec3, d: Vec3, maxt, active=None):
    """Any hit within maxt -> bool [N]: the same march, a lane ending on
    its first hit."""
    maxt_v, act = _lanes(o, maxt, active)
    return _march(g, o.detach(), d.detach(), maxt_v * (1.0 - 1e-5), act,
                  any_hit=True)[0] & act
