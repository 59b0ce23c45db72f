"""Cell-major pair-serve intersector — counterpart of
``mitsuba3_tpu/ops/cellserve.py``.

1. PAIRGEN: each ray DDA-marches a coarse macro grid (res ~16) and emits
   its first P occupied-cell crossings as (cell, ray) pairs; overflow (more
   than P occupied crossings) records a resume distance for a follow-up
   round.
2. SORT the pairs by cell, so rays that want the same cell are contiguous.
3. SERVE (kernel K1, ``csrc/cellserve_serve.cu``): triangles are stored
   CSR-ordered by cell in [16, 128] row slabs; each 128-pair sub-block
   tests its pairs against its own contiguous row window and keeps the
   smallest hit distance.
4. REDUCE: results go back to pairgen order; a min over the P slots gives
   each ray's closest hit.

Eager-PyTorch differences from the JAX package, none of which changes a
result: pairs whose slot is unused are dropped before the sort (they hit
nothing the real pairs miss), and each straggler round runs on exactly the
unresolved rays (JAX runs fixed widths because XLA compiles per shape).
"""
from __future__ import annotations

import functools

import numpy as np
import torch

from ..core.struct import struct
from ..core.vec import Vec2, Vec3
from . import native

BIG = 3.4e38       # "no hit" distance
K = 128            # triangles per CSR row slab = pairs per serve sub-block
MINT = 1e-6
# cells of at least this many triangles get an aligned CSR range (JAX's
# MI3T_CELLS_PAD_MIN default; the port reads no environment for it)
PAD_MIN = 64
PLAIN_CHUNK = 512  # sub-blocks per step of serve_blocks_plain ([512,128,128])

# Kernel launches of `serve_blocks` by mode. Only the wrapper adds to these,
# and only where it launches the CUDA kernel; callers reset them to 0.
LAUNCHES = {"closest": 0, "anyhit": 0}


@struct
class CellServe:
    tris: torch.Tensor      # [NR, 16, K] f32 CSR row slabs (row 9 = prim id)
    start: torch.Tensor     # [C + 2] i32 CSR offsets (start[C]=start[C+1]=T)
    occ: torch.Tensor       # [C] bool cell occupancy
    lo: torch.Tensor        # [3] f32 grid origin
    inv_cell: torch.Tensor  # [3] f32 1 / cell size
    res: int = 0
    n_tris: int = 0
    pair_slots: int = 8
    max_steps: int = 0


def build(p0, e1, e2, res: int | None = None, pair_slots: int = 8, *,
          device, pad_min: int = PAD_MIN) -> CellServe:
    """Host-side build, identical to the JAX package's (NumPy) when
    `pad_min` is the JAX build's ``MI3T_CELLS_PAD_MIN``."""
    p0 = np.asarray(p0, np.float32)
    e1 = np.asarray(e1, np.float32)
    e2 = np.asarray(e2, np.float32)
    # drop degenerate (padding) triangles: they can never produce a hit
    area2 = np.linalg.norm(np.cross(e1, e2), axis=1)
    keep = area2 > 0.0
    prim_ids = np.nonzero(keep)[0].astype(np.int32)
    p0k, e1k, e2k = p0[keep], e1[keep], e2[keep]
    f = max(p0k.shape[0], 1)
    if p0k.shape[0] == 0:
        p0k = np.zeros((1, 3), np.float32)
        e1k = np.zeros((1, 3), np.float32)
        e2k = np.zeros((1, 3), np.float32)
        prim_ids = np.full(1, -1, np.int32)

    v1, v2 = p0k + e1k, p0k + e2k
    bbmin = np.minimum(np.minimum(p0k, v1), v2)
    bbmax = np.maximum(np.maximum(p0k, v1), v2)
    lo = bbmin.min(axis=0)
    hi = bbmax.max(axis=0)
    span = np.maximum(hi - lo, 1e-6)
    lo = lo - span * 1e-4
    hi = hi + span * 1e-4
    span = hi - lo
    if res is None:
        res = int(np.clip(round((f / 16.0) ** (1.0 / 3.0)), 8, 24))
    cell = span / res
    inv_cell = 1.0 / cell
    C = res ** 3

    clo = np.clip(((bbmin - lo) * inv_cell).astype(np.int64), 0, res - 1)
    chi = np.clip(((bbmax - lo) * inv_cell).astype(np.int64), 0, res - 1)
    counts = (chi - clo + 1).prod(axis=1)
    total = int(counts.sum())
    tri_ids = np.repeat(np.arange(len(p0k)), counts)
    seg = np.zeros(len(p0k) + 1, np.int64)
    np.cumsum(counts, out=seg[1:])
    within = np.arange(total) - seg[tri_ids]
    nx = (chi[:, 0] - clo[:, 0] + 1)[tri_ids]
    ny = (chi[:, 1] - clo[:, 1] + 1)[tri_ids]
    cx = clo[tri_ids, 0] + within % nx
    cy = clo[tri_ids, 1] + (within // nx) % ny
    cz = clo[tri_ids, 2] + within // (nx * ny)
    cell_ids = (cz * res + cy) * res + cx

    order = np.argsort(cell_ids, kind="stable")
    cell_sorted = cell_ids[order]
    tri_sorted = tri_ids[order]

    # cell-aligned CSR: cells with at least pad_min triangles get a
    # K-aligned start and a K-multiple length, so a sub-block whose pairs
    # sit inside one popular cell reads exactly that cell's rows. Small
    # cells stay packed. Gaps hold degenerate id=-1 slots (never hit).
    counts_c = np.bincount(cell_sorted, minlength=C).astype(np.int64)
    start64 = np.zeros(C + 2, np.int64)
    off = 0
    for c in np.nonzero(counts_c)[0]:
        start64[c] = off
        n_c = int(counts_c[c])
        if n_c >= pad_min:
            off = -(-off // K) * K
            start64[c] = off
            off += -(-n_c // K) * K
        else:
            off += n_c
    # empty cells point at the next occupied cell's start (ranges stay
    # monotone; window arithmetic spans gaps with degenerate slots)
    nz = counts_c > 0
    start64[:C][~nz] = -1
    run = off
    for c in range(C - 1, -1, -1):
        if start64[c] < 0:
            start64[c] = run
        else:
            run = start64[c]
    total_padded = off
    start64[C] = start64[C + 1] = total_padded
    start = start64.astype(np.int32)

    occ = np.zeros(C, bool)
    occ[np.unique(cell_sorted)] = True

    nr = -(-max(total_padded, 1) // K)
    old_first = np.zeros(C + 1, np.int64)
    np.cumsum(counts_c, out=old_first[1:])
    pos = (start64[cell_sorted]
           + (np.arange(total) - old_first[cell_sorted]))
    flat = np.zeros((10, nr * K), np.float32)
    flat[9, :] = -1.0
    flat[0:3, pos] = p0k[tri_sorted].T
    flat[3:6, pos] = e1k[tri_sorted].T
    flat[6:9, pos] = e2k[tri_sorted].T
    flat[9, pos] = prim_ids[tri_sorted].astype(np.float32)
    rows = np.zeros((nr, 16, K), np.float32)
    rows[:, 9, :] = -1.0
    rows[:, :10, :] = flat.reshape(10, nr, K).transpose(1, 0, 2)

    return CellServe(
        tris=torch.as_tensor(rows, device=device),
        start=torch.as_tensor(start, device=device),
        occ=torch.as_tensor(occ, device=device),
        lo=torch.as_tensor(np.asarray(lo, np.float32), device=device),
        inv_cell=torch.as_tensor(np.asarray(inv_cell, np.float32),
                                 device=device),
        res=int(res), n_tris=total, pair_slots=int(pair_slots),
        max_steps=3 * int(res) + 4)


# ---------------------------------------------------------------------------
# Pair generation: DDA over the macro grid
# ---------------------------------------------------------------------------

def _grid_ray(acc: CellServe, o: Vec3, d: Vec3):
    ogx = (o.x - acc.lo[0]) * acc.inv_cell[0]
    ogy = (o.y - acc.lo[1]) * acc.inv_cell[1]
    ogz = (o.z - acc.lo[2]) * acc.inv_cell[2]
    tiny = 1e-12

    def guard(c):
        return torch.where(c.abs() < tiny, tiny, c)

    dgx = guard(d.x * acc.inv_cell[0])
    dgy = guard(d.y * acc.inv_cell[1])
    dgz = guard(d.z * acc.inv_cell[2])
    return (ogx, ogy, ogz), (dgx, dgy, dgz)


def _clip(acc: CellServe, og, dg, maxt):
    res = acc.res
    ix, iy, iz = 1.0 / dg[0], 1.0 / dg[1], 1.0 / dg[2]
    t0x, t1x = (0.0 - og[0]) * ix, (res - og[0]) * ix
    t0y, t1y = (0.0 - og[1]) * iy, (res - og[1]) * iy
    t0z, t1z = (0.0 - og[2]) * iz, (res - og[2]) * iz
    t_in = torch.maximum(
        torch.maximum(torch.minimum(t0x, t1x), torch.minimum(t0y, t1y)),
        torch.clamp(torch.minimum(t0z, t1z), min=0.0))
    t_out = torch.minimum(
        torch.minimum(torch.maximum(t0x, t1x), torch.maximum(t0y, t1y)),
        torch.maximum(t0z, t1z))
    return t_in, torch.minimum(t_out, maxt), (ix, iy, iz)


def _occupied(acc: CellServe, cell):
    return acc.occ[cell.long()]


def _cell_coord(p, res: int):
    """floor(p) as int32 (truncation minus one below zero), clamped."""
    return torch.clamp(p.to(torch.int32) - (p < 0).to(torch.int32), 0,
                       res - 1)


def _pairgen(acc: CellServe, og, dg, inv, t_in, t_out, active, t_from):
    """March from max(t_in, t_from); emit up to P occupied-cell ids per
    lane (sentinel C when unused). Returns (slots [P, N] i32,
    resume_t [N], overflow [N] bool)."""
    n = t_in.shape[0]
    dev = t_in.device
    res, P, C = acc.res, acc.pair_slots, acc.res ** 3
    max_comp = torch.maximum(torch.maximum(dg[0].abs(), dg[1].abs()),
                             dg[2].abs())
    eps_t = 1e-4 / torch.clamp(max_comp, min=1e-12)
    t_start = torch.maximum(t_in, t_from)
    done = (t_start > t_out) | ~active

    slots = torch.full((P, n), C, dtype=torch.int32, device=dev)
    count = torch.zeros(n, dtype=torch.int32, device=dev)
    t_cur = t_start + eps_t
    resume = torch.full((n,), BIG, dtype=torch.float32, device=dev)
    ovf = torch.zeros(n, dtype=torch.bool, device=dev)
    for _ in range(acc.max_steps):
        if bool(done.all()):
            break
        cx = _cell_coord(og[0] + dg[0] * t_cur, res)
        cy = _cell_coord(og[1] + dg[1] * t_cur, res)
        cz = _cell_coord(og[2] + dg[2] * t_cur, res)
        cell = (cz * res + cy) * res + cx
        occ = _occupied(acc, cell) & ~done

        full = occ & (count >= P)
        emit = occ & ~full
        # slot `count` of each emitting lane takes the cell
        slot = torch.clamp(count, max=P - 1).long()[None]
        slots.scatter_(0, slot, torch.where(emit, cell,
                                            slots.gather(0, slot)[0])[None])
        count = count + emit.to(torch.int32)
        resume = torch.where(full & ~ovf, t_cur, resume)
        ovf = ovf | full

        nbx = torch.where(dg[0] > 0, cx + 1, cx).to(torch.float32)
        nby = torch.where(dg[1] > 0, cy + 1, cy).to(torch.float32)
        nbz = torch.where(dg[2] > 0, cz + 1, cz).to(torch.float32)
        t_exit = torch.minimum(torch.minimum((nbx - og[0]) * inv[0],
                                             (nby - og[1]) * inv[1]),
                               (nbz - og[2]) * inv[2])
        t_next = torch.maximum(t_exit, t_cur) + eps_t
        done = done | full | (t_next > t_out)
        t_cur = torch.where(done, t_cur, t_next)
    return slots, resume, ovf


# ---------------------------------------------------------------------------
# Serve: kernel K1 and its plain version
# ---------------------------------------------------------------------------

def _mt_rows(slab, ox, oy, oz, dx, dy, dz):
    """Möller-Trumbore of slabs [S, 16, K] against rays [S, K, 1]
    -> (t_m, u, v, ids), each [S, K pairs, K triangles]; t_m = BIG where
    there is no hit. The operation order matches the CUDA kernel's."""
    def c(i):
        return slab[:, i, None, :]

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
    ids = c(9).to(torch.int32)
    hit = (ok & (u >= 0.0) & (v >= 0.0) & (u + v <= 1.0) & (t > MINT)
           & (ids >= 0))
    return torch.where(hit, t, BIG), u, v, ids


def serve_blocks_plain(tris, rays, r0, nr, want_uv: bool):
    """Plain PyTorch version of K1, over the same per-sub-block windows:
    tris [NR, 16, K], rays [6, 128 * S], r0/nr [S] i32 -> (t, prim, u, v)
    [128 * S] each (prim/u/v None unless want_uv). Within a row the first
    column reaching the minimum wins; a later row only with a strictly
    smaller t. Runs PLAIN_CHUNK sub-blocks at a time to bound memory."""
    n_sub = r0.shape[0]
    n_rows = tris.shape[0]
    dev = rays.device
    rs = rays.reshape(6, n_sub, K)
    t_o = torch.full((n_sub, K), BIG, dtype=torch.float32, device=dev)
    p_o = torch.full((n_sub, K), -1, dtype=torch.int32, device=dev)
    u_o = torch.zeros((n_sub, K), dtype=torch.float32, device=dev)
    v_o = torch.zeros((n_sub, K), dtype=torch.float32, device=dev)
    cols = torch.arange(K, device=dev)
    for c0 in range(0, n_sub, PLAIN_CHUNK):
        c1 = min(c0 + PLAIN_CHUNK, n_sub)
        r0c, nrc = r0[c0:c1], nr[c0:c1]
        ray = [rs[i, c0:c1, :, None] for i in range(6)]
        bt, bp, bu, bv = (t_o[c0:c1], p_o[c0:c1], u_o[c0:c1], v_o[c0:c1])
        for k in range(int(nrc.max())):
            rows = torch.clamp(r0c + k, 0, n_rows - 1).long()
            t_m, u, v, ids = _mt_rows(tris[rows], *ray)
            tmin = t_m.amin(dim=2)
            better = (k < nrc)[:, None] & (tmin < bt)
            bt.copy_(torch.where(better, tmin, bt))
            if not want_uv:
                continue
            jc = torch.where(t_m == tmin[..., None], cols, K).amin(dim=2)
            jc = torch.clamp(jc, max=K - 1)[..., None]
            prim = ids.expand_as(t_m).gather(2, jc)[..., 0]
            bp.copy_(torch.where(better, prim, bp))
            bu.copy_(torch.where(better, u.gather(2, jc)[..., 0], bu))
            bv.copy_(torch.where(better, v.gather(2, jc)[..., 0], bv))
    if not want_uv:
        return t_o.reshape(-1), None, None, None
    return t_o.reshape(-1), p_o.reshape(-1), u_o.reshape(-1), v_o.reshape(-1)


def serve_blocks(tris, rays, r0, nr, want_uv: bool):
    """K1: serve every 128-pair sub-block over its CSR row window.

    tris [NR, 16, K] f32, rays [6, 128 * S] f32 (origin xyz, direction
    xyz), r0/nr [S] i32 -> (t, prim, u, v) [128 * S] (prim/u/v None unless
    want_uv). CPU tensors take the plain version; CUDA tensors launch the
    kernel of csrc/cellserve_serve.cu on the current stream."""
    dev = rays.device
    if native.on_cpu(rays, tris, r0, nr):
        return serve_blocks_plain(tris, rays, r0, nr, want_uv)
    if dev.type != "cuda":
        raise ValueError(f"serve_blocks: rays on {dev}; the kernel needs "
                         f"every tensor on one CUDA device")
    n_sub = r0.shape[0]
    np_pad = n_sub * K
    check = functools.partial(native.check, "serve_blocks")
    check("tris", tris, torch.float32, (tris.shape[0], 16, K), dev)
    check("rays", rays, torch.float32, (6, np_pad), dev)
    check("r0", r0, torch.int32, (n_sub,), dev)
    check("nr", nr, torch.int32, (n_sub,), dev)

    def empty(dtype):
        return torch.empty(np_pad, dtype=dtype, device=dev)

    t = empty(torch.float32)
    p, u, v = ((empty(torch.int32), empty(torch.float32),
                empty(torch.float32)) if want_uv else (None, None, None))
    if n_sub == 0:
        return t, p, u, v
    native.launch(
        "cellserve_serve", "ppppiqppppi", tris.data_ptr(), rays.data_ptr(),
        r0.data_ptr(), nr.data_ptr(), n_sub, np_pad, t.data_ptr(),
        p.data_ptr() if want_uv else None, u.data_ptr() if want_uv else None,
        v.data_ptr() if want_uv else None, int(want_uv), dev=dev)
    LAUNCHES["closest" if want_uv else "anyhit"] += 1
    return t, p, u, v


def sort_pairs(acc: CellServe, slots, o: Vec3, d: Vec3):
    """Sort the used (cell, ray) pairs of `slots` [P, N] by cell and cut
    them into 128-pair sub-blocks. Returns (pair [M] flat slot index
    i * N + ray in sorted order, rays [6, 128 * S] f32, r0 [S] i32,
    nr [S] i32): each sub-block's CSR row window covers the cells of its
    own pairs (JAX's per-sub-block windows)."""
    n = slots.shape[1]
    C = acc.res ** 3
    n_rows = acc.tris.shape[0]
    dev = slots.device
    cells = slots.reshape(-1)
    pair = torch.nonzero(cells < C).squeeze(1)
    cells_s, order = torch.sort(cells[pair], stable=True)
    pair = pair[order]
    m = pair.shape[0]
    np_pad = -(-m // K) * K
    lane = pair % n
    rays = torch.zeros((6, np_pad), dtype=torch.float32, device=dev)
    rays[5] = 1.0                      # padding pairs: o = 0, d = +z
    for i, comp in enumerate((o.x, o.y, o.z, d.x, d.y, d.z)):
        rays[i, :m] = comp[lane]
    cells_p = torch.full((np_pad,), C, dtype=torch.int32, device=dev)
    cells_p[:m] = cells_s
    cells_ss = cells_p.reshape(-1, K)
    # per-sub-block [first, last] used cells -> CSR row range; padding
    # pairs (cell C) sort to the tail
    s_first = cells_ss[:, 0]
    s_last = torch.where(cells_ss < C, cells_ss, -1).amax(dim=1)
    s_starts = acc.start[torch.minimum(s_first, s_last + 1).long()]
    s_ends = acc.start[(s_last + 1).long()]
    sub_lo = torch.where(s_last >= 0, s_starts // K, n_rows)
    sub_hi = torch.where(s_last >= 0, (s_ends + K - 1) // K, 0)
    r0 = torch.clamp(sub_lo, 0, n_rows - 1)
    nr = torch.minimum(torch.clamp(sub_hi - r0, min=0), n_rows - r0)
    return pair, rays, r0.to(torch.int32), nr.to(torch.int32)


def _serve(acc: CellServe, slots, o: Vec3, d: Vec3, want_uv: bool):
    """slots [P, N] -> per-pair (t, prim, u, v) in pairgen order ([P, N]
    each; t = BIG where no hit; prim/u/v None unless want_uv)."""
    P, n = slots.shape
    dev = slots.device
    pair, rays, r0, nr = sort_pairs(acc, slots, o, d)
    bt, bp, bu, bv = serve_blocks(acc.tris, rays, r0, nr, want_uv)
    m = pair.shape[0]
    t = torch.full((P * n,), BIG, dtype=torch.float32, device=dev)
    t[pair] = bt[:m]
    if not want_uv:
        return t.reshape(P, n), None, None, None
    p = torch.full((P * n,), -1, dtype=torch.int32, device=dev)
    u = torch.zeros((P * n,), dtype=torch.float32, device=dev)
    v = torch.zeros((P * n,), dtype=torch.float32, device=dev)
    p[pair] = bp[:m]
    u[pair] = bu[:m]
    v[pair] = bv[:m]
    return t.reshape(P, n), p.reshape(P, n), u.reshape(P, n), v.reshape(P, n)


# ---------------------------------------------------------------------------
# Queries
# ---------------------------------------------------------------------------

def _round(acc, og, dg, inv, t_in, t_out, o, d, maxt, closest, unres, bt,
           bp, bu, bv, t_from):
    """One pairgen + serve round. Returns the updated
    (unres, bt, bp, bu, bv, resume)."""
    slots, resume, ovf = _pairgen(acc, og, dg, inv, t_in, t_out, unres,
                                  t_from)
    st, sp, su, sv = _serve(acc, slots, o, d, want_uv=closest)
    tmin = st.amin(dim=0)
    better = unres & (tmin < bt)
    bt = torch.where(better, tmin, bt)
    if closest:
        # first slot reaching the minimum
        P = slots.shape[0]
        slot_ids = torch.arange(P, device=st.device)[:, None]
        j = torch.where(st == tmin, slot_ids, P).amin(dim=0)
        j = torch.clamp(j, max=P - 1)[None]
        bp = torch.where(better, sp.gather(0, j)[0], bp)
        bu = torch.where(better, su.gather(0, j)[0], bu)
        bv = torch.where(better, sv.gather(0, j)[0], bv)
    else:
        bp = torch.where(better & (tmin < BIG), 0, bp)
    # resolved when: no overflow, or a hit at/before the resume point
    unres2 = unres & ovf & (bt > resume)
    if not closest:
        unres2 = unres2 & ~(bt < maxt)
    return unres2, bt, bp, bu, bv, resume


def _trace(acc: CellServe, o: Vec3, d: Vec3, maxt, active, closest: bool):
    n = o.x.shape[0]
    dev = o.x.device
    og, dg = _grid_ray(acc, o, d)
    t_in, t_out, inv = _clip(acc, og, dg, maxt)

    bt = torch.full((n,), BIG, dtype=torch.float32, device=dev)
    bp = torch.full((n,), -1, dtype=torch.int32, device=dev)
    bu = torch.zeros(n, dtype=torch.float32, device=dev)
    bv = torch.zeros(n, dtype=torch.float32, device=dev)
    unres = active & (t_in <= t_out)
    t_from = torch.zeros(n, dtype=torch.float32, device=dev)

    # one round, then straggler rounds (rays with more than P occupied
    # crossings and no early hit) re-marched from their resume point, each
    # on exactly the unresolved rays, under the JAX package's round bound
    max_rounds = -(-(3 * acc.res + 4) // acc.pair_slots) + 1
    for _ in range(1 + max_rounds):
        idx = torch.nonzero(unres).squeeze(1)
        if idx.shape[0] == 0:
            break

        def sub(xs):
            return tuple(x[idx] for x in xs)

        un_s, bt_s, bp_s, bu_s, bv_s, rs_s = _round(
            acc, sub(og), sub(dg), sub(inv), t_in[idx], t_out[idx],
            Vec3(*sub((o.x, o.y, o.z))), Vec3(*sub((d.x, d.y, d.z))),
            maxt[idx], closest, unres[idx], bt[idx], bp[idx], bu[idx],
            bv[idx], t_from[idx])
        unres = torch.zeros_like(unres)
        unres[idx] = un_s
        bt[idx] = bt_s
        bp[idx] = bp_s
        bu[idx] = bu_s
        bv[idx] = bv_s
        t_from[idx] = rs_s

    valid = (bt < maxt) & active & ((bp >= 0) if closest else (bt < BIG))
    return bt, bp, bu, bv, valid


def _lanes(o: Vec3, maxt, active):
    n = o.x.shape[0]
    if active is None:
        active = torch.ones(n, dtype=torch.bool, device=o.x.device)
    maxt = torch.as_tensor(maxt, dtype=torch.float32,
                           device=o.x.device).expand(n)
    return maxt, active


def intersect_cells(acc: CellServe, o: Vec3, d: Vec3, maxt, active=None):
    """Closest hit -> (t [N], prim [N], uv Vec2, valid [N])."""
    maxt, active = _lanes(o, maxt, active)
    t, prim, u, v, valid = _trace(acc, o, d, maxt, active, closest=True)
    t = torch.where(valid, t, BIG)
    prim = torch.where(valid, prim, -1)
    return t, prim, Vec2(u, v), valid


def occluded_cells(acc: CellServe, o: Vec3, d: Vec3, maxt, active=None):
    """Any hit strictly inside (MINT, maxt) -> bool [N]. maxt is used as
    given: shadow epsilons are the caller's job."""
    maxt, active = _lanes(o, maxt, active)
    return _trace(acc, o, d, maxt, active, closest=False)[4]
