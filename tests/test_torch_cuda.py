"""Kernels K1 (``csrc/cellserve_serve.cu``), K2 and K3 (``csrc/
bvh_serve_cull.cu``, ``csrc/bvh_serve_serve.cu``), K4
(``csrc/bvh_tiled_mt.cu``) and the attic's K5-K8
(``csrc/bvh_pallas_traverse.cu``, K2's kernel with 8 keys,
``csrc/bvh_queue_serve.cu``, ``csrc/bvh2_serve.cu``) against their plain
PyTorch versions on the card, at test sizes, in each mode and topk; the
queries of each accel (and the small terrain render of each loader accel,
and a small interior lit by a point light) on the card against the CPU;
PRB on the card: the Cornell box's gradients against the CPU's, and K1
launched in the terrain replay as often as in the primal; the glossy and
every-BSDF Cornell boxes' renders and PRB gradients against the CPU's;
the optimizers, LargeSteps and one ``update()`` rebuild on the card
against the CPU; a render per sampler type from an XML file, and
``load_file``'s default device; texture lookups (every wrap and filter,
the mip levels), the textured Cornell's render and the texture and
environment gradients of it and of the small textured terrain;
participating media: the foggy interior through K1 on the card against
the CPU, the smoke's 256^3 cell table built once per render, and the fog
Cornell's prbvolpath gradients against the CPU's; the light tracer's
atomic splat against the CPU, aov's RGB equal to path's, direct through
K1 in both modes, and a sphere-lit Cornell's PRB step; a hair ball on
tube curves launching K1 in both modes, the measured materials Cornell
against the CPU, a principled PRB step and a user's BSDF (half_diffuse)
on the card; the instanced field's prototype query through K1 against its
plain version, and instanced, analytic and SDF shapes rendered on the card
against the CPU; the bvh_xla, grid and hybrid queries and the small
terrain through them and through the dense test, and the spectral
Cornell, on the card against the CPU; in the spectral variant, the small
terrain through K1 and the spectral Cornell's PRB gradients on the card
against the CPU. Run on a machine with a CUDA device::

    python -m pytest -m cuda tests/test_torch_cuda.py -q

Without a device every test skips (decided in the fixture, not at
import)."""
import numpy as np
import pytest
import torch

import chip_smoke
import mitsuba3_tpu_torch as mt
from mitsuba3_tpu_torch.core.vec import Vec3
from mitsuba3_tpu_torch.ops import bvh_serve as bs
from mitsuba3_tpu_torch.ops import bvh_tiled as bt
from mitsuba3_tpu_torch.ops import cellserve as cs
from mitsuba3_tpu_torch.ops.attic import bvh2 as b2
from mitsuba3_tpu_torch.ops.attic import bvh_pallas as bp
from mitsuba3_tpu_torch.ops.attic import bvh_queue as bq

torch.set_num_threads(1)
pytestmark = pytest.mark.cuda


@pytest.fixture
def np_rng():
    return np.random.default_rng(seed=12345)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _soup(np_rng, n_tri=2000, n_ray=4096):
    p0 = np_rng.uniform(-2, 2, (n_tri, 3)).astype(np.float32)
    e1 = np_rng.normal(0, 0.3, (n_tri, 3)).astype(np.float32)
    e2 = np_rng.normal(0, 0.3, (n_tri, 3)).astype(np.float32)
    o = np_rng.uniform(-4, 4, (n_ray, 3)).astype(np.float32)
    d = np_rng.normal(size=(n_ray, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    return (p0, e1, e2), o, d


def _vec(a, dev):
    t = torch.as_tensor(a, device=dev)
    return Vec3(t[:, 0].contiguous(), t[:, 1].contiguous(),
                t[:, 2].contiguous())


@pytest.mark.parametrize("want_uv", [True, False], ids=["closest", "anyhit"])
def test_kernel_matches_plain(cuda, np_rng, want_uv):
    tris, o, d = _soup(np_rng)
    acc = cs.build(*tris, device=cuda)
    ov, dv = _vec(o, cuda), _vec(d, cuda)
    og, dg = cs._grid_ray(acc, ov, dv)
    t_in, t_out, inv = cs._clip(acc, og, dg,
                                torch.full((o.shape[0],), 1e30, device=cuda))
    slots, _, _ = cs._pairgen(acc, og, dg, inv, t_in, t_out, t_in <= t_out,
                              torch.zeros_like(t_in))
    _, rays, r0, nr = cs.sort_pairs(acc, slots, ov, dv)
    before = dict(cs.LAUNCHES)
    kt, kp, ku, kv = cs.serve_blocks(acc.tris, rays, r0, nr, want_uv)
    torch.cuda.synchronize()
    mode = "closest" if want_uv else "anyhit"
    assert cs.LAUNCHES[mode] == before[mode] + 1
    pt, pp, pu, pv = cs.serve_blocks_plain(acc.tris, rays, r0, nr, want_uv)
    assert torch.equal(kt >= cs.BIG, pt >= cs.BIG)
    hit = pt < cs.BIG
    assert hit.any()
    assert torch.allclose(kt[hit], pt[hit], rtol=1e-5, atol=0)
    if want_uv:
        same = kp[hit] == pp[hit]
        assert same.float().mean() >= 0.999
        assert torch.all(kt[hit][~same] <= pt[hit][~same] + 1e-4)
        assert torch.allclose(ku[hit][same], pu[hit][same], atol=1e-5)
        assert torch.allclose(kv[hit][same], pv[hit][same], atol=1e-5)
    else:
        assert kp is None and ku is None


def test_queries_on_card_match_cpu(cuda, np_rng):
    tris, o, d = _soup(np_rng)
    results = []
    for dev in (cuda, torch.device("cpu")):
        acc = cs.build(*tris, device=dev)
        t, prim, _, valid = cs.intersect_cells(acc, _vec(o, dev),
                                               _vec(d, dev), 1e30)
        occ = cs.occluded_cells(acc, _vec(o, dev), _vec(d, dev), 2.0)
        results.append([x.cpu() for x in (t, prim, valid, occ)])
    (tg, pg, vg, og), (tc, pc, vc, oc) = results
    assert torch.equal(vg, vc) and torch.equal(og, oc)
    assert (pg[vc] == pc[vc]).float().mean() > 0.999
    assert torch.allclose(tg[vc], tc[vc], rtol=1e-5)


def test_render_on_card_matches_cpu(cuda):
    d = chip_smoke.small_terrain_dict(mt.ScalarTransform4f)
    cs.LAUNCHES.update(closest=0, anyhit=0)
    img_g = mt.render(mt.load_dict(d, device=cuda), seed=5, spp=4)
    assert cs.LAUNCHES["closest"] > 0 and cs.LAUNCHES["anyhit"] > 0
    img_c = mt.render(mt.load_dict(d, device="cpu"), seed=5, spp=4)
    img_g = img_g.cpu().numpy()
    img_c = img_c.numpy()
    assert np.isfinite(img_g).all()
    assert np.isclose(img_g, img_c, rtol=1e-3, atol=1e-3).mean() > 0.995
    assert np.allclose(img_g.mean(), img_c.mean(), rtol=1e-3)


# ---------------------------------------------------------------------------
# K2, K3 (bvh_serve) and K4 (bvh_tiled) against their plain versions
# ---------------------------------------------------------------------------

def _serve_round(acc, o, d, maxt):
    """The first cull of a bvh_serve query and its leaf sort: (f, i, best,
    leaf_all)."""
    f, i = bs.initial_state(o, d, maxt)
    best = bs.cull_plain(acc, f, i[bs.LK])
    live = (best[0] != bs.NONE) & (i[bs.RID] >= 0)
    f, i, leaf_all, _, _ = bs.sort_requests(acc, f, i, best, live)
    return f, i, best, leaf_all


@pytest.mark.parametrize("topk", [1, 2])
def test_cull_kernel_matches_plain(cuda, np_rng, topk):
    tris, o, d = _soup(np_rng, n_ray=8192)
    acc = bs.build(*tris, leaf_size=8, topk=topk, device=cuda)
    assert acc.m_pad // bs.LC >= 2
    f, i = bs.initial_state(_vec(o, cuda), _vec(d, cuda),
                            torch.full((o.shape[0],), 1e30, device=cuda))
    # a nonzero cursor: half the rays have visited their nearest leaf
    first = bs.cull_plain(acc, f, i[bs.LK])[0]
    lk = torch.where(torch.arange(first.shape[0], device=cuda) % 2 == 0,
                     torch.where(first == bs.NONE, 0, first), 0)
    lk = lk.to(torch.int32).contiguous()
    before = bs.LAUNCHES["cull"]
    got = bs.cull(acc, f, lk)
    torch.cuda.synchronize()
    assert bs.LAUNCHES["cull"] == before + 1
    want = bs.cull_plain(acc, f, lk)
    assert torch.equal(got, want)
    assert (want[0] != bs.NONE).any()


@pytest.mark.parametrize("topk", [1, 2])
def test_serve_kernel_matches_plain(cuda, np_rng, topk):
    tris, o, d = _soup(np_rng, n_ray=16384)
    acc = bs.build(*tris, topk=topk, device=cuda)
    f, _, _, leaf_all = _serve_round(
        acc, _vec(o, cuda), _vec(d, cuda),
        torch.full((o.shape[0],), 1e30, device=cuda))
    blk = bs.block_ids(acc, leaf_all)
    before = bs.LAUNCHES["serve"]
    kt, kp, ku, kv, ks = bs.serve_blocks(acc, blk, f, leaf_all)
    torch.cuda.synchronize()
    assert bs.LAUNCHES["serve"] == before + 1
    pt, pp, pu, pv, ps = bs.serve_blocks_plain(acc, blk, f, leaf_all)
    assert torch.equal(ks, ps) and (ps != 0).any()
    assert torch.equal(kt >= bs.BIG, pt >= bs.BIG)
    hit = pt < bs.BIG
    assert hit.any()
    assert torch.allclose(kt[hit], pt[hit], rtol=1e-5, atol=0)
    same = kp[hit] == pp[hit]
    assert same.float().mean() >= 0.999
    assert torch.all(kt[hit][~same] <= pt[hit][~same] + 1e-4)
    assert torch.allclose(ku[hit][same], pu[hit][same], atol=1e-5)
    assert torch.allclose(kv[hit][same], pv[hit][same], atol=1e-5)


def _tiled_round(acc, o, d, maxt):
    """The first 16-slot round of a bvh_tiled query: run_round's inputs."""
    (ox, oy, oz, dx, dy, dz, mt_s), _ = bt._pack_sorted(acc, o, d, maxt)
    ids_s, ents_s = bt._sort_leaf_lists(
        bt._tile_leaf_lists(acc, ox, oy, oz, dx, dy, dz, mt_s))
    n = mt_s.shape[0]
    return (ids_s[:, :bt.LB_USE].contiguous(),
            ents_s[:, :bt.LB_USE].contiguous(), acc.tris,
            torch.stack([ox, oy, oz]), torch.stack([dx, dy, dz]), mt_s,
            torch.full((n,), -1, dtype=torch.int32, device=mt_s.device),
            torch.zeros_like(mt_s), torch.zeros_like(mt_s))


@pytest.mark.parametrize("closest", [True, False], ids=["closest", "anyhit"])
def test_tiled_kernel_matches_plain(cuda, np_rng, closest):
    tris, o, d = _soup(np_rng, n_ray=8192)
    acc = bt.build(*tris, device=cuda)
    args = _tiled_round(acc, _vec(o, cuda), _vec(d, cuda),
                        torch.full((o.shape[0],), 3.0, device=cuda))
    mode = "closest" if closest else "anyhit"
    before = bt.LAUNCHES[mode]
    kt, kp, ku, kv = bt.run_round(*args, closest)
    torch.cuda.synchronize()
    assert bt.LAUNCHES[mode] == before + 1
    pt, pp, pu, pv = bt.run_round_plain(*args, closest)
    hit = pp >= 0
    assert hit.any()
    assert torch.equal(kp >= 0, hit)
    if closest:
        assert torch.allclose(kt, pt, rtol=1e-5, atol=0)
        same = kp[hit] == pp[hit]
        assert same.float().mean() >= 0.999
        assert torch.allclose(ku[hit][same], pu[hit][same], atol=1e-5)
        assert torch.allclose(kv[hit][same], pv[hit][same], atol=1e-5)
    else:
        assert torch.equal(kt, pt) and torch.equal(kp, pp)


# ---------------------------------------------------------------------------
# K1 and K4 at the edges of their designs, equal to their plain versions
# (t bit-equal, prim, u and v equal)
# ---------------------------------------------------------------------------

# last real column of each edge slab: the bounds of the 32-column groups
# (K4 any-hit's lane groups, K1's ballots and 4-warp column split); the
# last slab has empty slots (id -1, zero edges) between its real ones
EDGE_LASTS = (0, 31, 32, 33, 127, 127)


def _edge_slabs(np_rng, lasts=EDGE_LASTS):
    """[len(lasts), 16, 128] slabs of random triangles over the rays of
    _edge_rays, real in columns 0..last (unique prim ids), padding after;
    the last real triangle is large and nearest."""
    tris = np.zeros((len(lasts), 16, 128), np.float32)
    tris[:, 9] = -1.0
    for s, last in enumerate(lasts):
        cols = np.arange(last + 1)
        if s == len(lasts) - 1:
            cols = cols[(cols % 5 != 2) | (cols == last)]
        n = cols.size
        p0 = np_rng.uniform(-1.5, 1.5, (n, 3))
        p0[:, 2] = np_rng.uniform(0.5, 3.0, n)
        slab = tris[s]
        slab[0:3, cols] = p0.T
        slab[3:9, cols] = np_rng.normal(0, 0.8, (6, n))
        slab[9, cols] = 1000 * s + cols
        # large first and last triangles, the last one nearest: a column
        # cut one short or one long shows in t
        slab[3:9, [0, last]] *= 3.0
        slab[2, last] = 0.3
    return tris


def _edge_rays(np_rng, n):
    """o [3, n] at z = -1 under the slabs, d [3, n] about +z."""
    o = np.stack([np_rng.uniform(-1.5, 1.5, n), np_rng.uniform(-1.5, 1.5, n),
                  np.full(n, -1.0)])
    d = np.stack([np_rng.normal(0, 0.15, n), np_rng.normal(0, 0.15, n),
                  np.ones(n)])
    return o.astype(np.float32), (d / np.linalg.norm(d, axis=0)).astype(
        np.float32)


def _assert_equal(got, want, names="t prim u v"):
    for name, g, w in zip(names.split(), got, want):
        assert torch.equal(g, w), name


@pytest.mark.parametrize("want_uv", [True, False], ids=["closest", "anyhit"])
def test_serve_kernel_edges_equal_plain(cuda, np_rng, want_uv):
    """K1 over windows of the edge slabs, one row or several, two random
    full rows, and an empty window (nr 0)."""
    tris = np.concatenate([_edge_slabs(np_rng),
                           _edge_slabs(np_rng, (127, 127))])
    tris[6:, 9] = np.where(tris[6:, 9] >= 0, tris[6:, 9] + 9000, -1.0)
    windows = [(r, 1) for r in range(6)] + [(0, 6), (2, 3), (6, 2), (3, 0)]
    r0, nr = (torch.tensor(w, dtype=torch.int32, device=cuda)
              for w in zip(*windows))
    o, d = _edge_rays(np_rng, cs.K * len(windows))
    rays = torch.as_tensor(np.concatenate([o, d]), device=cuda)
    tris = torch.as_tensor(tris, device=cuda)
    mode = "closest" if want_uv else "anyhit"
    before = cs.LAUNCHES[mode]
    got = cs.serve_blocks(tris, rays, r0, nr, want_uv)
    torch.cuda.synchronize()
    assert cs.LAUNCHES[mode] == before + 1
    want = cs.serve_blocks_plain(tris, rays, r0, nr, want_uv)
    _assert_equal(got, want, "t prim u v" if want_uv else "t")
    hit = (want[0] < cs.BIG).reshape(len(windows), cs.K)
    assert hit[:-1].any() and not hit[-1].any()


def test_serve_kernel_tie_slab(cuda):
    """tests/test_torch_cellserve.py's tie slab on the card: real columns
    2, 7 and 9 in row 0, 0 and 5 in row 1; the first row, then the first
    column, wins among equal ts."""
    tri = ([-1.0, -1.0, 2.0], [3.0, 0.0, 0.0], [0.0, 3.0, 0.0])
    far = ([-1.0, -1.0, 5.0], [3.0, 0.0, 0.0], [0.0, 3.0, 0.0])
    slab = np.zeros((2, 16, cs.K), np.float32)
    slab[:, 9] = -1.0
    for r, row in enumerate([{9: (*far, 1), 7: (*tri, 11), 2: (*tri, 12)},
                             {0: (*tri, 13), 5: (*far, 14)}]):
        for col, (p0, e1, e2, pid) in row.items():
            slab[r, 0:3, col], slab[r, 3:6, col] = p0, e1
            slab[r, 6:9, col], slab[r, 9, col] = e2, pid
    tris = torch.as_tensor(slab, device=cuda)
    rays = torch.zeros((6, 3 * cs.K), device=cuda)
    rays[5] = 1.0                              # every pair: o = 0, d = +z
    r0 = torch.zeros(3, dtype=torch.int32, device=cuda)
    nr = torch.tensor([2, 1, 0], dtype=torch.int32, device=cuda)
    for want_uv in (True, False):
        got = cs.serve_blocks(tris, rays, r0, nr, want_uv)
        want = cs.serve_blocks_plain(tris, rays, r0, nr, want_uv)
        _assert_equal(got, want, "t prim u v" if want_uv else "t")
    t, p, u = (x.reshape(3, cs.K) for x in
               cs.serve_blocks(tris, rays, r0, nr, True)[:3])
    assert (t[:2] == 2.0).all() and (p[:2] == 12).all()
    assert (t[2] == cs.BIG).all() and (p[2] == -1).all() and (u[2] == 0).all()


def _edge_round(np_rng, dev, closest):
    """run_round's arguments of 3 tiles over the edge slabs, the last tile
    with 700 live rays and padding (t -1) after them. Tile 2 takes the
    full slab 4 first, which occludes most of its rays in slot 0 in
    any-hit mode. Every 9th ray is inactive
    (t -1); closest: every 10th has a previous hit at t 1.2; any-hit: every
    4th has maxt 0.6, short of most triangles."""
    tile, n_tiles = bt.TILE, 3
    slabs = _edge_slabs(np_rng)
    slots = ([0, 1, 2, 3, 4, 5], [5, -1, 4, 3, 2, 1, 0], [4, 0, 5, -1, 1])
    leaf_ids = np.full((n_tiles, bt.LB_USE), -1, np.int32)
    for i, s in enumerate(slots):
        leaf_ids[i, :len(s)] = s
    entries = np.where(leaf_ids >= 0, 0.0, bt.BIG).astype(np.float32)
    o, d = _edge_rays(np_rng, n_tiles * tile)
    k = np.arange(n_tiles * tile)
    t = np.full(n_tiles * tile, 3e38, np.float32)
    prim = np.full(n_tiles * tile, -1, np.int32)
    u = np.zeros(n_tiles * tile, np.float32)
    if closest:
        t[k % 10 == 0], prim[k % 10 == 0], u[k % 10 == 0] = 1.2, 77, 0.1
    else:
        t[k % 4 == 0] = 0.6
    t[k % 9 == 0] = -1.0
    t[2 * tile + 700:], o[:, 2 * tile + 700:] = -1.0, 0.0
    return tuple(torch.as_tensor(a, device=dev) for a in (
        leaf_ids, entries, slabs, o, d, t, prim, u, u * 0.5))


@pytest.mark.parametrize("case", ["edges", "ties"])
@pytest.mark.parametrize("closest", [True, False], ids=["closest", "anyhit"])
def test_tiled_kernel_edges_equal_plain(cuda, np_rng, closest, case):
    """K4 on the edge slabs (a last tile of 700 rays; inactive, occluded and
    unoccluded rays in one tile) and on k4_tie_round's duplicate triangles
    (equal t inside a leaf: the largest id wins; across slots: the later
    one wins; a skipped prefetch candidate)."""
    from test_torch_bvh import k4_tie_round
    if case == "edges":
        args = _edge_round(np_rng, cuda, closest)
    else:
        args = tuple(torch.as_tensor(a, device=cuda) for a in k4_tie_round())
    mode = "closest" if closest else "anyhit"
    before = bt.LAUNCHES[mode]
    got = bt.run_round(*args, closest)
    torch.cuda.synchronize()
    assert bt.LAUNCHES[mode] == before + 1
    want = bt.run_round_plain(*args, closest)
    _assert_equal(got, want, "t prim u v" if closest else "t prim")
    t_in, prim = args[5], want[1]
    if closest:
        assert (prim[t_in >= 0] != args[6][t_in >= 0]).float().mean() > 0.25
    else:
        # a tile with inactive, occluded and unoccluded rays
        last = slice(2 * bt.TILE, 3 * bt.TILE)
        assert (t_in[last] < 0).any() and (prim[last] == 1).any()
        assert ((t_in[last] >= 0) & (prim[last] == -1)).any()


# ---------------------------------------------------------------------------
# K2 (and K6) and K3 at the edges of their designs, bit-equal to their plain
# versions
# ---------------------------------------------------------------------------

def _cull_edge_case(np_rng, dev, topk):
    """(accel, rays f, cursors lk) of 8 blocks of 512 rays over 8-triangle
    leaves, whose last chunk is partial: block 1's cursors are all NONE,
    block 2's rays have tb -1 (both whole inert CTAs); block 3 has half of
    each warp's cursors NONE; in block 4 every other ray has cursor NONE
    though it would enter chunks; the other blocks have nonzero cursors
    (the nearest leaf visited) on every other ray."""
    tris, o, d = _soup(np_rng, n_ray=8 * bs.RCHUNK)
    acc = bs.build(*tris, leaf_size=8, topk=min(topk, bs.MAX_TOPK),
                   device=dev)
    assert acc.m_pad // bs.LC >= 2 and acc.n_leaves % bs.LC != 0
    f, i = bs.initial_state(_vec(o, dev), _vec(d, dev),
                            torch.full((o.shape[0],), 1e30, device=dev))
    blk = torch.arange(f.shape[1], device=dev) // bs.RCHUNK
    first = bs.cull_plain(acc, f, i[bs.LK])[0]
    lk = torch.where(torch.arange(f.shape[1], device=dev) % 2 == 0,
                     torch.where(first == bs.NONE, 0, first), 0)
    lane = torch.arange(f.shape[1], device=dev) % 32
    none = ((blk == 1) | ((blk == 3) & (lane < 16))
            | ((blk == 4) & (lane % 2 == 1)))
    assert bool((first[(blk == 4) & (lane % 2 == 1)] != bs.NONE).any())
    lk = torch.where(none, bs.NONE, lk).to(torch.int32).contiguous()
    f[bs.TB, blk == 2] = -1.0
    return acc, f, lk


@pytest.mark.parametrize("topk", [1, 2, 8])
def test_cull_kernel_edges_equal_plain(cuda, np_rng, topk):
    """K2 (topk 1, 2) and K6 (topk 8): keys bit-equal with whole inert
    CTAs, half-inert warps, NONE cursors on rays that would enter a chunk
    and a partial last chunk."""
    acc, f, lk = _cull_edge_case(np_rng, cuda, topk)
    if topk == bq.KQ:
        kernel, plain, counter = bq.cull_topk, bq.cull_topk_plain, bq.LAUNCHES
    else:
        kernel, plain, counter = bs.cull, bs.cull_plain, bs.LAUNCHES
    before = counter["cull"]
    got = kernel(acc, f, lk)
    torch.cuda.synchronize()
    assert counter["cull"] == before + 1
    want = plain(acc, f, lk)
    assert torch.equal(got, want)
    blk = torch.arange(f.shape[1], device=cuda) // bs.RCHUNK
    assert bool((want[:, (blk == 1) | (blk == 2)] == bs.NONE).all())
    assert bool((want[0, blk >= 3] != bs.NONE).any())


def _serve_edge_case(np_rng, dev, topk):
    """(accel, blk_ids, rays, leaf) of 6 blocks over 8 slabs: the edge
    slabs 0-5 (last real column 0, 31, 32, 33, 127, 127 with gaps), slab 6
    = slab 4's triangles under other ids, slab 7 = slab 5 with one large
    nearest triangle in columns 3 and 40, the latter under a larger id
    (slab 0's one real triangle is that large one too). Block 0 is inert;
    block 1 has first = last = slab 0; block 2 wants
    slabs 1 and 3, and slab 5, which it is not served; block 3 wants
    slab 7 (an equal-t tie in a slab); block 4 wants slab 4 at rank 0 and,
    with topk 2, slab 6 at rank 1 (equal t across two slabs); block 5
    wants slabs 2 and 6 at rank 0 and slabs 6 and 2 at rank 1. Every 7th
    ray has tb 1.0."""
    big = np.array([-3.0, -3.0, 0.2, 8.0, 0.0, 0.0, 0.0, 8.0, 0.0],
                   np.float32)         # nearer than every edge triangle
    slabs = _edge_slabs(np_rng)
    slabs[0, :9, 0] = big
    tie = slabs[4].copy()
    tie[9] = np.where(tie[9] >= 0, tie[9] + 500, -1.0)
    dup = slabs[5].copy()
    assert dup[9, 3] >= 0 and dup[9, 40] >= 0
    dup[:9, 3] = dup[:9, 40] = big
    dup[9, 40] = 9999.0
    tris = np.concatenate([slabs, tie[None], dup[None]])
    m, m6, nb = tris.shape[0], bs.LC, 6
    npad = nb * bs.BLK
    leaf = np.full((topk, nb, bs.BLK), m6, np.int32)
    leaf[0, 1] = 0
    leaf[0, 2, :40], leaf[0, 2, 40:80], leaf[0, 2, 80:] = 1, 5, 3
    leaf[0, 3] = 7
    leaf[0, 4] = 4
    leaf[0, 5, :64], leaf[0, 5, 64:] = 2, 6
    if topk == 2:
        leaf[1, 4] = 6
        leaf[1, 5, :64], leaf[1, 5, 64:] = 6, 2
    o, d = _edge_rays(np_rng, npad)
    tb = np.where(np.arange(npad) % 7 == 0, 1.0, 1e30).astype(np.float32)
    rays = torch.as_tensor(np.concatenate([o, d, tb[None]]), device=dev)
    z = torch.zeros((8, m6), device=dev)
    acc = bs.BVHServe(tris=torch.as_tensor(tris, device=dev), bounds=z,
                      sup=z[:, :8].contiguous(), n_leaves=m, m_pad=m6,
                      topk=topk)
    leaf = torch.as_tensor(leaf.reshape(topk, npad), device=dev)
    return acc, bs.block_ids(acc, leaf), rays, leaf


@pytest.mark.parametrize("topk", [1, 2])
def test_serve_blocks_kernel_edges_equal_plain(cuda, np_rng, topk):
    """K3: t, prim, u, v and srv bit-equal on inert blocks, first = last
    leaf, slabs padded after column 0, 31, 32 or 33, slabs with gaps, a
    wanted slab that is not served, and equal-t ties in a slab and across
    two slabs."""
    acc, blk, rays, leaf = _serve_edge_case(np_rng, cuda, topk)
    before = bs.LAUNCHES["serve"]
    got = bs.serve_blocks(acc, blk, rays, leaf)
    torch.cuda.synchronize()
    assert bs.LAUNCHES["serve"] == before + 1
    want = bs.serve_blocks_plain(acc, blk, rays, leaf)
    _assert_equal(got, want, "t prim u v srv")
    t, p, _, _, srv = (x.reshape(-1, bs.BLK) for x in want)
    assert (t[0] == bs.BIG).all() and (p[0] == -1).all() and (srv[0] == 0).all()
    assert (srv[2, 40:80] == 0).all() and (srv[2, :40] == 1).all()
    assert ((p[1] == 0) | (t[1] > 1.0)).all() and (p[1] == 0).sum() > 64
    assert (p[3] == 9999).sum() > 64 and not (p[3] == 5003).any()
    if topk == 2:
        hit = p[4] >= 0
        assert hit.any() and (p[4][hit] < 4500).all() and (srv[4] == 3).all()


@pytest.mark.parametrize("accel", ["serve", "tiled"])
def test_accel_queries_on_card_match_cpu(cuda, np_rng, accel):
    tris, o, d = _soup(np_rng, n_ray=16384)
    mod = bs if accel == "serve" else bt
    results = []
    for dev in (cuda, torch.device("cpu")):
        acc = mod.build(*tris, device=dev)
        t, prim, _, valid = mod.intersect_bvh(acc, _vec(o, dev),
                                              _vec(d, dev), 1e30)
        occ = mod.occluded_bvh(acc, _vec(o, dev), _vec(d, dev), 2.0)
        results.append([x.cpu() for x in (t, prim, valid, occ)])
    (tg, pg, vg, og), (tc, pc, vc, oc) = results
    assert torch.equal(vg, vc) and torch.equal(og, oc)
    assert (pg[vc] == pc[vc]).float().mean() > 0.999
    assert torch.allclose(tg[vc], tc[vc], rtol=1e-5)


@pytest.mark.parametrize("accel", ["serve", "tiled"])
def test_accel_render_on_card_matches_cpu(cuda, monkeypatch, accel):
    """The serve render is 48^2 so that its 9,216 primary rays go above
    the gather-serve width and reach K3."""
    monkeypatch.setenv("MI3T_ACCEL", accel)
    d = chip_smoke.small_terrain_dict(mt.ScalarTransform4f,
                                      width=48 if accel == "serve" else 16)
    counters = bs.LAUNCHES if accel == "serve" else bt.LAUNCHES
    for k in counters:
        counters[k] = 0
    img_g = mt.render(mt.load_dict(d, device=cuda), seed=5, spp=4)
    assert all(v > 0 for v in counters.values()), counters
    img_c = mt.render(mt.load_dict(d, device="cpu"), seed=5, spp=4)
    img_g = img_g.cpu().numpy()
    img_c = img_c.numpy()
    assert np.isfinite(img_g).all()
    assert np.isclose(img_g, img_c, rtol=1e-3, atol=1e-3).mean() > 0.995
    assert np.allclose(img_g.mean(), img_c.mean(), rtol=1e-3)


def _new_accel_queries(accel, tris, o, d, dev):
    """(t, prim, valid, occluded) of `accel` ("xla", "grid", or "hybrid":
    the grid's closest hits, bvh_tiled's any-hit) built on `dev`."""
    from mitsuba3_tpu_torch.ops import bvh_xla, grid
    from mitsuba3_tpu_torch.render.scene import ACCEL_QUERIES
    closest = (bvh_xla if accel == "xla" else grid).build(*tris, device=dev)
    anyhit = bt.build(*tris, device=dev) if accel == "hybrid" else closest
    t, prim, _, valid = ACCEL_QUERIES[type(closest)][0](
        closest, _vec(o, dev), _vec(d, dev), 1e30)
    occ = ACCEL_QUERIES[type(anyhit)][1](anyhit, _vec(o, dev), _vec(d, dev),
                                         2.0)
    return [x.cpu() for x in (t, prim, valid, occ)]


@pytest.mark.parametrize("accel", ["xla", "grid", "hybrid"])
def test_new_accel_queries_on_card_match_cpu(cuda, np_rng, accel):
    tris, o, d = _soup(np_rng, n_ray=16384)
    before = bt.LAUNCHES["anyhit"]
    (tg, pg, vg, og), (tc, pc, vc, oc) = (
        _new_accel_queries(accel, tris, o, d, dev)
        for dev in (cuda, torch.device("cpu")))
    assert (bt.LAUNCHES["anyhit"] > before) == (accel == "hybrid")
    assert torch.equal(vg, vc) and torch.equal(og, oc)
    assert (pg[vc] == pc[vc]).float().mean() > 0.999
    assert torch.allclose(tg[vc], tc[vc], rtol=1e-5)


@pytest.mark.parametrize("accel", ["xla", "grid", "hybrid", "none"])
def test_new_accel_render_on_card_matches_cpu(cuda, accel):
    """The small terrain through MI3T_ACCEL=xla, grid and none and a
    hand-made HybridAccel (chip_smoke._load_accel), card against CPU."""
    d = chip_smoke.small_terrain_dict(mt.ScalarTransform4f, width=16)
    img_g, img_c = (
        mt.render(chip_smoke._load_accel(mt, d, accel, dev)[0], seed=5,
                  spp=4).cpu().numpy() for dev in (cuda, "cpu"))
    assert np.isfinite(img_g).all()
    assert np.isclose(img_g, img_c, rtol=1e-3, atol=1e-3).mean() > 0.995
    assert np.allclose(img_g.mean(), img_c.mean(), rtol=1e-3)


def test_spectral_cornell_on_card_matches_cpu(cuda):
    d = chip_smoke.spectral_cornell_dict(mt, 16, 16, 4)
    img_g, img_c = (mt.render(mt.load_dict(d, device=dev), seed=5,
                              spp=16).cpu().numpy() for dev in (cuda, "cpu"))
    assert np.isclose(img_g, img_c, rtol=1e-3, atol=1e-3).mean() > 0.995


def test_spectral_small_terrain_k1_on_card_matches_cpu(cuda, monkeypatch):
    """The small terrain in the spectral variant through cellserve: K1
    launches on the card in both modes, and the image agrees with the
    CPU's (plain K1) per pixel."""
    monkeypatch.setenv("MI3T_ACCEL", "cells")
    d = chip_smoke.small_terrain_dict(mt.ScalarTransform4f, width=16)
    cs.LAUNCHES.update(closest=0, anyhit=0)
    img_g = mt.render(mt.load_dict(d, device=cuda, spectral=True), seed=5,
                      spp=4).cpu().numpy()
    assert cs.LAUNCHES["closest"] > 0 and cs.LAUNCHES["anyhit"] > 0
    img_c = mt.render(mt.load_dict(d, device="cpu", spectral=True), seed=5,
                      spp=4).numpy()
    assert np.isfinite(img_g).all()
    assert np.isclose(img_g, img_c, rtol=1e-3, atol=1e-3).mean() > 0.995
    assert np.allclose(img_g.mean(), img_c.mean(), rtol=1e-3)


def test_spectral_cornell_prb_grads_on_card_match_cpu(cuda):
    """The spectral Cornell's PRB step (16^2, max_depth 4, 4 spp) in the
    spectral variant: the BSDF rows' and emitter radiance's gradients on
    the card finite and within 1e-3 of the CPU's largest entry."""
    d = chip_smoke._prb_dict(chip_smoke.spectral_variant_cornell_dict(
        mt, 16, 16, 4))
    names = ("bsdf_params", "em_radiance")
    g_card, g_cpu = (chip_smoke._grad_step(mt.load_dict(
        d, device=dev, spectral=True), names, 5, 4)[2]
        for dev in (cuda, "cpu"))
    for k in names:
        a, b = g_card[k].cpu(), g_cpu[k]
        assert torch.isfinite(a).all()
        scale = float(b.abs().max())
        assert torch.allclose(a, b, rtol=0, atol=1e-3 * scale + 1e-12)
    assert float(g_cpu["bsdf_params"].abs().max()) > 0


# ---------------------------------------------------------------------------
# K5 (bvh_pallas), K6 and K7 (bvh_queue) and K8 (bvh2) against their plain
# versions; the attic queries on the card against the CPU
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("closest", [True, False], ids=["closest", "anyhit"])
def test_traverse_kernel_matches_plain(cuda, np_rng, closest):
    tris, o, d = _soup(np_rng, n_ray=8192)
    acc = bp.build(*tris, device=cuda)
    maxt = torch.full((o.shape[0],), 3e38 if closest else 2.0, device=cuda)
    maxt[::7] = -1.0
    o3, d3, mt = bp.pack_rays(_vec(o, cuda), _vec(d, cuda), maxt)
    mode = "closest" if closest else "anyhit"
    before = bp.LAUNCHES[mode]
    kt, ks, ku, kv = bp.traverse(acc, o3, d3, mt, closest)
    torch.cuda.synchronize()
    assert bp.LAUNCHES[mode] == before + 1
    pt, ps, pu, pv = bp.traverse_plain(acc, o3, d3, mt, closest)
    hit = ps >= 0
    assert hit.any() and not hit[:8192:7].any()
    _assert_equal((kt, ks, ku, kv), (pt, ps, pu, pv), "t slot u v")


def test_queue_cull_kernel_matches_plain(cuda, np_rng):
    """K6 keys bit-equal from a nonzero cursor, with 8-triangle leaves."""
    tris, o, d = _soup(np_rng, n_ray=8192)
    acc = bq.build(*tris, leaf_size=8, device=cuda)
    assert acc.m_pad // bs.LC >= 2
    f, i = bq.initial_state(_vec(o, cuda), _vec(d, cuda),
                            torch.full((o.shape[0],), 1e30, device=cuda))
    first = bq.cull_topk_plain(acc, f, i[bs.LK])[2]
    lk = torch.where(torch.arange(first.shape[0], device=cuda) % 2 == 0,
                     torch.where(first == bs.NONE, 0, first), 0)
    lk = lk.to(torch.int32).contiguous()
    before = bq.LAUNCHES["cull"]
    got = bq.cull_topk(acc, f, lk)
    torch.cuda.synchronize()
    assert bq.LAUNCHES["cull"] == before + 1
    want = bq.cull_topk_plain(acc, f, lk)
    assert torch.equal(got, want)
    assert (want[bq.KQ - 1] != bs.NONE).any()


def test_queue_serve_kernel_matches_plain(cuda, np_rng):
    """K7 on the first schedule of a 16,384-ray query."""
    tris, o, d = _soup(np_rng, n_ray=16384)
    acc = bq.build(*tris, device=cuda)
    f, i = bq.initial_state(_vec(o, cuda), _vec(d, cuda),
                            torch.full((o.shape[0],), 1e30, device=cuda))
    f, i = bq.sort_by_head(acc, f, bq.fresh_cull(acc, f, i))
    lids = bq.simulate(i[bq.Q0:], f[bs.TB])[0]
    before = bq.LAUNCHES["serve"]
    kt, kp, ku, kv = bq.serve_multi(acc, lids, f)
    torch.cuda.synchronize()
    assert bq.LAUNCHES["serve"] == before + 1
    pt, pp, pu, pv = bq.serve_multi_plain(acc, lids, f)
    assert (pp >= 0).any()
    _assert_equal((kt, kp, ku, kv), (pt, pp, pu, pv))


# K5's edge tree: node -> children, or leaf id; node 5's box lies far off,
# so its subtree is never visited. The walk visits the leaves 3, 2, 1, 0,
# with 128, 33, 31 and 1 real triangles (whole and cut four-column groups
# of K5 any-hit, around a warp's width); leaf 4 is never reached.
K5_EDGE_TREE = {0: (1, 2), 1: (3, 4), 2: (5, 6), 3: 0, 4: 1, 5: (7, 8),
                6: (9, 10), 7: 4, 8: 5, 9: 2, 10: 3}
K5_EDGE_COUNTS = (1, 31, 33, 128, 128, 5)


def _k5_edge_case(np_rng, dev, case):
    """(BVHData, o3, d3, mt) of K5_EDGE_TREE over two tiles of rays under
    the edge slabs, with every seventh lane inactive (maxt -1) and some
    unbounded (maxt inf). "ties": one large, nearest triangle in leaf 3
    (column 100), twice in leaf 1 (columns 5 and 20) and in leaf 2
    (column 32); "occluded": a triangle under every ray in leaf 3, the
    first visited."""
    n_nodes = len(K5_EDGE_TREE)
    nb = np.zeros((n_nodes, 8), np.float32)
    nb[:, :3], nb[:, 3:6] = -10.0, 10.0
    nb[5, :3], nb[5, 3:6] = 100.0, 101.0
    nm = np.array([kid if isinstance(kid, tuple)
                   else (-kid - 1, K5_EDGE_COUNTS[kid])
                   for kid in K5_EDGE_TREE.values()], np.int32)
    tris = _edge_slabs(np_rng, [c - 1 for c in K5_EDGE_COUNTS])
    big = ([-1.0, -1.0, 0.1], [2.0, 0.0, 0.0], [0.0, 2.0, 0.0])
    if case == "ties":
        for leaf, col in ((3, 100), (1, 5), (1, 20), (2, 32)):
            tris[leaf, 0:9, col] = np.concatenate(big)
    if case == "occluded":
        tris[3, 0:9, 0] = [-50.0, -50.0, 0.05, 200.0, 0.0, 0.0, 0.0, 200.0,
                           0.0]
    acc = bp.BVHData(
        node_bounds=torch.as_tensor(nb, device=dev),
        node_meta=torch.as_tensor(nm, device=dev),
        tris=torch.as_tensor(tris, device=dev),
        prim_order=torch.zeros(tris.shape[0] * bp.K, dtype=torch.int32,
                               device=dev),
        n_leaves=tris.shape[0])
    o, d = _edge_rays(np_rng, 2 * bp.TILE)
    mt = np.full(2 * bp.TILE, 3e38 if case == "ties" else 2.5, np.float32)
    mt[3::7] = -1.0
    mt[5::11] = np.inf    # no hit beyond 3.4e38 counts in closest mode
    o3, d3 = (torch.as_tensor(a, device=dev) for a in (o, d))
    return acc, o3, d3, torch.as_tensor(mt, device=dev)


@pytest.mark.parametrize("case,closest", [("edges", True), ("edges", False),
                                          ("ties", True),
                                          ("occluded", False)])
def test_traverse_kernel_edges_equal_plain(cuda, np_rng, case, closest):
    """K5 on a hand-made tree: leaves of 1, 31, 33 and 128 real triangles,
    a subtree never visited, inactive lanes in every warp; equal ts in
    three leaves and twice in one (closest: the later leaf, then the
    larger column wins); a tile occluded in its first leaf (any-hit)."""
    acc, o3, d3, mt = _k5_edge_case(np_rng, cuda, case)
    mode = "closest" if closest else "anyhit"
    before = bp.LAUNCHES[mode]
    got = bp.traverse(acc, o3, d3, mt, closest)
    torch.cuda.synchronize()
    assert bp.LAUNCHES[mode] == before + 1
    want = bp.traverse_plain(acc, o3, d3, mt, closest)
    _assert_equal(got, want, "t slot u v")
    slot, active = want[1], mt >= 0
    assert not (slot[~active] >= 0).any()
    if case == "edges":
        assert (slot >= 0).any() and (slot[active] < 0).any()
    if case == "ties":
        assert (slot == 1 * bp.K + 20).sum() > 100
        assert not ((slot == 3 * bp.K + 100) | (slot == 2 * bp.K + 32)
                    | (slot == 1 * bp.K + 5)).any()
    if case == "occluded":
        assert (slot[active] == 1).all()


def test_queue_serve_kernel_edges_equal_plain(cuda, np_rng):
    """K7 on schedules edited from a query's first one: taken slots with -1
    between them, all 16 slots taken, each leaf in two consecutive slots,
    and slots of a padding slab (no real column) among real ones; rays
    with a short or negative bound."""
    tris, o, d = _soup(np_rng, n_ray=16384)
    acc = bq.build(*tris, device=cuda)
    f, i = bq.initial_state(_vec(o, cuda), _vec(d, cuda),
                            torch.full((o.shape[0],), 1e30, device=cuda))
    f, i = bq.sort_by_head(acc, f, bq.fresh_cull(acc, f, i))
    lids = bq.simulate(i[bq.Q0:], f[bs.TB])[0].cpu().numpy()
    pad = acc.tris.shape[0]
    slab = torch.zeros((1, 16, bq.K), device=cuda)
    slab[:, 9] = -1.0
    acc = acc.replace(tris=torch.cat([acc.tris, slab]).contiguous())
    rows = [b for b in range(lids.shape[0]) if (lids[b] >= 0).sum() >= 3]
    assert len(rows) >= 8
    for k, b in enumerate(rows[:8]):
        taken = lids[b][lids[b] >= 0]
        new = np.full(bq.T, -1, np.int32)
        if k % 4 == 0:    # -1 between taken slots
            new[1::2][:taken.size] = taken[:bq.T // 2]
        elif k % 4 == 1:  # every slot taken
            new[:] = np.resize(np.concatenate([taken, lids[rows[k + 1]][
                lids[rows[k + 1]] >= 0]]), bq.T)
        elif k % 4 == 2:  # each leaf twice in a row
            new[:2 * taken.size] = np.repeat(taken, 2)[:bq.T]
        else:             # the padding slab among real slabs
            new[:3] = (taken[0], pad, taken[1])
            new[4:6] = (pad, taken[2])
        lids[b] = new
    lids = torch.as_tensor(lids, device=cuda)
    f = f.clone()
    lane = torch.arange(f.shape[1], device=cuda)
    f[bs.TB] = torch.where(lane % 5 == 1, 1.5, f[bs.TB])
    f[bs.TB] = torch.where(lane % 11 == 2, -1.0, f[bs.TB])
    f[bs.TB] = torch.where(lane % 13 == 4, float("inf"), f[bs.TB])
    before = bq.LAUNCHES["serve"]
    got = bq.serve_multi(acc, lids, f)
    torch.cuda.synchronize()
    assert bq.LAUNCHES["serve"] == before + 1
    want = bq.serve_multi_plain(acc, lids, f)
    _assert_equal(got, want)
    prim = want[1].reshape(-1, bs.BLK)
    assert all(bool((prim[b] >= 0).any()) for b in rows[:8])


def test_bvh2_serve_kernel_matches_plain(cuda, np_rng):
    """K8 on 64 chunks: per chunk 4 distinct supernode ids (some NONE, some
    past the table), each lane wanting one of them or none and aimed at
    one of its triangles."""
    tris, _, d = _soup(np_rng, n_ray=64 * b2.CHUNK)
    acc = b2.build(*tris, device=cuda)
    c = 64
    ids = np.stack([np.sort(np_rng.choice(acc.n_nodes, 4, replace=False))
                    for _ in range(c)]).astype(np.int32)
    ids[::3, 3] = acc.n_nodes + 5
    ids[1::4, 2:] = b2.NONE_ID
    pick = np_rng.integers(0, 5, (c, b2.CHUNK))
    want = np.where(pick < 4, np.take_along_axis(ids, np.minimum(pick, 3),
                                                 axis=1), b2.NONE_ID)
    w = want.reshape(-1)
    node = np.minimum(w, acc.n_nodes - 1)
    rows = acc.tris.cpu().numpy()[node, :, np_rng.integers(0, b2.LEAF,
                                                           len(w))]
    o = rows[:, 0:3] + 0.25 * rows[:, 3:6] + 0.25 * rows[:, 6:9] - 2.0 * d
    tb = np.where(np.arange(len(w)) % 4 == 0, 1.5, 3e38)
    rays = np.stack([*o.T, *d.T, np.zeros(len(w)), tb]).astype(np.float32)
    rays = torch.as_tensor(np.ascontiguousarray(
        rays.reshape(8, c, b2.CHUNK).transpose(1, 0, 2)), device=cuda)
    ids = torch.as_tensor(ids, device=cuda)
    want = torch.as_tensor(want.astype(np.int32), device=cuda)
    before = b2.LAUNCHES["serve"]
    kt, kp, ku, kv = b2.serve(acc, ids, rays, want)
    torch.cuda.synchronize()
    assert b2.LAUNCHES["serve"] == before + 1
    want_out = b2.serve_plain(acc, ids, rays, want)
    assert (want_out[1] >= 0).sum() > 100
    _assert_equal((kt, kp, ku, kv), want_out)


K8_NODES = 6   # supernodes of the edge cases' table
K8_CHUNKS = 8


def _k8_edge_case(np_rng, dev, case):
    """(BVH2, ids, rays, want) of K8's edge cases: a table of six
    supernodes of random triangles (node 1 with 20 real, the rest full),
    eight chunks each served four of them, each lane wanting one of its
    chunk's ids or none and aimed at one of that supernode's triangles,
    tbest 1.5 on a quarter of the lanes and 3e38 elsewhere; then the
    case's edit (see test_bvh2_serve_kernel_edges_equal_plain)."""
    m, c, leaf = K8_NODES, K8_CHUNKS, b2.LEAF
    tris = np.zeros((m, 10, leaf), np.float32)
    tris[:, 9] = -1.0
    scale = np.ones(m)   # of a lane's distance to the triangle it aims at
    aim = {}
    for node in range(m):
        n = 20 if node == 1 else leaf
        tris[node, 0:3, :n] = np_rng.uniform(-1, 1, (3, n))
        tris[node, 3:9, :n] = np_rng.normal(0, 0.5, (6, n))
        tris[node, 9, :n] = 100 * node + np.arange(n)
        aim[node] = np.arange(n)
    if case == "ties":
        # node 2: two pairs of equal triangles, the larger id first in one
        # pair and last in the other; its other triangles far away
        tris[2, 0:3] += 100.0
        for a, b in ((3, 17), (20, 25)):
            tris[2, 0:9][:, [a, b]] = np.array(
                [-0.5, -0.5, a, 1.0, 0.0, 0.0, 0.0, 1.0, 0.0])[:, None]
        tris[2, 9, [3, 17, 20, 25]] = (250, 212, 226, 260)
        aim[2] = np.array([3, 20])
    if case == "degenerate":
        # node 3: det = 0 in columns 5 (e1 = 0) and 6 (e2 = 0)
        tris[3, 3:6, 5] = 0.0
        tris[3, 6:9, 6] = 0.0
        aim[3] = np.array([5, 6, 7])
    if case == "det_range":
        # |det| below 2^-126 in node 4, from 2^126 up in node 5
        tris[4, 0:3] *= 1e-19
        tris[4, 3:9] *= 2e-20
        tris[5, 0:3] *= 1e18
        tris[5, 3:9] *= 3e19
        scale[4], scale[5] = 1e-19, 1e19
    ids = np.stack([np.sort((k + np.arange(b2.N_SERVE)) % m)
                    for k in range(c)]).astype(np.int32)
    if case == "padding":     # chunk 1: only ids past the table
        ids[1] = m + np.array([1, 2, 3, 7])
    if case == "repeated":    # chunks 3-5 serve their first id twice
        ids[3:6, 2] = ids[3:6, 0]
    pick = np_rng.integers(0, 5, (c, b2.CHUNK))
    want = np.where(pick < 4, np.take_along_axis(ids, np.minimum(pick, 3),
                                                 axis=1), b2.NONE_ID)
    if case == "none":        # chunk 0: no lane wants an id
        want[0] = b2.NONE_ID
    if case == "unserved":    # chunk 2: half its lanes want an id not served
        want[2, ::2] = np.setdiff1d(np.arange(m), ids[2])[0]
    w = want.reshape(-1)
    d = np_rng.normal(size=(w.size, 3))
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    o = np_rng.uniform(-4, 4, (w.size, 3))
    for i in np.nonzero(w < m)[0]:
        col = tris[w[i], :, np_rng.choice(aim[w[i]])].astype(np.float64)
        o[i] = col[0:3] + 0.25 * col[3:6] + 0.25 * col[6:9] \
            - 2.0 * scale[w[i]] * d[i]
    tb = np.where(np.arange(w.size) % 4 == 0, 1.5, 3e38)
    rays = np.stack([*o.T, *d.T, np.zeros(w.size), tb]).astype(np.float32)
    rays = np.ascontiguousarray(rays.reshape(8, c, b2.CHUNK).transpose(
        1, 0, 2))
    acc = b2.BVH2(bounds=torch.zeros((m, 6), device=dev),
                  tris=torch.as_tensor(tris, device=dev), n_nodes=m)
    args = [torch.as_tensor(a, device=dev) for a in (ids, rays,
                                                     want.astype(np.int32))]
    if case == "t_eq_tbest":
        # every hit lane's bound becomes its t: odd lanes' exactly, even
        # lanes' one ulp below it
        t, p, _, _ = b2.serve_plain(acc, *args)
        hit = p >= 0
        lane = torch.arange(b2.CHUNK, device=dev).expand_as(t)
        below = torch.nextafter(t, torch.zeros_like(t))
        tb = args[1][:, 7]
        args[1][:, 7] = torch.where(hit, torch.where(lane % 2 == 1, t,
                                                     below), tb)
    return (acc, *args)


def _k8_case_holds(case, acc, ids, rays, want, out):
    """The plain version's outputs show the case's edit."""
    t, p = out[0], out[1]
    assert (p >= 0).sum() > 50
    if case == "none":
        assert (p[0] == -1).all() and (t[0] == b2.BIG).all()
    if case == "padding":
        assert (p[1] == -1).all() and (want[1] >= acc.n_nodes).all()
    if case == "unserved":
        assert (p[2, ::2] == -1).all() and (want[2, ::2] < acc.n_nodes).all()
    if case == "ties":
        for prim in (250, 260):
            assert (p == prim).sum() > 5
        assert not ((p == 212) | (p == 226)).any()
    if case == "degenerate":
        assert not ((p == 305) | (p == 306)).any()
        assert ((p >= 300) & (p < 400)).any()
    if case == "det_range":
        d = rays[:, 3:6].permute(0, 2, 1).double()
        for node, far in ((4, False), (5, True)):
            sel = want == node
            e1 = acc.tris[node, 3:6].double().T
            e2 = acc.tris[node, 6:9].double().T
            det = (torch.linalg.cross(d[sel][:, None, :], e2[None])
                   * e1).sum(dim=2).abs()
            assert (det >= 2.0 ** 126).any() if far else \
                (det < 2.0 ** -126).any()
    if case == "t_eq_tbest":
        # the odd lanes' hits lie at exactly their bound
        lane = torch.arange(b2.CHUNK, device=t.device).expand_as(t)
        exact = (lane % 2 == 1) & (p >= 0)
        assert exact.sum() > 50 and (t[exact] == rays[:, 7][exact]).all()
    if case == "repeated":
        ref = ids.clone()
        ref[3:6, 2] = b2.NONE_ID
        for g, w in zip(out, b2.serve_plain(acc, ref, rays, want)):
            assert torch.equal(g, w)


K8_EDGES = ("none", "padding", "unserved", "ties", "degenerate",
            "det_range", "t_eq_tbest", "repeated")


@pytest.mark.parametrize("case", K8_EDGES)
def test_bvh2_serve_kernel_edges_equal_plain(cuda, np_rng, case):
    """K8 on a hand-made table, t, prim, u and v bit-equal to the plain
    version: "none", a chunk whose lanes all want NONE; "padding", a chunk
    served only ids past the table; "unserved", lanes wanting an id of the
    table that their chunk is not served; "ties", equal triangles (the
    larger prim wins, in either column order); "degenerate", triangles with
    det = 0; "det_range", |det| below 2^-126 and from 2^126 up (the IEEE
    pass of mt_exact.cuh); "t_eq_tbest", hits at exactly the bound and one
    ulp past it; "repeated", a served id repeated in a chunk."""
    acc, ids, rays, want = _k8_edge_case(np_rng, cuda, case)
    before = b2.LAUNCHES["serve"]
    got = b2.serve(acc, ids, rays, want)
    torch.cuda.synchronize()
    assert b2.LAUNCHES["serve"] == before + 1
    plain = b2.serve_plain(acc, ids, rays, want)
    _k8_case_holds(case, acc, ids, rays, want, plain)
    _assert_equal(got, plain)


ATTIC = {"pallas": (bp, "intersect_bvh", "occluded_bvh"),
         "pallas_sorted": (bp, "intersect_bvh_sorted", "occluded_bvh_sorted"),
         "queue": (bq, "intersect_bvh", "occluded_bvh"),
         "bvh2": (b2, "intersect_bvh", "occluded_bvh")}


@pytest.mark.parametrize("accel", sorted(ATTIC))
def test_attic_queries_on_card_match_cpu(cuda, np_rng, accel):
    """16,384 rays: wide enough for bvh_queue's K6/K7 cycles."""
    mod, closest, anyhit = ATTIC[accel]
    tris, o, d = _soup(np_rng, n_ray=16384)
    for k in mod.LAUNCHES:
        mod.LAUNCHES[k] = 0
    results = []
    for dev in (cuda, torch.device("cpu")):
        acc = mod.build(*tris, device=dev)
        t, prim, _, valid = getattr(mod, closest)(acc, _vec(o, dev),
                                                  _vec(d, dev), 1e30)
        occ = getattr(mod, anyhit)(acc, _vec(o, dev), _vec(d, dev), 2.0)
        results.append([x.cpu() for x in (t, prim, valid, occ)])
    assert all(v > 0 for v in mod.LAUNCHES.values()), mod.LAUNCHES
    (tg, pg, vg, og), (tc, pc, vc, oc) = results
    assert torch.equal(vg, vc) and torch.equal(og, oc)
    assert (pg[vc] == pc[vc]).float().mean() > 0.999
    assert torch.allclose(tg[vc], tc[vc], rtol=1e-5)


# ---------------------------------------------------------------------------
# PRB (ad/prb.py) on the card: the Cornell box (dense) and the small
# terrain (cellserve, K1 in the primal and in the replay)
# ---------------------------------------------------------------------------

def _prb_grads(scene, names, spp, seed):
    """d mean(render) / dθ through the prb integrator (gradients moved to
    the CPU)."""
    theta = {k: getattr(scene, k).detach().clone().requires_grad_(True)
             for k in names}
    img = mt.render(scene.replace(**theta), spp=spp, seed=seed)
    grads = torch.autograd.grad(img.mean(), [theta[k] for k in names])
    return {k: g.cpu() for k, g in zip(names, grads)}


def test_cornell_prb_grads_on_card_match_cpu(cuda):
    """16^2 Cornell box, max_depth 3, 4 spp: the card's PRB gradients of
    bsdf_params, em_radiance, env_data and vertices within 1e-3 of each
    table's largest CPU gradient."""
    d = chip_smoke._prb_dict(mt.cornell_box(16, 16, max_depth=3))
    names = ("bsdf_params", "em_radiance", "env_data", "vertices")
    g_card = _prb_grads(mt.load_dict(d, device=cuda), names, 4, 0)
    g_cpu = _prb_grads(mt.load_dict(d, device="cpu"), names, 4, 0)
    for k in names:
        assert torch.isfinite(g_card[k]).all(), k
        scale = float(g_cpu[k].abs().max())
        assert torch.allclose(g_card[k], g_cpu[k], rtol=0,
                              atol=1e-3 * scale + 1e-12), k
    assert float(g_card["em_radiance"].abs().max()) > 0


MATERIAL_SCENES = {"glossy": chip_smoke.glossy_cornell_dict,
                   "every_bsdf": chip_smoke.every_bsdf_dict}


@pytest.mark.parametrize("scene", sorted(MATERIAL_SCENES))
def test_material_render_on_card_matches_cpu(cuda, scene):
    """16^2 glossy and every-BSDF Cornell boxes (max_depth 4, 16 spp) on
    the card against the CPU: > 99.5 % of values close, means rtol 1e-3."""
    d = MATERIAL_SCENES[scene](mt, 16, 16, 4)
    img_g = mt.render(mt.load_dict(d, device=cuda), seed=5,
                      spp=16).cpu().numpy()
    img_c = mt.render(mt.load_dict(d, device="cpu"), seed=5, spp=16).numpy()
    assert np.isfinite(img_g).all() and float(img_g.max()) > 0
    assert np.isclose(img_g, img_c, rtol=1e-3, atol=1e-3).mean() > 0.995
    assert np.allclose(img_g.mean(), img_c.mean(), rtol=1e-3)


@pytest.mark.parametrize("scene", sorted(MATERIAL_SCENES))
def test_material_prb_grads_on_card_match_cpu(cuda, scene):
    """16^2 glossy and every-BSDF Cornell boxes under prb (max_depth 3,
    4 spp): the card's gradients of bsdf_params and em_radiance finite and
    within 1e-3 of each table's largest CPU gradient."""
    d = chip_smoke._prb_dict(MATERIAL_SCENES[scene](mt, 16, 16, 3))
    names = ("bsdf_params", "em_radiance")
    g_card = _prb_grads(mt.load_dict(d, device=cuda), names, 4, 0)
    g_cpu = _prb_grads(mt.load_dict(d, device="cpu"), names, 4, 0)
    for k in names:
        assert torch.isfinite(g_card[k]).all(), k
        scale = float(g_cpu[k].abs().max())
        assert scale > 0, k
        assert torch.allclose(g_card[k].cpu(), g_cpu[k], rtol=0,
                              atol=1e-3 * scale + 1e-12), k


def test_terrain_prb_replay_launches_k1(cuda, monkeypatch):
    """The small terrain under prb on the card: K1 launches, closest and
    any-hit, in the primal; the backward replay launches it again, as
    often; the gradients are finite and nonzero."""
    monkeypatch.setenv("MI3T_ACCEL", "cells")
    d = chip_smoke._prb_dict(chip_smoke.small_terrain_dict(
        mt.ScalarTransform4f, width=16))
    scene = mt.load_dict(d, device=cuda)
    names = ("bsdf_params", "env_data", "de_params")
    theta = {k: getattr(scene, k).detach().clone().requires_grad_(True)
             for k in names}
    cs.LAUNCHES.update(closest=0, anyhit=0)
    img = mt.render(scene.replace(**theta), spp=4, seed=5)
    primal = dict(cs.LAUNCHES)
    assert primal["closest"] > 0 and primal["anyhit"] > 0, primal
    grads = torch.autograd.grad(img.mean(), [theta[k] for k in names])
    replay = {k: cs.LAUNCHES[k] - primal[k] for k in primal}
    assert replay == primal, (primal, replay)
    for k, g in zip(names, grads):
        assert torch.isfinite(g).all() and bool((g != 0).any()), k


# ---------------------------------------------------------------------------
# Point lights, the parameter view and the optimisation tools on the card
# ---------------------------------------------------------------------------

def test_interior_render_on_card_matches_cpu(cuda, monkeypatch):
    """bench.py's interior at 9,000 triangles (cellserve, a point light),
    24^2, 4 spp, max_depth 4: the card's image against the CPU's."""
    monkeypatch.setenv("MI3T_ACCEL", "cells")
    d = chip_smoke.interior_dict(mt.ScalarTransform4f, 9000, width=24)
    cs.LAUNCHES.update(closest=0, anyhit=0)
    img_g = mt.render(mt.load_dict(d, device=cuda), seed=5, spp=4)
    assert cs.LAUNCHES["closest"] > 0 and cs.LAUNCHES["anyhit"] > 0
    img_c = mt.render(mt.load_dict(d, device="cpu"), seed=5, spp=4)
    img_g, img_c = img_g.cpu().numpy(), img_c.numpy()
    assert np.isfinite(img_g).all() and img_g.mean() > 0
    assert np.isclose(img_g, img_c, rtol=1e-3, atol=1e-3).mean() > 0.995
    assert np.allclose(img_g.mean(), img_c.mean(), rtol=1e-3)


@pytest.mark.parametrize("name", ["Adam", "SGD", "RMSProp"])
def test_optimizers_on_card_match_cpu(cuda, np_rng, name):
    params = {"a": np_rng.normal(size=(64, 3)).astype(np.float32)}
    grads = [np_rng.normal(size=(64, 3)).astype(np.float32)
             for _ in range(5)]
    runs = []
    for dev in (cuda, torch.device("cpu")):
        opt = getattr(mt.ad, name)(lr=0.05, params={
            "a": torch.as_tensor(params["a"], device=dev)})
        for g in grads:
            opt.step({"a": torch.as_tensor(g, device=dev)})
        assert opt["a"].device.type == dev.type
        runs.append(opt["a"].cpu())
    torch.testing.assert_close(runs[0], runs[1], rtol=1e-5, atol=1e-6)


def test_largesteps_on_card_matches_cpu(cuda, np_rng):
    """The block CG solve and its gradient on the card (index_add_ sums in
    another order) against the CPU."""
    side = 16
    xs = np.linspace(-1, 1, side, dtype=np.float32)
    X, Y = np.meshgrid(xs, xs, indexing="ij")
    verts = np.stack([X, Y, 0.2 * np_rng.normal(size=X.shape)], -1).reshape(
        -1, 3).astype(np.float32)
    idx = np.arange(side * side).reshape(side, side)
    a, b = idx[:-1, :-1].ravel(), idx[1:, :-1].ravel()
    c, d = idx[:-1, 1:].ravel(), idx[1:, 1:].ravel()
    faces = np.concatenate([np.stack([a, b, c], -1),
                            np.stack([b, d, c], -1)], 0)
    u = np_rng.normal(size=verts.shape).astype(np.float32)
    w = np_rng.normal(size=verts.shape).astype(np.float32)
    out = []
    for dev in (cuda, torch.device("cpu")):
        ls = mt.ad.LargeSteps(torch.as_tensor(verts, device=dev), faces,
                              lambda_=19.0, method="cotan")
        x = torch.as_tensor(u, device=dev).requires_grad_(True)
        v = ls.from_differential(x)
        (v * torch.as_tensor(w, device=dev)).sum().backward()
        out.append((v.detach().cpu(), x.grad.cpu(), ls.cg_iterations))
    (vg, gg, _), (vc, gc, _) = out
    scale = float(vc.abs().max())
    torch.testing.assert_close(vg, vc, rtol=0, atol=1e-5 * scale)
    torch.testing.assert_close(gg, gc, rtol=0,
                               atol=1e-5 * float(gc.abs().max()))


def test_vertex_update_on_card_equals_cpu(cuda, monkeypatch):
    """One update() after a vertex edit on the small terrain: the card's
    rebuilt cellserve and area tables equal the CPU's bit for bit."""
    from mitsuba3_tpu_torch.convert import arrays_from_scene
    monkeypatch.setenv("MI3T_ACCEL", "cells")
    d = chip_smoke.small_terrain_dict(mt.ScalarTransform4f)
    results = []
    for dev in (cuda, torch.device("cpu")):
        params = mt.traverse(mt.load_dict(d, device=dev))
        v = params["vertices"].cpu().numpy().copy()
        v[:, 2] += 0.3 * np.exp(-(v[:, 0] ** 2 + v[:, 1] ** 2))
        params["vertices"] = v
        scene = params.update()
        assert scene.accel.tris.device.type == dev.type
        results.append(arrays_from_scene(scene))
    (ag, mg), (ac, mc) = results
    assert mg == mc and sorted(ag) == sorted(ac)
    for k in ac:
        np.testing.assert_array_equal(ag[k], ac[k], err_msg=k)


@pytest.mark.parametrize("combo", chip_smoke.XML_COMBOS,
                         ids=[c[0] for c in chip_smoke.XML_COMBOS])
def test_sampler_render_on_card_matches_cpu(cuda, tmp_path, combo):
    """Each sampler type (with chip_smoke's sensor and filter for it) from
    one XML file at 16^2, 16 spp, max_depth 4: the card's image against
    the CPU's per pixel."""
    sampler, sensor, rfilter, crop = combo
    path = chip_smoke.cornell_xml(
        mt, str(tmp_path), 16, 16, max_depth=4, spp=16, sampler=sampler,
        sensor=sensor, rfilter=rfilter,
        crop=crop and tuple(c // 2 for c in crop))
    img_g = mt.render(mt.load_file(path), seed=5).cpu().numpy()
    img_c = mt.render(mt.load_file(path, device="cpu"), seed=5).numpy()
    assert img_g.shape == img_c.shape and np.isfinite(img_g).all()
    assert np.isclose(img_g, img_c, rtol=1e-3, atol=1e-3).mean() > 0.995
    assert np.allclose(img_g.mean(), img_c.mean(), rtol=1e-3)


def test_load_file_defaults_to_the_card(cuda, tmp_path, monkeypatch):
    """load_file and load_string with no device put the scene on the card,
    its accel too (the small terrain as a PLY above 8192 faces)."""
    monkeypatch.setenv("MI3T_ACCEL", "cells")
    path = chip_smoke.terrain_xml(
        str(tmp_path), chip_smoke.small_terrain_dict(mt.ScalarTransform4f),
        "terrain")
    scene = mt.load_file(path)
    assert scene.device.type == "cuda"
    assert scene.accel.tris.device.type == "cuda"
    monkeypatch.chdir(tmp_path)
    with open(path) as f:
        assert mt.load_string(f.read()).device.type == "cuda"


@pytest.mark.parametrize("filt", ["bilinear", "nearest"])
@pytest.mark.parametrize("wrap", ["repeat", "clamp", "mirror"])
def test_texture_lookups_on_card_match_cpu(cuda, np_rng, wrap, filt):
    """eval_texture (every wrap and filter, uvs inside and outside
    [0, 1]) and, for mipmaps, the levels in one gather: the card's values
    within 1e-6 of the CPU's."""
    from mitsuba3_tpu_torch.core.vec import Vec2
    from mitsuba3_tpu_torch.render import texture as tex_mod
    tex = np_rng.random((37, 23, 3)).astype(np.float32)
    uv = np_rng.uniform(-0.8, 1.9, (2, 8192)).astype(np.float32)
    out = []
    for dev in (cuda, torch.device("cpu")):
        t = torch.as_tensor(tex, device=dev)
        u, v = (torch.as_tensor(a, device=dev) for a in uv)
        vals = [tex_mod.eval_texture(t, Vec2(u, v), wrap, filt).to_array()]
        if filt == "bilinear" and wrap != "mirror":
            levels = tuple(torch.as_tensor(lv, device=dev)
                           for lv in tex_mod.build_mips(tex))
            vals.append(tex_mod._eval_levels(levels, Vec2(u, v), wrap))
        out.append([x.cpu() for x in vals])
    for a, b in zip(*out):
        assert torch.allclose(a, b, rtol=0, atol=1e-6)


def test_textured_cornell_on_card_matches_cpu(cuda, tmp_path):
    """chip_smoke's textured Cornell from its XML file (64^2 images) at
    32^2, 16 spp, max_depth 8 (prb primal): the card's image against the
    CPU's per pixel."""
    chip_smoke.write_cornell_textures(str(tmp_path), 64)
    path = chip_smoke.textured_cornell_xml(mt, str(tmp_path), 32, 32, 8, 16)
    img_g = mt.render(mt.load_file(path), seed=5).cpu().numpy()
    img_c = mt.render(mt.load_file(path, device="cpu"), seed=5).numpy()
    assert np.isfinite(img_g).all() and float(img_g.max()) > 0
    assert np.isclose(img_g, img_c, rtol=1e-3, atol=1e-3).mean() > 0.995
    assert np.allclose(img_g.mean(), img_c.mean(), rtol=1e-3)


def test_texture_grads_on_card_match_cpu(cuda, tmp_path):
    """The textured Cornell (16^2, max_depth 3, 4 spp, prb): every
    texture's gradient on the card finite, of the CPU's shape and within
    1e-3 of its largest CPU entry; the small textured terrain's env_data
    and texture gradients likewise."""
    root = str(tmp_path)
    chip_smoke.write_cornell_textures(root, 64)
    chip_smoke.write_terrain_textures(root, 64, (16, 32))
    scenes = (
        (mt.load_file(chip_smoke.textured_cornell_xml(mt, root, 16, 16, 3, 4),
                      device=cuda),
         mt.load_file(chip_smoke.textured_cornell_xml(mt, root, 16, 16, 3, 4),
                      device="cpu")),
        tuple(mt.load_dict(chip_smoke._prb_dict(
            chip_smoke.textured_terrain_dict(
                chip_smoke.small_terrain_dict, mt.ScalarTransform4f, root,
                width=16)), device=dev) for dev in (cuda, "cpu")))
    for card, cpu in scenes:
        theta = {}
        for name, scene in (("cuda", card), ("cpu", cpu)):
            leaves = tuple(t.detach().clone().requires_grad_(True)
                           for t in scene.textures)
            env = scene.env_data.detach().clone().requires_grad_(True)
            img = mt.render(scene.replace(textures=leaves, env_data=env),
                            spp=4, seed=0)
            theta[name] = [g.cpu() for g in torch.autograd.grad(
                img.mean(), leaves + (env,))]
        for a, b in zip(theta["cuda"], theta["cpu"]):
            assert a.shape == b.shape and torch.isfinite(a).all()
            scale = float(b.abs().max())
            assert torch.allclose(a, b, rtol=0, atol=1e-3 * scale + 1e-12)


# ---------------------------------------------------------------------------
# Participating media on the card
# ---------------------------------------------------------------------------

def test_foggy_interior_on_card_matches_cpu(cuda, monkeypatch):
    """The 9,000-triangle interior with the camera in a homogeneous medium
    (chip_smoke.foggy_interior_dict, cellserve, volpath), 24^2, 4 spp: K1
    closest launched, any-hit not (every shadow segment is a closest
    query), the card's image against the CPU's per pixel."""
    monkeypatch.setenv("MI3T_ACCEL", "cells")
    d = chip_smoke.foggy_interior_dict(mt.ScalarTransform4f, 9000, width=24)
    cs.LAUNCHES.update(closest=0, anyhit=0)
    img_g = mt.render(mt.load_dict(d, device=cuda), seed=5, spp=4)
    assert cs.LAUNCHES["closest"] > 0 and cs.LAUNCHES["anyhit"] == 0
    img_c = mt.render(mt.load_dict(d, device="cpu"), seed=5, spp=4)
    img_g, img_c = img_g.cpu().numpy(), img_c.numpy()
    assert np.isfinite(img_g).all() and img_g.mean() > 0
    assert np.isclose(img_g, img_c, rtol=1e-3, atol=1e-3).mean() > 0.995
    assert np.allclose(img_g.mean(), img_c.mean(), rtol=1e-3)


def test_smoke_cell_table_built_once_on_card(cuda, monkeypatch):
    """examples/03_volumetric.py's smoke on a 256^3 grid (16^2, 2 spp,
    volpath): its cell table (255^3 x 8 floats, 0.53 GB) is built once for
    the render, however many tracking steps read it, so the pass's peak
    memory stays within the grid, the table and 512 MiB."""
    from mitsuba3_tpu_torch import media
    builds = []
    real = media.build_cells
    monkeypatch.setattr(media, "build_cells",
                        lambda g: builds.append(g.shape) or real(g))
    scene = mt.load_dict(chip_smoke.smoke_dict(mt, 16, 256, spp=2),
                         device=cuda)
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    img = mt.render(scene, seed=1)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() - base
    assert builds == [(256, 256, 256)]
    assert torch.isfinite(img).all() and float(img.mean()) > 0
    assert peak < 255 ** 3 * 8 * 4 + (512 << 20), peak


def test_fog_prbvolpath_grads_on_card_match_cpu(cuda):
    """The fog Cornell under prbvolpath (16^2, max_depth 4, 4 spp): the
    medium rows', BSDF rows' and emitter radiance's gradients on the card
    finite and within 1e-3 of the CPU's largest entry."""
    d = chip_smoke.fog_cornell_dict(mt, 16, 16, 4, "prbvolpath")
    names = chip_smoke.MEDIA_GRADS
    g_card = chip_smoke._grad_step(mt.load_dict(d, device=cuda), names, 5,
                                   4)[2]
    g_cpu = chip_smoke._grad_step(mt.load_dict(d, device="cpu"), names, 5,
                                  4)[2]
    for k in names:
        a, b = g_card[k].cpu(), g_cpu[k]
        assert torch.isfinite(a).all()
        scale = float(b.abs().max())
        assert scale > 0 and torch.allclose(a, b, rtol=0,
                                            atol=1e-3 * scale)


def test_ptracer_atomic_splat_on_card_matches_cpu(cuda):
    """The light tracer's splat is an atomic index_add_ on the card, its
    order of summation not fixed: the Cornell box (24^2, 8 light paths a
    pixel in two passes, max_depth 4) on the card against the CPU, isclose
    rtol 1e-3, atol 1e-3 on > 99.5 % of values, means within 1e-3; two
    card runs agree to 1e-5 of the largest value."""
    from mitsuba3_tpu_torch.integrators.ptracer import render_ptracer
    d = dict(mt.cornell_box(24, 24, max_depth=4),
             integrator={"type": "ptracer", "max_depth": 4})
    img_g = render_ptracer(mt.load_dict(d, device=cuda), seed=5, spp=8,
                           max_wavefront=2304)
    img_g2 = render_ptracer(mt.load_dict(d, device=cuda), seed=5, spp=8,
                            max_wavefront=2304)
    img_c = render_ptracer(mt.load_dict(d, device="cpu"), seed=5, spp=8,
                           max_wavefront=2304)
    img_g, img_g2, img_c = (img_g.cpu().numpy(), img_g2.cpu().numpy(),
                            img_c.numpy())
    assert np.isfinite(img_g).all() and img_g.mean() > 0
    assert np.isclose(img_g, img_c, rtol=1e-3, atol=1e-3).mean() > 0.995
    assert np.allclose(img_g.mean(), img_c.mean(), rtol=1e-3)
    np.testing.assert_allclose(img_g2, img_g, rtol=0,
                               atol=1e-5 * np.abs(img_g).max())


def test_aov_rgb_on_card_equals_path(cuda):
    """aov (every AOV and a nested path) on the card: its last three
    channels equal the path render of the same seed, value for value;
    its image against the CPU's."""
    path = {"type": "path", "max_depth": 4}
    d = dict(mt.cornell_box(24, 24, max_depth=4), integrator={
        "type": "aov", "aovs": chip_smoke.ALL_AOVS, "integrator": path})
    img = mt.render(mt.load_dict(d, device=cuda), seed=5, spp=4)
    ref = mt.render(mt.load_dict(dict(d, integrator=path), device=cuda),
                    seed=5, spp=4)
    assert tuple(img.shape) == (24, 24, 20)
    assert torch.equal(img[..., 17:], ref)
    img_c = mt.render(mt.load_dict(d, device="cpu"), seed=5, spp=4).numpy()
    assert np.isclose(img.cpu().numpy(), img_c, rtol=1e-3,
                      atol=1e-3).mean() > 0.995


def test_direct_above_8192_faces_launches_k1(cuda, monkeypatch):
    """direct on the small terrain (8,978 faces, cellserve) on the card:
    K1 launched for closest queries (the primary and BSDF rays) and
    any-hit ones (NEE shadow rays); the image against the CPU's."""
    monkeypatch.setenv("MI3T_ACCEL", "cells")
    d = dict(chip_smoke.small_terrain_dict(mt.ScalarTransform4f),
             integrator={"type": "direct"})
    cs.LAUNCHES.update(closest=0, anyhit=0)
    img_g = mt.render(mt.load_dict(d, device=cuda), seed=5, spp=4)
    assert cs.LAUNCHES["closest"] > 0 and cs.LAUNCHES["anyhit"] > 0
    img_c = mt.render(mt.load_dict(d, device="cpu"), seed=5, spp=4).numpy()
    img_g = img_g.cpu().numpy()
    assert np.isfinite(img_g).all() and img_g.mean() > 0
    assert np.isclose(img_g, img_c, rtol=1e-3, atol=1e-3).mean() > 0.995


def test_sphere_light_prb_step_on_card(cuda):
    """A PRB step of the sphere-lit Cornell (16^2, 4 spp, max_depth 3)
    on the card: every gradient finite, em_radiance's nonzero and within
    1e-3 of the largest entry of the CPU's."""
    d = chip_smoke.sphere_cornell_dict(mt, 16, 16, 3, "prb")
    names = ("bsdf_params", "em_radiance")
    grads = {dev: chip_smoke._grad_step(mt.load_dict(d, device=dev), names,
                                        3, 4)[2] for dev in (cuda, "cpu")}
    for k in names:
        a, b = grads[cuda][k].cpu(), grads["cpu"][k]
        assert bool(torch.isfinite(a).all())
        scale = float(b.abs().max())
        assert scale > 0
        assert torch.allclose(a, b, rtol=0, atol=1e-3 * scale)


# ---------------------------------------------------------------------------
# The slice's materials: hair on tube curves, measured, principled and a
# user's BSDF
# ---------------------------------------------------------------------------

def test_hair_ball_launches_k1_in_both_modes(cuda, tmp_path, monkeypatch):
    """A hair ball of 64 strands (12,288 tube faces, cellserve) in hair on
    the card: K1 launched for closest and any-hit queries; the image
    against the CPU's."""
    monkeypatch.setenv("MI3T_ACCEL", "cells")
    path = chip_smoke.write_curve_file(
        str(tmp_path / "hair.txt"), chip_smoke.hair_strands(64),
        chip_smoke.HAIR_RADIUS)
    d = chip_smoke.hair_dict(mt, path, 16, chip_smoke.HAIR_EUMELANIN)
    scene = mt.load_dict(d, device=cuda)
    assert isinstance(scene.accel, cs.CellServe)
    cs.LAUNCHES.update(closest=0, anyhit=0)
    img_g = mt.render(scene, seed=5, spp=4).cpu().numpy()
    assert cs.LAUNCHES["closest"] > 0 and cs.LAUNCHES["anyhit"] > 0
    img_c = mt.render(mt.load_dict(d, device="cpu"), seed=5, spp=4).numpy()
    assert np.isfinite(img_g).all() and img_g.mean() > 0
    assert np.isclose(img_g, img_c, rtol=1e-3, atol=1e-3).mean() > 0.995
    assert np.allclose(img_g.mean(), img_c.mean(), rtol=1e-3)


def test_measured_render_on_card_matches_cpu(cuda, tmp_path):
    """The materials Cornell (its isotropic and anisotropic measured
    tables read from .bsdf files) at 16^2, max_depth 4, 4 spp on the card
    against the CPU: > 99.5 % of values close, means rtol 1e-3."""
    chip_smoke.register_half_diffuse(mt)
    iso, aniso = chip_smoke.write_measured(str(tmp_path), 16)
    d = chip_smoke.materials_cornell_dict(mt, 16, 16, 4, {"filename": iso},
                                          {"filename": aniso})
    img_g = mt.render(mt.load_dict(d, device=cuda), seed=5,
                      spp=4).cpu().numpy()
    img_c = mt.render(mt.load_dict(d, device="cpu"), seed=5, spp=4).numpy()
    assert np.isfinite(img_g).all() and float(img_g.max()) > 0
    assert np.isclose(img_g, img_c, rtol=1e-3, atol=1e-3).mean() > 0.995
    assert np.allclose(img_g.mean(), img_c.mean(), rtol=1e-3)


def test_principled_prb_step_on_card(cuda):
    """A PRB step of the small terrain in principled (cellserve, 16^2,
    4 spp) on the card: every gradient finite, the principled row's
    metallic, roughness and clearcoat gradients nonzero and within 1e-3 of
    the largest entry of the CPU's."""
    d = chip_smoke._prb_dict(chip_smoke.principled_terrain_dict(
        chip_smoke.small_terrain_dict, mt.ScalarTransform4f, width=16))
    names = ("bsdf_params", "em_radiance")
    grads = {dev: chip_smoke._grad_step(mt.load_dict(d, device=dev), names,
                                        3, 4)[2] for dev in (cuda, "cpu")}
    for k in names:
        a, b = grads[cuda][k].cpu(), grads["cpu"][k]
        assert bool(torch.isfinite(a).all()), k
        scale = float(b.abs().max())
        assert torch.allclose(a, b, rtol=0, atol=1e-3 * scale), k
    assert bool((grads[cuda]["bsdf_params"][0, [4, 5, 11]] != 0).all())


def test_custom_bsdf_render_on_card(cuda):
    """half_diffuse, a user's BSDF in torch, on the card: the image equals
    the CPU's at > 99.5 % of values and the card's diffuse at half the
    reflectance value for value."""
    from test_torch_materials import _half_scene
    chip_smoke.register_half_diffuse(mt)
    half = {"type": "half_diffuse",
            "reflectance": {"type": "rgb", "value": [0.8, 0.6, 0.4]}}
    img_g = mt.render(mt.load_dict(_half_scene(mt, half), device=cuda),
                      seed=2, spp=8).cpu().numpy()
    img_c = mt.render(mt.load_dict(_half_scene(mt, half), device="cpu"),
                      seed=2, spp=8).numpy()
    img_d = mt.render(mt.load_dict(_half_scene(mt, {
        "type": "diffuse", "reflectance": {
            "type": "rgb", "value": [0.4, 0.3, 0.2]}}), device=cuda),
        seed=2, spp=8).cpu().numpy()
    assert np.isfinite(img_g).all() and img_g.mean() > 0
    assert np.isclose(img_g, img_c, rtol=1e-3, atol=1e-3).mean() > 0.995
    np.testing.assert_array_equal(img_g, img_d)


# ---------------------------------------------------------------------------
# Shapes: analytic rows, SDF grids, instancing
# ---------------------------------------------------------------------------

def test_instanced_prototype_k1_matches_plain(cuda, monkeypatch):
    """The small instanced field's first instance round on the card (its
    camera rays made on the CPU): the prototype with its own cellserve
    (make_terrain(66)) queried on the lanes that picked it (the others
    masked). K1 on the query's pairs,
    closest and any-hit, bit-equal to its plain version on the same
    pairs; the whole query against the CPU's (hits and occlusion equal,
    prims on > 99.9 % of hits, t rtol 1e-5)."""
    from mitsuba3_tpu_torch.render import integrator as ri
    monkeypatch.setenv("MI3T_ACCEL", "cells")
    d = chip_smoke.instanced_field_dict(mt.ScalarTransform4f, width=32,
                                        tiles=2, side=66, scatter=6)
    from mitsuba3_tpu_torch.render.records import Ray
    cpu_scene = mt.load_dict(d, device="cpu")
    sppc, _ = ri.plan_passes(cpu_scene, 4, 1 << 20)
    ray = ri._gen_camera_rays(cpu_scene, ri.pass_seed(0, 0), sppc, 0, 4)[1]
    out = {}
    for dev in (cuda, "cpu"):
        scene = mt.load_dict(d, device=dev)
        acc = scene.proto_accels[0]
        assert isinstance(acc, cs.CellServe)
        r, mask = chip_smoke.proto_first_round(scene, Ray(
            o=_vec(ray.o.to_array().numpy(), dev),
            d=_vec(ray.d.to_array().numpy(), dev), maxt=ray.maxt.to(dev)))
        cs.LAUNCHES.update(closest=0, anyhit=0)
        t, prim, _, valid = cs.intersect_cells(acc, r.o, r.d, r.maxt,
                                               active=mask)
        occ = cs.occluded_cells(acc, r.o, r.d, r.maxt, active=mask)
        out[str(dev)] = [x.cpu() for x in (t, prim, valid, occ, mask)]
        if dev == "cpu":
            continue
        assert cs.LAUNCHES["closest"] > 0 and cs.LAUNCHES["anyhit"] > 0
        og, dg = cs._grid_ray(acc, r.o, r.d)
        t_in, t_out, inv = cs._clip(acc, og, dg, r.maxt)
        slots, _, _ = cs._pairgen(acc, og, dg, inv, t_in, t_out,
                                  mask & (t_in <= t_out),
                                  torch.zeros_like(t_in))
        _, rays, r0, nr = cs.sort_pairs(acc, slots, r.o, r.d)
        assert r0.shape[0] > 0
        for want_uv in (True, False):
            kout = cs.serve_blocks(acc.tris, rays, r0, nr, want_uv)
            pout = cs.serve_blocks_plain(acc.tris, rays, r0, nr, want_uv)
            for k, p in zip(kout, pout):
                assert (k is None and p is None) or torch.equal(k, p)
    (tg, pg, vg, og_, mg), (tc, pc, vc, oc, mc) = out[str(cuda)], out["cpu"]
    assert torch.equal(mg, mc) and int(mc.sum()) > 100
    assert torch.equal(vg, vc) and torch.equal(og_, oc) and int(vc.sum()) > 50
    assert (pg[vc] == pc[vc]).float().mean() > 0.999
    assert torch.allclose(tg[vc], tc[vc], rtol=1e-5)


def test_instanced_analytic_render_on_card_matches_cpu(cuda, monkeypatch):
    """The small instanced field with analytic spheres, a cylinder, a disk,
    a cone set and an SDF blob added, at 32^2 on the card against the
    CPU: > 99.5 % of values close, means rtol 1e-3."""
    monkeypatch.setenv("MI3T_ACCEL", "cells")
    T = mt.ScalarTransform4f
    d = chip_smoke.instanced_field_dict(T, width=32, tiles=2, side=66,
                                        scatter=6)
    shapes = chip_smoke.analytic_terrain_dict(
        chip_smoke.small_terrain_dict, T, counts=(6, 2, 2), n_curves=1,
        tex_side=16)
    d.update({k: v for k, v in shapes.items()
              if k.split("_")[0] in ("sphere", "cylinder", "disk", "curve")})
    d["blob"] = chip_smoke.sdf_terrain_dict(
        chip_smoke.small_terrain_dict, T, side=16, size=1.5)["blob"]
    img_g = mt.render(mt.load_dict(d, device=cuda), seed=5,
                      spp=4).cpu().numpy()
    img_c = mt.render(mt.load_dict(d, device="cpu"), seed=5, spp=4).numpy()
    assert np.isfinite(img_g).all() and img_g.mean() > 0
    assert np.isclose(img_g, img_c, rtol=1e-3, atol=1e-3).mean() > 0.995
    assert np.allclose(img_g.mean(), img_c.mean(), rtol=1e-3)
