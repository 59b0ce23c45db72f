"""Port parity, the alternate accels (``MI3T_ACCEL=serve`` and ``tiled``):
the SAH builder and both accel builds are bit-equal to the JAX package's;
the plain versions of kernels K2 (cull), K3 (block serve) and K4 (tiled
round) agree with JAX's Pallas kernels run in interpret mode; the queries
agree with JAX's and with the dense oracle; the small terrain renders as
JAX renders it under each accel, also when carried over from JAX's
leaves; and the loader builds the accel MI3T_ACCEL names."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mitsuba3_tpu as mj
from mitsuba3_tpu import native as j_native
from mitsuba3_tpu.core.vec import Vec3 as JVec3
from mitsuba3_tpu.ops import bvh_serve as j_bs
from mitsuba3_tpu.ops import bvh_tiled as j_bt
from mitsuba3_tpu.ops.intersect import intersect_naive, occluded_naive

import chip_smoke
import mitsuba3_tpu_torch as mt
from mitsuba3_tpu_torch import native as t_native
from mitsuba3_tpu_torch.convert import arrays_from_scene, scene_from_arrays
from mitsuba3_tpu_torch.core.vec import Vec3 as TVec3
from mitsuba3_tpu_torch.ops import bvh_serve as t_bs
from mitsuba3_tpu_torch.ops import bvh_tiled as t_bt

torch.set_num_threads(1)
SEED, SPP = 5, 4
# barycentrics against JAX: XLA may contract the CPU interpreter's a*b+c
# into FMA, which moves u and v of a grazing hit by more than t; the
# edge-grazing tolerance of tests/test_bvh.py's oracle checks
UV_TOL = dict(atol=2e-3, rtol=0)
_PORT_RENDERS = {}


def port_render(accel, monkeypatch):
    """(image, rays) of the port's own 16^2 small terrain under `accel`,
    rendered once per module."""
    if accel not in _PORT_RENDERS:
        monkeypatch.setenv("MI3T_ACCEL", accel)
        scene = mt.load_dict(chip_smoke.small_terrain_dict(
            mt.ScalarTransform4f, width=16), device="cpu")
        assert type(scene.accel) is {"serve": t_bs.BVHServe,
                                     "tiled": t_bt.BVHTiled}[accel]
        img, rays = mt.render_with_stats(scene, seed=SEED, spp=SPP)
        _PORT_RENDERS[accel] = img.numpy(), rays
    return _PORT_RENDERS[accel]


def rand_tris(np_rng, n):
    """The random soup of tests/test_bvh.py."""
    base = np_rng.uniform(-2, 2, (n, 3)).astype(np.float32)
    e1 = np_rng.normal(0, 0.3, (n, 3)).astype(np.float32)
    e2 = np_rng.normal(0, 0.3, (n, 3)).astype(np.float32)
    return base, e1, e2


def rand_rays(np_rng, n_ray):
    o = np_rng.uniform(-4, 4, (n_ray, 3)).astype(np.float32)
    d = np_rng.normal(size=(n_ray, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    return o, d


def jvec(a):
    return JVec3(*(jnp.asarray(a[:, i]) for i in range(3)))


def tvec(a):
    return TVec3(*(torch.as_tensor(np.ascontiguousarray(a[:, i]))
                   for i in range(3)))


def terrain64k_padded():
    """terrain64k's triangles as the loader pads them (65,536 faces; the
    14 padding faces are degenerate at vertex 0)."""
    p0, e1, e2 = chip_smoke.make_terrain(int(np.sqrt(65536 / 2)) + 1)
    pad = 65536 - p0.shape[0]
    return (np.concatenate([p0, np.repeat(p0[:1], pad, 0)]),
            np.concatenate([e1, np.zeros((pad, 3), np.float32)]),
            np.concatenate([e2, np.zeros((pad, 3), np.float32)]))


def assert_fields_equal(t_acc, j_acc, arrays, statics):
    for name in arrays:
        np.testing.assert_array_equal(getattr(t_acc, name).numpy(),
                                      np.asarray(getattr(j_acc, name)),
                                      err_msg=name)
    for name in statics:
        assert getattr(t_acc, name) == getattr(j_acc, name), name


# ---------------------------------------------------------------------------
# Builds
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("builder", ["build_bvh", "build_bvh_numpy"])
def test_sah_builder_bit_equal(np_rng, builder):
    """The 3000-box set of tests/test_bvh.py."""
    n = 3000
    c = np_rng.uniform(-5, 5, (n, 3)).astype(np.float32)
    h = np_rng.uniform(0.01, 0.2, (n, 3)).astype(np.float32)
    got = getattr(t_native, builder)(c - h, c + h, 32)
    want = getattr(j_native, builder)(c - h, c + h, 32)
    assert len(got) == len(want) == 5
    for g, w in zip(got, want):
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("scene", ["soup", "terrain64k"])
def test_accel_builds_bit_equal(np_rng, scene):
    tris = rand_tris(np_rng, 2000) if scene == "soup" else terrain64k_padded()
    t_tiled = t_bt.build(*tris, device="cpu")
    assert_fields_equal(t_tiled, j_bt.build(*tris),
                        ("leaf_bounds", "tris", "prim", "scene_lo",
                         "scene_span"), ("n_leaves",))
    t_serve = t_bs.build(*tris, device="cpu")
    assert_fields_equal(t_serve, j_bs.build(*tris),
                        ("tris", "bounds", "sup"),
                        ("n_leaves", "m_pad", "topk"))
    if scene == "terrain64k":
        assert t_serve.n_leaves == 759 and t_serve.m_pad == 768
        assert tuple(t_serve.tris.shape) == (759, 16, 128)


def test_builds_raise_instead_of_falling_back(np_rng, monkeypatch):
    """A failed SAH build raises: the port has no median-split fallback."""
    def broken(*args):
        raise RuntimeError("mi_build_bvh failed")

    monkeypatch.setattr(t_native, "build_bvh", broken)
    tris = rand_tris(np_rng, 100)
    for build in (t_bt.build, t_bs.build):
        with pytest.raises(RuntimeError, match="mi_build_bvh"):
            build(*tris, device="cpu")
    with pytest.raises(ValueError, match="topk 3"):
        t_bs.build(*tris, topk=3, device="cpu")


# ---------------------------------------------------------------------------
# Plain kernels against JAX's Pallas kernels (interpret mode)
# ---------------------------------------------------------------------------

def _serve_accels(np_rng, topk, leaf_size=t_bs.K, n_tri=2000):
    tris = rand_tris(np_rng, n_tri)
    return (j_bs.build(*tris, leaf_size=leaf_size, topk=topk),
            t_bs.build(*tris, leaf_size=leaf_size, topk=topk, device="cpu"))


def _geo(np_rng, n):
    """[8, n] ray rows ox oy oz dx dy dz tb tb; a quarter of the rays have
    a short best t, and the last 16 are inert (tb -1)."""
    o, d = rand_rays(np_rng, n)
    tb = np.where(np.arange(n) % 4 == 0, 1.5, 3e38).astype(np.float32)
    tb[-16:] = -1.0
    return np.concatenate([o.T, d.T, tb[None], tb[None]]).astype(np.float32)


@pytest.mark.parametrize("topk", [1, 2])
def test_cull_plain_matches_jax(np_rng, topk):
    """Keys bit-equal, from the first cull and from a nonzero cursor, with
    8-triangle leaves so the leaves span several 128-leaf chunks."""
    j_acc, t_acc = _serve_accels(np_rng, topk, leaf_size=8)
    assert t_acc.m_pad // t_bs.LC >= 2
    geo = _geo(np_rng, 1024)
    lk0 = np.zeros((1, 1024), np.int32)
    first = np.asarray(j_bs._cull(j_acc, jnp.asarray(geo), jnp.asarray(lk0),
                                  True))
    got = t_bs.cull_plain(t_acc, torch.as_tensor(geo),
                          torch.as_tensor(lk0[0]))
    np.testing.assert_array_equal(got.numpy(), first)
    # resume: half the rays have visited their nearest leaf
    lk = np.where((np.arange(1024) % 2 == 0) & (first[0] != t_bs.NONE),
                  first[0], 0).astype(np.int32)[None]
    want = np.asarray(j_bs._cull(j_acc, jnp.asarray(geo), jnp.asarray(lk),
                                 True))
    got = t_bs.cull_plain(t_acc, torch.as_tensor(geo), torch.as_tensor(lk[0]))
    np.testing.assert_array_equal(got.numpy(), want)
    assert (want[0] != t_bs.NONE).sum() > 100
    assert not np.array_equal(want, first)


def _first_serve(acc, geo):
    """(blk_ids, rays, leaf_all): the first block serve's arguments of a
    query of the rays `geo` (as _geo makes them)."""
    n = geo.shape[1]
    f = torch.zeros((9, n))
    f[:7] = torch.as_tensor(geo[:7])
    i = torch.zeros((3, n), dtype=torch.int32)
    i[t_bs.PRIM] = -1
    i[t_bs.RID] = torch.arange(n, dtype=torch.int32)
    best = t_bs.cull_plain(acc, f, i[t_bs.LK])
    live = (best[0] != t_bs.NONE) & (i[t_bs.RID] >= 0)
    f, i, leaf_all, _, _ = t_bs.sort_requests(acc, f, i, best, live)
    return t_bs.block_ids(acc, leaf_all), torch.cat([f[:7], f[6:7]]), leaf_all


@pytest.mark.parametrize("topk", [1, 2])
def test_serve_blocks_plain_matches_jax(np_rng, topk):
    """The first block serve of a query: t within rtol 1e-5 of JAX's,
    prim, u, v and the served-rank bits equal."""
    j_acc, t_acc = _serve_accels(np_rng, topk)
    blk, rays, leaf_all = _first_serve(t_acc, _geo(np_rng, 1024))
    got = t_bs.serve_blocks_plain(t_acc, blk, rays, leaf_all)
    want = j_bs._serve_blocks(j_acc, jnp.asarray(blk.numpy().reshape(-1)),
                              jnp.asarray(rays.numpy()),
                              jnp.asarray(leaf_all.numpy()), True)
    t, prim, u, v, srv = (x.numpy() for x in got)
    jt, jp, ju, jv, js = (np.asarray(x) for x in want)
    np.testing.assert_array_equal(srv, js)
    assert (srv != 0).sum() > 256
    np.testing.assert_array_equal(t >= t_bs.BIG, jt >= t_bs.BIG)
    hit = jt < t_bs.BIG
    assert hit.sum() > 10
    np.testing.assert_allclose(t[hit], jt[hit], rtol=1e-5, atol=0)
    np.testing.assert_array_equal(prim, jp)
    np.testing.assert_allclose(u[hit], ju[hit], **UV_TOL)
    np.testing.assert_allclose(v[hit], jv[hit], **UV_TOL)


def _tiled_round(np_rng, n_tiles):
    """(triangles, accel, run_round's arguments but `closest`) of the
    first 16-slot round of a tiled query over `n_tiles` tiles of the
    soup, maxt 3."""
    tris = rand_tris(np_rng, 2000)
    acc = t_bt.build(*tris, device="cpu")
    o, d = rand_rays(np_rng, n_tiles * t_bt.TILE)
    maxt = torch.full((o.shape[0],), 3.0)
    (ox, oy, oz, dx, dy, dz, mt_s), _ = t_bt._pack_sorted(
        acc, tvec(o), tvec(d), maxt)
    ids_s, ents_s = t_bt._sort_leaf_lists(
        t_bt._tile_leaf_lists(acc, ox, oy, oz, dx, dy, dz, mt_s))
    n = mt_s.shape[0]
    zeros = torch.zeros(n)
    return tris, acc, (ids_s[:, :t_bt.LB_USE].contiguous(),
                       ents_s[:, :t_bt.LB_USE].contiguous(), acc.tris,
                       torch.stack([ox, oy, oz]), torch.stack([dx, dy, dz]),
                       mt_s, torch.full((n,), -1, dtype=torch.int32), zeros,
                       zeros)


@pytest.mark.parametrize("closest", [True, False], ids=["closest", "anyhit"])
def test_run_round_plain_matches_jax(np_rng, closest):
    """The first 16-slot round of a tiled query over 8 tiles."""
    (p0, e1, e2), t_acc, args = _tiled_round(np_rng, 8)
    j_acc = j_bt.build(p0, e1, e2)
    leaf_ids, entries, _, o3, d3, mt_s, prim0, zeros, _ = args
    got = t_bt.run_round_plain(*args, closest)
    pad = j_bt.LB - t_bt.LB_USE
    want = j_bt._run_round(
        jnp.asarray(np.pad(leaf_ids.numpy(), ((0, 0), (0, pad)),
                           constant_values=-1)),
        jnp.asarray(np.pad(entries.numpy(), ((0, 0), (0, pad)),
                           constant_values=3.4e38)),
        j_acc.tris, jnp.asarray(o3.numpy()), jnp.asarray(d3.numpy()),
        jnp.asarray(mt_s.numpy()), jnp.asarray(prim0.numpy()),
        jnp.asarray(zeros.numpy()), jnp.asarray(zeros.numpy()), closest,
        interpret=True)
    t, prim = got[0].numpy(), got[1].numpy()
    jt, jp = np.asarray(want[0]), np.asarray(want[1])
    hit = jp >= 0
    assert hit.sum() > 100
    np.testing.assert_array_equal(prim, jp)
    np.testing.assert_allclose(t, jt, rtol=1e-5, atol=0)
    if closest:
        np.testing.assert_allclose(got[2].numpy()[hit],
                                   np.asarray(want[2])[hit], **UV_TOL)
        np.testing.assert_allclose(got[3].numpy()[hit],
                                   np.asarray(want[3])[hit], **UV_TOL)


# a floor at z = 1 over [-2, 2]^2 in two halves, and a nearer step at
# z = 0.5 over [-1, 1]^2: every coordinate is dyadic, so a ray from z = -1
# along +z hits at t = 2 (floor) or 1.5 (step) with exact u and v, and
# rays on the diagonal x + y = 0 hit both floor halves at t = 2
FLOOR_LO = ([-2.0, -2.0, 1.0], [4.0, 0.0, 0.0], [0.0, 4.0, 0.0])
FLOOR_HI = ([2.0, 2.0, 1.0], [-4.0, 0.0, 0.0], [0.0, -4.0, 0.0])
STEP = ([-1.0, -1.0, 0.5], [2.0, 0.0, 0.0], [0.0, 2.0, 0.0])
# per leaf, {column: (triangle, prim id)}: leaf 0 holds the floor's lower
# half three times (ids 10, 30, 5: equal t, the largest id wins) and the
# step, with empty slots between; leaf 1 the floor again (a later slot
# wins at equal t); leaf 2 real up to column 127
TIE_LEAVES = ({0: (FLOOR_LO, 10), 1: (FLOOR_HI, 11), 20: (STEP, 7),
               50: (FLOOR_LO, 30), 90: (FLOOR_LO, 5)},
              {0: (FLOOR_LO, 20), 1: (FLOOR_HI, 21)},
              {33: (FLOOR_LO, 40), 127: (STEP, 3)})
# per tile, (leaf slots, entries): slot orders that make the tie rules
# matter, empty slots, and in tile 6 (whose rays all hit the floor) an
# entry of 2.5 that the worst t of 2 skips, then one of 2.0 that it takes
TIE_SLOTS = (([0], [0.0]), ([0, 1], [0.0, 0.0]), ([1, 0], [0.0, 0.0]),
             ([2, 0, 1], [0.0] * 3), ([-1, 1, -1, 0], [0.0] * 4),
             ([0, 1], [0.0, 2.5]), ([1, 0, 1, 2], [0.0, 2.5, 2.0, 0.0]),
             ([2, 1, 0], [0.0] * 3))


def k4_tie_round():
    """run_round's arguments but `closest`, as numpy arrays, of a round of
    8 tiles over TIE_LEAVES and TIE_SLOTS. Rays start at z = -1 on a
    32 x 32 grid along +z (tile 6's grid inside the floor); per tile,
    every 7th ray is inactive (t -1), every 11th has a previous hit at
    t 1.5 (prim 99), every 13th a maxt of 1; the last tile has 700 rays
    and padding (t -1) after them."""
    tile = t_bt.TILE
    tris = np.zeros((len(TIE_LEAVES), 16, t_bt.KT), np.float32)
    tris[:, 9] = -1.0
    for leaf, cols in enumerate(TIE_LEAVES):
        for col, ((p0, e1, e2), pid) in cols.items():
            tris[leaf, 0:3, col], tris[leaf, 3:6, col] = p0, e1
            tris[leaf, 6:9, col], tris[leaf, 9, col] = e2, pid
    n_tiles = len(TIE_SLOTS)
    leaf_ids = np.full((n_tiles, t_bt.LB_USE), -1, np.int32)
    entries = np.full((n_tiles, t_bt.LB_USE), t_bt.BIG, np.float32)
    for i, (ids, ents) in enumerate(TIE_SLOTS):
        leaf_ids[i, :len(ids)], entries[i, :len(ents)] = ids, ents
    g = (np.arange(32) + 0.5) * (9.0 / 64.0) - 2.25     # dyadic, |x| < 2.25
    x, y = (a.reshape(-1) for a in np.meshgrid(g, g, indexing="ij"))
    o3 = np.zeros((3, n_tiles, tile), np.float32)
    o3[0], o3[1], o3[2] = x, y, -1.0
    o3[:2, 6] *= 0.5                                    # inside the floor
    d3 = np.zeros((3, n_tiles, tile), np.float32)
    d3[2] = 1.0
    k = np.arange(tile)
    t = np.full((n_tiles, tile), 3e38, np.float32)
    prim = np.full((n_tiles, tile), -1, np.int32)
    u = np.zeros((n_tiles, tile), np.float32)
    t[:, k % 11 == 0], prim[:, k % 11 == 0] = 1.5, 99
    u[:, k % 11 == 0] = 0.25
    t[:, k % 13 == 0] = 1.0
    t[:, k % 7 == 0] = -1.0
    o3[:, -1, 700:] = 0.0
    t[-1, 700:] = -1.0
    return (leaf_ids, entries, tris, o3.reshape(3, -1), d3.reshape(3, -1),
            t.reshape(-1), prim.reshape(-1), u.reshape(-1),
            u.reshape(-1) * 0.5)


@pytest.mark.parametrize("closest", [True, False], ids=["closest", "anyhit"])
def test_run_round_plain_tie_rules_equal_jax(closest):
    """K4's tie rules, which the kernel must keep: inside a leaf the
    smallest t wins and equal ts go to the largest prim id; across slots a
    later hit at equal t replaces the best; t == best is a hit. The plain
    version gives JAX's Pallas kernel's (interpret mode) t, prim, u and v
    (any-hit: t and prim) exactly."""
    args = k4_tie_round()
    got = t_bt.run_round_plain(*(torch.as_tensor(a) for a in args), closest)
    pad = j_bt.LB - t_bt.LB_USE
    leaf_ids, entries = args[:2]
    want = j_bt._run_round(
        jnp.asarray(np.pad(leaf_ids, ((0, 0), (0, pad)), constant_values=-1)),
        jnp.asarray(np.pad(entries, ((0, 0), (0, pad)),
                           constant_values=3.4e38)),
        *(jnp.asarray(a) for a in args[2:]), closest, interpret=True)
    # JAX's any-hit kernel leaves its u and v outputs unwritten
    for name, g, w in list(zip("t prim u v".split(), got, want))[
            :4 if closest else 2]:
        np.testing.assert_array_equal(g.numpy(), np.asarray(w), err_msg=name)
    t, prim = (x.numpy().reshape(len(TIE_SLOTS), -1) for x in got[:2])
    if not closest:
        assert (prim == 1).any() and (t == -1.0).any()
        return
    # the rules at work: the lower floor half hit through leaf 0 alone goes
    # to id 30; a later slot of leaf 1 takes it to 20, a later leaf 0 back
    # to 30; the step (t 1.5) wins where it covers the ray
    for tile, ids in ((0, {30, 11, 7}), (1, {20, 21, 7}), (2, {30, 11, 7})):
        hit = prim[tile][(prim[tile] >= 0) & (prim[tile] != 99)]
        assert set(hit.tolist()) == ids, tile
    assert ((t == 2.0) & (prim == 30)).any()
    assert ((t == 1.5) & (prim == 7)).any()


def _cull_work_by_ray(acc, geo, lk):
    """K2's needed box tests counted ray by ray in numpy, from the leaf
    boxes (not the accel's union boxes); a ray with cursor NONE or best t
    <= 0 needs none."""
    lb = acc.bounds[:6, :acc.n_leaves].numpy()
    d = geo[3:6]
    inv = 1.0 / np.where(np.abs(d) < 1e-9, np.where(d < 0, -1e-9, 1e-9),
                         d).astype(np.float32)
    busy = (lk != t_bs.NONE) & (geo[6] > 0)
    n_chunks = acc.m_pad // t_bs.LC
    want = {"sup_tests": n_chunks * int(busy.sum()), "box_tests": 0,
            "chunks_taken": 0, "warps_taken": 0}
    for c in range(n_chunks):
        seg = lb[:, c * t_bs.LC:(c + 1) * t_bs.LC]
        t0 = (seg[:3].min(axis=1)[:, None] - geo[:3]) * inv
        t1 = (seg[3:].max(axis=1)[:, None] - geo[:3]) * inv
        tn = np.minimum(t0, t1).max(axis=0)
        tf = np.maximum(t0, t1).min(axis=0)
        enters = busy & (tn <= tf) & (np.maximum(tn, 0.0) < geo[6])
        want["box_tests"] += int(enters.sum()) * seg.shape[1]
        want["chunks_taken"] += int(
            enters.reshape(-1, t_bs.RCHUNK).any(axis=1).sum())
        want["warps_taken"] += int(enters.reshape(-1, 32).any(axis=1).sum())
    return want


def _serve_work_by_block(blk, leaf_all, tris):
    """K3's needed tests counted block by block: per ray and distinct slab
    of its block that the ray requests, the slab's triangles with an id
    >= 0."""
    real = (tris[:, 9].numpy() >= 0).sum(axis=1)
    lanes = leaf_all.numpy().reshape(leaf_all.shape[0], blk.shape[0], -1)
    n = 0
    for b, ids in enumerate(blk.numpy()):
        for j, lid in enumerate(ids):
            if lid not in ids[:j]:
                n += int((lanes[:, b] == lid).any(axis=0).sum()) * int(
                    real[lid])
    return {"tests": n}


def _tiled_work_by_slot(args, closest):
    """K4's needed work counted slot by slot: per taken slot, a test of
    each triangle with an id >= 0 for every ray with t >= 0, or in any-hit
    mode its leading misses and its first hit. The state between slots
    comes from one-slot rounds."""
    leaf_ids, entries, tris, o3, d3 = args[:5]
    state = args[5:]
    want = {"slots": 0, "tests": 0}
    for s in range(t_bt.LB_USE):
        t_s = state[0].reshape(-1, t_bt.TILE)
        taken = (leaf_ids[:, s] >= 0) & (entries[:, s] <= t_s.amax(dim=1))
        for tile in torch.nonzero(taken)[:, 0].tolist():
            lanes = slice(tile * t_bt.TILE, (tile + 1) * t_bt.TILE)
            tt, _, _, ok = t_bt._mt_slabs(
                tris[leaf_ids[tile, s].long()][None],
                tuple(x[None, None, lanes] for x in o3),
                tuple(x[None, None, lanes] for x in d3))
            hit = (ok & (tt >= 0.0) & (tt <= t_s[tile]))[0]   # [KT, TILE]
            real = int((tris[leaf_ids[tile, s].long(), 9] >= 0).sum())
            n = torch.full((t_bt.TILE,), real)
            if not closest:
                misses = (hit.cumsum(dim=0) == 0).sum(dim=0)
                n = torch.clamp(misses + 1, max=real)
            want["slots"] += 1
            want["tests"] += int(n[t_s[tile] >= 0.0].sum())
        state = t_bt.run_round_plain(
            leaf_ids[:, s:s + 1].contiguous(),
            entries[:, s:s + 1].contiguous(), tris, o3, d3, *state, closest)
    return want


@pytest.mark.parametrize("kernel", ["cull", "serve", "closest", "anyhit"])
def test_plain_work_counts(np_rng, kernel):
    """The work the plain versions count for the kernels' bounds equals a
    count made ray by ray, block by block or slot by slot."""
    work = {}
    if kernel == "cull":
        # inert rays: every 3rd cursor NONE, a whole block of them, and
        # _geo's 16 rays with tb -1
        _, acc = _serve_accels(np_rng, 1, leaf_size=8)
        geo = _geo(np_rng, 2048)
        lk = np.zeros(2048, np.int32)
        lk[::3] = t_bs.NONE
        lk[512:1024] = t_bs.NONE
        t_bs.cull_plain(acc, torch.as_tensor(geo), torch.as_tensor(lk),
                        stats=work)
        want = _cull_work_by_ray(acc, geo, lk)
        assert 0 < want["box_tests"] < 1024 * acc.n_leaves
        assert want["warps_taken"] < 32 * want["chunks_taken"]
    elif kernel == "serve":
        _, acc = _serve_accels(np_rng, 2)
        blk, rays, leaf_all = _first_serve(acc, _geo(np_rng, 1024))
        t_bs.serve_blocks_plain(acc, blk, rays, leaf_all, stats=work)
        want = _serve_work_by_block(blk, leaf_all, acc.tris)
        assert want["tests"] > 0
    else:
        closest = kernel == "closest"
        _, _, args = _tiled_round(np_rng, 2)
        args[5][-100:] = -1.0    # inactive lanes need no test
        t_bt.run_round_plain(*args, closest, stats=work)
        want = _tiled_work_by_slot(args, closest)
        assert 0 < want["tests"] < want["slots"] * t_bt.TILE * t_bt.KT
    assert work == want


@pytest.mark.parametrize("closest", [True, False], ids=["closest", "anyhit"])
@pytest.mark.parametrize("topk", [1, 2])
def test_rounds_give_finished_rays_none_cursors(np_rng, topk, closest):
    """After each round every ray that was not live carries the cursor
    NONE, and the next cull (whose kernel skips such rays) returns NONE for
    it, as it does from the cursor the ray had."""
    _, acc = _serve_accels(np_rng, topk, leaf_size=8)
    o, d = rand_rays(np_rng, 4000)
    maxt = torch.as_tensor(np.where(np.arange(4000) % 5 == 0, 1.0, 1e30)
                           .astype(np.float32))
    f, i = t_bs.initial_state(tvec(o), tvec(d), maxt)
    best, live = t_bs._cull_state(acc, f, i)
    n_done = 0
    for _ in range(4):
        done_ids = i[t_bs.RID][~live]
        lk_before = dict(zip(i[t_bs.RID].tolist(), i[t_bs.LK].tolist()))
        f, i = t_bs._round_once(acc, f, i, best, live, int(live.sum()),
                                closest)
        done = torch.isin(i[t_bs.RID], done_ids)
        assert bool((i[t_bs.LK][done] == t_bs.NONE).all())
        n_done = max(n_done, int(done.sum()))
        best, live = t_bs._cull_state(acc, f, i)
        assert bool((best[:, done] == t_bs.NONE).all())
        assert not bool(live[done].any())
        old = torch.tensor([lk_before[r] for r in i[t_bs.RID].tolist()],
                           dtype=torch.int32)
        assert bool((t_bs.cull_plain(acc, f, old)[:, done]
                     == t_bs.NONE).all())
    assert n_done > 512


def test_tiled_coherence_key_equals_jax(np_rng):
    p0, e1, e2 = rand_tris(np_rng, 500)
    o, d = rand_rays(np_rng, 4096)
    d[:8] = [0.0, 0.0, -1.0]
    want = np.asarray(j_bt._coherence_key(j_bt.build(p0, e1, e2), jvec(o),
                                          jvec(d)))
    got = t_bt._coherence_key(t_bt.build(p0, e1, e2, device="cpu"), tvec(o),
                              tvec(d))
    np.testing.assert_array_equal(got.numpy(), want)


# ---------------------------------------------------------------------------
# Queries
# ---------------------------------------------------------------------------

QUERY_CASES = {"serve_topk1": (t_bs, j_bs, 1), "serve_topk2": (t_bs, j_bs, 2),
               "tiled": (t_bt, j_bt, None)}


@pytest.mark.parametrize("case", sorted(QUERY_CASES))
def test_queries_match_jax_and_oracle(np_rng, case):
    """test_serve_matches_oracle's soup and rays: closest hit and any-hit
    equal JAX's accel and the dense oracle; a maxt short of every hit
    finds no occluder; inactive lanes never hit."""
    t_mod, j_mod, topk = QUERY_CASES[case]
    p0, e1, e2 = rand_tris(np_rng, 2000)
    kw = {} if topk is None else {"topk": topk}
    j_acc = j_mod.build(p0, e1, e2, **kw)
    t_acc = t_mod.build(p0, e1, e2, device="cpu", **kw)
    o, d = rand_rays(np_rng, 1024)
    n = o.shape[0]
    jo, jd, to, td = jvec(o), jvec(d), tvec(o), tvec(d)
    p0v, e1v, e2v = (JVec3.from_array(jnp.asarray(x)) for x in (p0, e1, e2))
    maxt = np.full(n, 1e30, np.float32)

    t0, p_0, uv0, v0 = (np.asarray(x) if not hasattr(x, "x") else x
                        for x in intersect_naive(jo, jd, jnp.asarray(maxt),
                                                 p0v, e1v, e2v))
    tj, pj, _, vj = (np.asarray(x) if not hasattr(x, "x") else x
                     for x in j_mod.intersect_bvh(j_acc, jo, jd,
                                                  jnp.asarray(maxt)))
    tt, pt, uvt, vt = t_mod.intersect_bvh(t_acc, to, td,
                                          torch.as_tensor(maxt))
    vt = vt.numpy()
    assert (vt == v0).all() and (vt == vj).all()
    sel = v0
    assert sel.sum() > 100
    np.testing.assert_array_equal(pt.numpy()[sel], p_0[sel])
    np.testing.assert_array_equal(pt.numpy()[sel], pj[sel])
    np.testing.assert_allclose(tt.numpy()[sel], t0[sel], rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(tt.numpy()[sel], tj[sel], rtol=1e-5, atol=0)
    np.testing.assert_allclose(uvt.x.numpy()[sel], np.asarray(uv0.x)[sel],
                               atol=2e-3)
    np.testing.assert_allclose(uvt.y.numpy()[sel], np.asarray(uv0.y)[sel],
                               atol=2e-3)

    two = np.full(n, 2.0, np.float32)
    occ_t = t_mod.occluded_bvh(t_acc, to, td, torch.as_tensor(two)).numpy()
    occ_0 = np.asarray(occluded_naive(jo, jd, jnp.asarray(two), p0v, e1v,
                                      e2v))
    occ_j = np.asarray(j_mod.occluded_bvh(j_acc, jo, jd, jnp.asarray(two)))
    assert (occ_t == occ_0).all() and (occ_t == occ_j).all()
    short = np.where(v0, t0 * 0.9, 1e30).astype(np.float32)
    assert not t_mod.occluded_bvh(t_acc, to, td,
                                  torch.as_tensor(short)).numpy()[sel].any()
    act = torch.as_tensor(np.arange(n) % 2 == 0)
    v3 = t_mod.intersect_bvh(t_acc, to, td, torch.as_tensor(maxt),
                             active=act)[3].numpy()
    assert not v3[~act.numpy()].any()
    assert (v3[act.numpy()] == v0[act.numpy()]).all()


@pytest.mark.parametrize("topk", [1, 2])
def test_serve_block_path_matches_oracle(np_rng, topk):
    """16,384 rays: wider than the gather-serve width, so the rounds run
    the block serve (K3's plain version) and the width ladder."""
    p0, e1, e2 = rand_tris(np_rng, 2000)
    acc = t_bs.build(p0, e1, e2, topk=topk, device="cpu")
    o, d = rand_rays(np_rng, 16384)
    n = o.shape[0]
    calls = []
    plain = t_bs.serve_blocks_plain

    def counting(*args):
        calls.append(1)
        return plain(*args)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(t_bs, "serve_blocks_plain", counting)
        tt, pt, _, vt = t_bs.intersect_bvh(acc, tvec(o), tvec(d), 1e30)
    assert calls
    p0v, e1v, e2v = (JVec3.from_array(jnp.asarray(x)) for x in (p0, e1, e2))
    t0, p_0, _, v0 = (np.asarray(x) if not hasattr(x, "x") else x
                      for x in intersect_naive(jvec(o), jvec(d),
                                               jnp.full(n, 1e30), p0v, e1v,
                                               e2v))
    assert (vt.numpy() == v0).all()
    np.testing.assert_array_equal(pt.numpy()[v0], p_0[v0])
    np.testing.assert_allclose(tt.numpy()[v0], t0[v0], rtol=1e-4, atol=1e-5)


def test_cpu_tensors_take_the_plain_path(np_rng, monkeypatch):
    """On CPU tensors the wrappers of K2, K3 and K4 run their plain
    versions and no launch is counted; a tensor on another device is
    refused, never served by a plain version."""
    p0, e1, e2 = rand_tris(np_rng, 2000)
    o, d = rand_rays(np_rng, 16384)
    monkeypatch.setattr(t_bs, "LAUNCHES", {"cull": 0, "serve": 0})
    monkeypatch.setattr(t_bt, "LAUNCHES", {"closest": 0, "anyhit": 0})
    s_acc = t_bs.build(p0, e1, e2, device="cpu")
    b_acc = t_bt.build(p0, e1, e2, device="cpu")
    t_bs.intersect_bvh(s_acc, tvec(o), tvec(d), 1e30)
    t_bt.intersect_bvh(b_acc, tvec(o[:2048]), tvec(d[:2048]), 1e30)
    t_bt.occluded_bvh(b_acc, tvec(o[:2048]), tvec(d[:2048]), 2.0)
    assert t_bs.LAUNCHES == {"cull": 0, "serve": 0}
    assert t_bt.LAUNCHES == {"closest": 0, "anyhit": 0}
    meta = torch.empty((9, 512), device="meta")
    lk = torch.zeros(512, dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="CUDA"):
        t_bs.cull(s_acc, meta, lk)
    with pytest.raises(ValueError, match="CUDA"):
        t_bs.serve_blocks(s_acc, torch.zeros((4, 2), dtype=torch.int32),
                          meta, lk[None])
    with pytest.raises(ValueError, match="CUDA"):
        t_bt.run_round(torch.zeros((1, 16), dtype=torch.int32),
                       torch.zeros((1, 16)), b_acc.tris,
                       torch.empty((3, 1024), device="meta"),
                       torch.empty((3, 1024), device="meta"),
                       torch.empty(1024, device="meta"),
                       torch.empty(1024, dtype=torch.int32, device="meta"),
                       torch.empty(1024, device="meta"),
                       torch.empty(1024, device="meta"), True)


# ---------------------------------------------------------------------------
# Renders and the loader
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module", params=["serve", "tiled"])
def jax_render(request):
    """(accel, jax image, jax rays, jax scene) of the 16^2 small terrain."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("MI3T_ACCEL", request.param)
        scene = mj.load_dict(chip_smoke.small_terrain_dict(
            mj.ScalarTransform4f, width=16))
    img, rays = mj.render_with_stats(scene, seed=SEED, spp=SPP)
    return request.param, np.asarray(img), float(rays), scene


def test_small_terrain_render_matches_jax(jax_render, monkeypatch):
    accel, img_j, rays_j, _ = jax_render
    img_t, rays_t = port_render(accel, monkeypatch)
    assert img_t.shape == img_j.shape == (16, 16, 3)
    assert np.isfinite(img_t).all() and img_t.max() > 0
    assert np.isclose(img_t, img_j, rtol=1e-3, atol=1e-3).mean() > 0.995
    assert np.allclose(img_t.mean(), img_j.mean(), rtol=1e-3)
    assert abs(rays_t - rays_j) <= 1e-3 * rays_j


def test_render_from_jax_leaves_matches_port(jax_render, monkeypatch):
    """The JAX scene's accel leaves carried into the port render the same
    image as the port's own load_dict."""
    accel, img_j, _, j_scene = jax_render
    arrays, meta = arrays_from_scene(j_scene)
    assert meta["accel"]["kind"] == accel
    carried = scene_from_arrays(arrays, meta, device="cpu")
    assert type(carried.accel).__name__ == {"serve": "BVHServe",
                                            "tiled": "BVHTiled"}[accel]
    img_c, rays_c = mt.render_with_stats(carried, seed=SEED, spp=SPP)
    img_o, rays_o = port_render(accel, monkeypatch)
    assert rays_c == rays_o
    assert np.isclose(img_c.numpy(), img_o, rtol=1e-3,
                      atol=1e-3).mean() > 0.995
    assert np.isclose(img_c.numpy(), img_j, rtol=1e-3,
                      atol=1e-3).mean() > 0.995


def test_loader_rejects_unknown_accel(monkeypatch):
    monkeypatch.setenv("MI3T_ACCEL", "octree")
    d = chip_smoke.small_terrain_dict(mt.ScalarTransform4f, width=8)
    with pytest.raises(ValueError, match="unknown accel 'octree'"):
        mt.load_dict(d, device="cpu")


@pytest.mark.parametrize("accel,cls", [("auto", "BVHXLA"),
                                       ("cells", "CellServe"),
                                       ("serve", "BVHServe"),
                                       ("tiled", "BVHTiled"),
                                       ("xla", "BVHXLA"),
                                       ("grid", "GridAccel"),
                                       ("none", "NoneType")])
def test_loader_builds_the_named_accel(monkeypatch, accel, cls):
    """On a CPU device; ``auto`` is ``xla`` there, as in JAX."""
    monkeypatch.setenv("MI3T_ACCEL", accel)
    d = chip_smoke.small_terrain_dict(mt.ScalarTransform4f, width=8)
    assert type(mt.load_dict(d, device="cpu").accel).__name__ == cls
