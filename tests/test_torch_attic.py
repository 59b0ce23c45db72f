"""Port parity, the attic intersectors (``ops/attic``: bvh_pallas, bvh_queue,
bvh2) and the dense oracle (``ops/intersect.py``): the builds are
bit-equal to the JAX package's; the plain versions of kernels K5
(traversal), K6 (cull), K7 (serve-multi) and K8 (supernode serve) agree
with JAX's Pallas kernels run in interpret mode; the host steps (schedule
simulation, supernode cull, coherence key) are bit-equal; each accel's
queries agree with JAX's and with the dense oracle; an accel carried over
from JAX's leaves answers as the port's own build; and CPU tensors never
reach a kernel launch."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

import chip_smoke
from mitsuba3_tpu.core.vec import Vec3 as JVec3
from mitsuba3_tpu.ops import intersect as j_is
from mitsuba3_tpu.ops.attic import bvh2 as j_b2
from mitsuba3_tpu.ops.attic import bvh_pallas as j_bp
from mitsuba3_tpu.ops.attic import bvh_queue as j_bq

from mitsuba3_tpu_torch import convert
from mitsuba3_tpu_torch.core.vec import Vec3 as TVec3
from mitsuba3_tpu_torch.ops import bvh_serve as t_bs
from mitsuba3_tpu_torch.ops import intersect as t_is
from mitsuba3_tpu_torch.ops import native
from mitsuba3_tpu_torch.ops.attic import bvh2 as t_b2
from mitsuba3_tpu_torch.ops.attic import bvh_pallas as t_bp
from mitsuba3_tpu_torch.ops.attic import bvh_queue as t_bq

torch.set_num_threads(1)
# barycentrics against JAX: XLA may contract the CPU interpreter's a*b+c
# into FMA, which moves u and v of a grazing hit by more than t; the
# edge-grazing tolerance of tests/test_bvh.py's oracle checks
UV_TOL = dict(atol=2e-3, rtol=0)


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


def assert_fields_equal(t_acc, j_acc, arrays, statics):
    for name in arrays:
        np.testing.assert_array_equal(getattr(t_acc, name).numpy(),
                                      np.asarray(getattr(j_acc, name)),
                                      err_msg=name)
    for name in statics:
        assert getattr(t_acc, name) == getattr(j_acc, name), name


def assert_hits_agree(t, prim, valid, jt, jp, jv, rtol=1e-5, uv=None):
    """tests/test_bvh.py:243-253's rule: valid equal; prim equal on
    >= 99.9 % of hits, t within rtol there; where prim differs (an
    edge-grazing sliver), t no farther."""
    t, prim, valid = (np.asarray(x) for x in (t, prim, valid))
    jt, jp, jv = (np.asarray(x) for x in (jt, jp, jv))
    np.testing.assert_array_equal(valid, jv)
    sel = jv
    assert sel.sum() > 50
    same = prim[sel] == jp[sel]
    assert same.mean() >= 0.999
    np.testing.assert_allclose(t[sel][same], jt[sel][same], rtol=rtol,
                               atol=1e-5 if rtol > 1e-5 else 0)
    assert (t[sel][~same] <= jt[sel][~same] + 1e-4).all()
    if uv is not None:
        for a, b in zip(uv[0], uv[1]):
            np.testing.assert_allclose(np.asarray(a)[sel][same],
                                       np.asarray(b)[sel][same], **UV_TOL)


# ---------------------------------------------------------------------------
# Builds
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("scene", ["soup", "terrain"])
def test_attic_builds_bit_equal(np_rng, scene):
    """bench_bvh's terrain is make_terrain(182), 65,522 triangles, not
    padded."""
    tris = (rand_tris(np_rng, 2000) if scene == "soup"
            else chip_smoke.make_terrain(182))
    t_p = t_bp.build(*tris, device="cpu")
    assert_fields_equal(t_p, j_bp.build(*tris),
                        ("node_bounds", "node_meta", "tris", "prim_order"),
                        ("n_leaves",))
    t_2 = t_b2.build(*tris, device="cpu")
    assert_fields_equal(t_2, j_b2.build(*tris), ("bounds", "tris"),
                        ("n_nodes",))
    if scene == "terrain":
        assert t_p.n_leaves == 757 and t_p.node_bounds.shape[0] == 1513
        assert t_p.tris.shape == (757, 16, 128)
        assert t_2.n_nodes == 3022 and t_2.tris.shape == (3022, 10, 32)


def test_chip_smoke_rays_are_bench_bvhs():
    """chip_smoke.py's numpy copies of bench_bvh's terrain and rays."""
    from benchmarks import bench_bvh
    for got, want in zip(chip_smoke.make_terrain(40),
                         bench_bvh.make_terrain(40)):
        np.testing.assert_array_equal(got, want)
    for kind in ("primary", "bounce"):
        for got, want in zip(chip_smoke.make_rays(4096, 1, kind),
                             bench_bvh.make_rays(4096, 1, kind)):
            np.testing.assert_array_equal(got, want)


# ---------------------------------------------------------------------------
# The dense oracle
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("case", ["one_chunk", "chunks", "active"])
def test_naive_matches_jax(np_rng, monkeypatch, case):
    """One chunk (200 triangles; t is BIG on a miss), four chunks of 256
    with the rays in steps of 300 (t is maxt on a miss), and an active
    mask; a third of the rays have maxt 2."""
    n_tri = 200 if case == "one_chunk" else 1024
    p0, e1, e2 = rand_tris(np_rng, n_tri)
    o, d = rand_rays(np_rng, 1024)
    maxt = np.where(np.arange(1024) % 3 == 0, 2.0, 1e30).astype(np.float32)
    act = np.arange(1024) % 2 == 0 if case == "active" else None
    if case != "one_chunk":
        monkeypatch.setattr(t_is, "RAY_CHUNK", 300)
        monkeypatch.setattr(t_is, "STEP_ELEMS", 0)   # steps of RAY_CHUNK
    jargs = (jvec(o), jvec(d), jnp.asarray(maxt), jvec(p0), jvec(e1),
             jvec(e2))
    targs = (tvec(o), tvec(d), torch.as_tensor(maxt), tvec(p0), tvec(e1),
             tvec(e2))
    jkw = {} if act is None else {"active": jnp.asarray(act)}
    tkw = {} if act is None else {"active": torch.as_tensor(act)}
    jt, jp, juv, jv = j_is.intersect_naive(*jargs, **jkw)
    t, p, uv, v = t_is.intersect_naive(*targs, **tkw)
    assert_hits_agree(t, p, v, jt, jp, jv,
                      uv=((uv.x, uv.y), (juv.x, juv.y)))
    miss = ~np.asarray(jv)
    np.testing.assert_array_equal(t.numpy()[miss], np.asarray(jt)[miss])
    if act is not None:
        assert not v.numpy()[~act].any()
    occ = t_is.occluded_naive(*targs, **tkw).numpy()
    np.testing.assert_array_equal(occ, np.asarray(
        j_is.occluded_naive(*jargs, **jkw)))
    assert 50 < occ.sum() < 1024


# ---------------------------------------------------------------------------
# Plain kernels against JAX's Pallas kernels (interpret mode)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("closest", [True, False], ids=["closest", "anyhit"])
def test_traverse_plain_matches_jax(np_rng, closest):
    """K5 on two tiles: the soup's rays, and the same rays with maxt 1.5
    and 100 inactive lanes (maxt -1)."""
    tris = rand_tris(np_rng, 2000)
    j_acc = j_bp.build(*tris)
    t_acc = t_bp.build(*tris, device="cpu")
    o, d = rand_rays(np_rng, 1024)
    o, d = np.concatenate([o, o]), np.concatenate([d, d])
    maxt = np.full(2048, 3e38, np.float32)
    maxt[1024:] = 1.5
    maxt[1024:1124] = -1.0
    o3, d3, mt = t_bp.pack_rays(tvec(o), tvec(d), torch.as_tensor(maxt))
    t, slot, u, v = t_bp.traverse_plain(t_acc, o3, d3, mt, closest)
    jt, js, ju, jv = (np.asarray(x)[0] for x in j_bp._run(
        j_acc.node_bounds, j_acc.node_meta, j_acc.tris,
        jnp.asarray(o3.numpy()), jnp.asarray(d3.numpy()),
        jnp.asarray(mt.numpy()[None]), closest, interpret=True))
    hit = js >= 0
    assert 200 < hit.sum() < 2048
    np.testing.assert_array_equal(slot.numpy(), js)
    np.testing.assert_allclose(t.numpy(), jt, rtol=1e-5, atol=0)
    if closest:
        np.testing.assert_allclose(u.numpy()[hit], ju[hit], **UV_TOL)
        np.testing.assert_allclose(v.numpy()[hit], jv[hit], **UV_TOL)
    else:
        assert (u.numpy() == 0).all() and (v.numpy() == 0).all()
    assert not hit[1024:1124].any()


@pytest.mark.parametrize("closest", [True, False], ids=["closest", "anyhit"])
def test_traverse_plain_tiles_walk_alone(np_rng, monkeypatch, closest):
    """Each tile's walk, results and counted work are its own: stepping
    the tiles one at a time gives what stepping four in lockstep gives."""
    tris = rand_tris(np_rng, 2000)
    acc = t_bp.build(*tris, device="cpu")
    o, d = rand_rays(np_rng, 4 * t_bp.TILE)
    o3, d3, mt = t_bp.pack_rays(tvec(o), tvec(d), torch.full((len(o),), 3.0))
    runs = []
    for tiles in (4, 1):
        monkeypatch.setattr(t_bp, "PLAIN_TILES", tiles)
        work = {}
        runs.append((t_bp.traverse_plain(acc, o3, d3, mt, closest,
                                         stats=work), work))
    (a, wa), (b, wb) = runs
    assert all(torch.equal(x, y) for x, y in zip(a, b))
    assert wa == wb and 0 < wa["tests"] < wa["leaves"] * t_bp.TILE * t_bp.K
    assert wa["box_tests"] == wa["nodes"] * t_bp.TILE


@pytest.mark.parametrize("closest", [True, False], ids=["closest", "anyhit"])
def test_traverse_plain_tile_work(np_rng, closest):
    """traverse_plain's per-tile node visits and tests sum to its totals,
    and each tile's entries are what that tile counts walking alone."""
    tris = rand_tris(np_rng, 2000)
    acc = t_bp.build(*tris, device="cpu")
    o, d = rand_rays(np_rng, 3 * t_bp.TILE)
    # the tiles differ: tile 1's rays start far off, half the lanes of
    # tile 2 are inactive
    o[t_bp.TILE:2 * t_bp.TILE] += 50.0
    maxt = np.repeat(np.float32([3.0, 3e38, 3e38]), t_bp.TILE)
    maxt[::5] = -1.0
    maxt[2 * t_bp.TILE::2] = -1.0
    o3, d3, mt = t_bp.pack_rays(tvec(o), tvec(d), torch.as_tensor(maxt))
    work = {}
    t_bp.traverse_plain(acc, o3, d3, mt, closest, stats=work)
    assert len(work["tile_tests"]) == len(work["tile_nodes"]) == 3
    assert sum(work["tile_tests"]) == work["tests"] > 0
    assert sum(work["tile_nodes"]) == work["nodes"]
    assert len(set(work["tile_tests"])) == 3
    for k in range(3):
        lanes = slice(k * t_bp.TILE, (k + 1) * t_bp.TILE)
        alone = {}
        t_bp.traverse_plain(acc, o3[:, lanes], d3[:, lanes], mt[lanes],
                            closest, stats=alone)
        assert alone["tile_tests"] == [work["tile_tests"][k]]
        assert alone["tile_nodes"] == [work["tile_nodes"][k]]
        assert alone["tile_nodes"] == [alone["nodes"]]


@pytest.mark.parametrize("tiles, slots, want", [
    ([1.0, 1.0, 4.0], 2, 5.0),            # launch order: 4 waits for a 1
    ([4.0, 1.0, 1.0], 2, 4.0),            # heaviest first
    ([3.0, 3.0, 2.0, 2.0, 2.0], 2, 7.0),
    ([2.0, 5.0], 4, 5.0),                 # more slots than tiles
])
def test_chip_smoke_makespan(tiles, slots, want):
    """chip_smoke.py's tile makespan: each tile, in order, goes to the slot
    that frees first."""
    assert chip_smoke._makespan(tiles, slots) == want


def _serve_accels(np_rng, leaf_size=t_bs.K):
    tris = rand_tris(np_rng, 2000)
    return (j_bq.build(*tris, leaf_size=leaf_size),
            t_bq.build(*tris, leaf_size=leaf_size, device="cpu"))


def _geo(np_rng, n):
    """[8, n] ray rows ox oy oz dx dy dz tb tb; a quarter of the rays have
    a short best t, and the last 16 are inert (tb -1)."""
    o, d = rand_rays(np_rng, n)
    tb = np.where(np.arange(n) % 4 == 0, 1.5, 3e38).astype(np.float32)
    tb[-16:] = -1.0
    return np.concatenate([o.T, d.T, tb[None], tb[None]]).astype(np.float32)


def test_cull_topk_plain_matches_jax(np_rng):
    """K6 keys bit-equal, from a zero cursor and from a nonzero one, with
    8-triangle leaves so the leaves span several 128-leaf chunks."""
    j_acc, t_acc = _serve_accels(np_rng, leaf_size=8)
    assert t_acc.m_pad // t_bs.LC >= 2
    geo = _geo(np_rng, 1024)
    lk0 = np.zeros(1024, np.int32)
    first = np.asarray(j_bq._cull_topk(j_acc, jnp.asarray(geo),
                                       jnp.asarray(lk0[None]), True))
    got = t_bq.cull_topk_plain(t_acc, torch.as_tensor(geo),
                               torch.as_tensor(lk0))
    np.testing.assert_array_equal(got.numpy(), first)
    assert (first[t_bq.KQ - 1] != t_bs.NONE).sum() > 100
    # resume: half the rays have visited their first three leaves
    lk = np.where((np.arange(1024) % 2 == 0) & (first[2] != t_bs.NONE),
                  first[2], 0).astype(np.int32)
    want = np.asarray(j_bq._cull_topk(j_acc, jnp.asarray(geo),
                                      jnp.asarray(lk[None]), True))
    got = t_bq.cull_topk_plain(t_acc, torch.as_tensor(geo),
                               torch.as_tensor(lk))
    np.testing.assert_array_equal(got.numpy(), want)
    assert not np.array_equal(want, first)


def _schedule(acc, geo):
    """The first serve cycle's state of a queue query of the rays `geo`:
    (f, i) sorted by queue head, and simulate's (lids, q_after, lk_pop)."""
    n = geo.shape[1]
    f = torch.zeros((9, n))
    f[:7] = torch.as_tensor(geo[:7])
    i = torch.full((3 + t_bq.KQ, n), t_bs.NONE, dtype=torch.int32)
    i[t_bs.PRIM] = -1
    i[t_bs.LK] = 0
    i[t_bs.RID] = torch.arange(n, dtype=torch.int32)
    f, i = t_bq.sort_by_head(acc, f, t_bq.fresh_cull(acc, f, i))
    return f, i, t_bq.simulate(i[t_bq.Q0:], f[t_bs.TB])


def test_simulate_bit_equal(np_rng):
    j_acc, t_acc = _serve_accels(np_rng, leaf_size=32)
    f, i, (lids, q_after, lk_pop) = _schedule(t_acc, _geo(np_rng, 1024))
    want = j_bq._simulate(jnp.asarray(i[t_bq.Q0:].numpy()),
                          jnp.asarray(f[t_bs.TB].numpy()))
    for got, w in zip((lids, q_after, lk_pop), want):
        np.testing.assert_array_equal(got.numpy(), np.asarray(w))
    assert (lids >= 0).sum() > 64 and (lk_pop > 0).sum() > 128


def test_serve_multi_plain_matches_jax(np_rng):
    """K7 on a `simulate` schedule: t within rtol 1e-5 of JAX's, misses
    (BIG) and prim equal."""
    j_acc, t_acc = _serve_accels(np_rng)
    f, _, (lids, _, _) = _schedule(t_acc, _geo(np_rng, 512))
    t, prim, u, v = (x.numpy() for x in t_bq.serve_multi_plain(t_acc, lids,
                                                               f))
    rays = np.concatenate([f[:7].numpy(), f[6:7].numpy()])
    jt, jp, ju, jv = (np.asarray(x) for x in j_bq._serve_multi(
        j_acc, jnp.asarray(lids.numpy()), jnp.asarray(rays), True))
    hit = jp >= 0
    assert hit.sum() > 30
    np.testing.assert_array_equal(prim, jp)
    np.testing.assert_array_equal(t[~hit], jt[~hit])
    np.testing.assert_allclose(t[hit], jt[hit], rtol=1e-5, atol=0)
    np.testing.assert_allclose(u[hit], ju[hit], **UV_TOL)
    np.testing.assert_allclose(v[hit], jv[hit], **UV_TOL)


def _bvh2_serve_args(np_rng, acc, c=16):
    """K8 arguments on `c` chunks of soup rays: per chunk 4 distinct
    supernode ids (real ones, and in some chunks NONE or an id past the
    table, as the cull's padding supernodes give), each lane wanting one
    of them or none; tbest 3e38, or 1.5 on a quarter of the lanes."""
    o, d = rand_rays(np_rng, c * t_b2.CHUNK)
    ids = np.stack([np.sort(np_rng.choice(acc.n_nodes, 4, replace=False))
                    for _ in range(c)]).astype(np.int32)
    ids[::3, 3] = acc.n_nodes + 5
    ids[1::4, 2:] = t_b2.NONE_ID
    pick = np_rng.integers(0, 5, (c, t_b2.CHUNK))
    want = np.where(pick < 4, np.take_along_axis(ids, np.minimum(pick, 3),
                                                 axis=1), t_b2.NONE_ID)
    # a lane that wants a supernode aims at one of its triangles from 2
    # away, within about 30 degrees of its normal (no grazing hits)
    w = want.reshape(-1)
    real = np.nonzero(w < acc.n_nodes)[0]
    rows = acc.tris.numpy()[w[real], :, np_rng.integers(0, t_b2.LEAF,
                                                        len(real))]
    nrm = np.cross(rows[:, 3:6], rows[:, 6:9])
    nrm /= np.maximum(np.linalg.norm(nrm, axis=1, keepdims=True), 1e-12)
    dr = nrm + 0.5 * d[real]
    dr /= np.linalg.norm(dr, axis=1, keepdims=True)
    d[real] = dr
    target = rows[:, 0:3] + 0.25 * rows[:, 3:6] + 0.25 * rows[:, 6:9]
    o[real] = target - 2.0 * dr
    tb = np.where(np.arange(c * t_b2.CHUNK) % 4 == 0, 1.5, 3e38)
    rays = np.stack([*o.T, *d.T, np.zeros(len(tb)), tb]).astype(np.float32)
    rays = rays.reshape(8, c, t_b2.CHUNK).transpose(1, 0, 2)
    return (torch.as_tensor(ids), torch.as_tensor(np.ascontiguousarray(rays)),
            torch.as_tensor(want.astype(np.int32)))


def _jax_serve_kernel(j_acc, ids, rays, want):
    """bvh2._serve_kernel in interpret mode, with _serve_pallas's grid
    spec and its gather of the served blocks."""
    c = ids.shape[0]
    blocks = jnp.take(j_acc.tris, jnp.where(ids == t_b2.NONE_ID, 0, ids),
                      axis=0)
    o_spec = pl.BlockSpec((1, 1, t_b2.CHUNK), lambda i, ids: (i, 0, 0),
                          memory_space=pltpu.VMEM)
    grid_spec = pltpu.PrefetchScalarGridSpec(
        num_scalar_prefetch=1, grid=(c,),
        in_specs=[
            pl.BlockSpec((1, t_b2.N_SERVE, 10, t_b2.LEAF),
                         lambda i, ids: (i, 0, 0, 0),
                         memory_space=pltpu.VMEM),
            pl.BlockSpec((1, 8, t_b2.CHUNK), lambda i, ids: (i, 0, 0),
                         memory_space=pltpu.VMEM),
            pl.BlockSpec((1, 1, t_b2.CHUNK), lambda i, ids: (i, 0, 0),
                         memory_space=pltpu.VMEM)],
        out_specs=[o_spec] * 4)
    shape = (c, 1, t_b2.CHUNK)
    outs = pl.pallas_call(
        j_b2._serve_kernel, grid_spec=grid_spec, interpret=True,
        out_shape=[jax.ShapeDtypeStruct(shape, jnp.float32),
                   jax.ShapeDtypeStruct(shape, jnp.int32),
                   jax.ShapeDtypeStruct(shape, jnp.float32),
                   jax.ShapeDtypeStruct(shape, jnp.float32)],
    )(ids, blocks, rays, want[:, None, :])
    return [x[:, 0] for x in outs]


def _jax_serve_xla(j_acc, ids, rays, want):
    """bvh2._trace's serve on other backends: _mt_block per served id."""
    tcs = rays[:, 7]
    tn = jnp.full_like(tcs, j_b2.BIG)
    pn = jnp.full(tcs.shape, -1, jnp.int32)
    un = jnp.zeros_like(tcs)
    vn = jnp.zeros_like(tcs)
    for k in range(t_b2.N_SERVE):
        sid = ids[:, k]
        ok_chunk = sid != t_b2.NONE_ID
        blk = jnp.take(j_acc.tris, jnp.where(ok_chunk, sid, 0), axis=0)
        tk, pk, uk, vk = j_b2._mt_block(blk, *(rays[:, a] for a in range(6)),
                                        tcs)
        lane = (want == sid[:, None]) & ok_chunk[:, None]
        tn = jnp.where(lane, tk, tn)
        pn = jnp.where(lane, pk, pn)
        un = jnp.where(lane, uk, un)
        vn = jnp.where(lane, vk, vn)
    return tn, pn, un, vn


@pytest.mark.parametrize("branch", ["pallas", "xla"])
def test_serve_plain_matches_jax(np_rng, branch):
    """K8 against the Pallas kernel and against JAX's XLA branch."""
    tris = rand_tris(np_rng, 2000)
    j_acc = j_b2.build(*tris)
    t_acc = t_b2.build(*tris, device="cpu")
    ids, rays, want = _bvh2_serve_args(np_rng, t_acc)
    fn = _jax_serve_kernel if branch == "pallas" else _jax_serve_xla
    jt, jp, ju, jv = (np.asarray(x) for x in fn(
        j_acc, jnp.asarray(ids.numpy()), jnp.asarray(rays.numpy()),
        jnp.asarray(want.numpy())))
    t, p, u, v = (x.numpy() for x in t_b2.serve_plain(t_acc, ids, rays,
                                                      want))
    hit = jp >= 0
    assert hit.sum() > 50
    np.testing.assert_array_equal(p, jp)
    np.testing.assert_array_equal(t[~hit], jt[~hit])
    np.testing.assert_allclose(t[hit], jt[hit], rtol=1e-5, atol=0)
    np.testing.assert_allclose(u[hit], ju[hit], **UV_TOL)
    np.testing.assert_allclose(v[hit], jv[hit], **UV_TOL)


@pytest.mark.parametrize("edit", ["permuted", "repeated"])
def test_serve_plain_served_order_free(np_rng, edit):
    """What K8's one test pass per lane rests on: a lane's result depends
    only on whether its id is served, not on the slot or how often.
    "permuted": each chunk's served ids in a random order give the same
    outputs; "repeated": one slot holding a copy of another slot's id
    gives the outputs of that slot holding NONE. Both equal JAX's Pallas
    kernel (interpret mode) on the edited ids."""
    tris = rand_tris(np_rng, 2000)
    j_acc = j_b2.build(*tris)
    t_acc = t_b2.build(*tris, device="cpu")
    ids, rays, want = _bvh2_serve_args(np_rng, t_acc)
    c = ids.shape[0]
    if edit == "permuted":
        edited = ids.gather(1, torch.as_tensor(np.stack(
            [np_rng.permutation(t_b2.N_SERVE) for _ in range(c)])))
        assert not torch.equal(edited, ids)
        ref = ids
    else:
        src = np_rng.integers(0, t_b2.N_SERVE, c)
        dst = (src + np_rng.integers(1, t_b2.N_SERVE, c)) % t_b2.N_SERVE
        rows = torch.arange(c)
        edited, ref = ids.clone(), ids.clone()
        edited[rows, dst] = ids[rows, src]
        ref[rows, dst] = t_b2.NONE_ID
    got = t_b2.serve_plain(t_acc, edited, rays, want)
    for name, g, w in zip("t prim u v".split(), got,
                          t_b2.serve_plain(t_acc, ref, rays, want)):
        assert torch.equal(g, w), name
    hit = got[1] >= 0
    assert hit.sum() > 50
    if edit == "repeated":
        # the overwritten slots held ids that some lanes hit
        assert not torch.equal(hit, t_b2.serve_plain(t_acc, ids, rays,
                                                     want)[1] >= 0)
    jt, jp, ju, jv = (np.asarray(x) for x in _jax_serve_kernel(
        j_acc, jnp.asarray(edited.numpy()), jnp.asarray(rays.numpy()),
        jnp.asarray(want.numpy())))
    t, p, u, v = (x.numpy() for x in got)
    np.testing.assert_array_equal(p, jp)
    jhit = jp >= 0
    np.testing.assert_array_equal(t[~jhit], jt[~jhit])
    np.testing.assert_allclose(t[jhit], jt[jhit], rtol=1e-5, atol=0)
    np.testing.assert_allclose(u[jhit], ju[jhit], **UV_TOL)
    np.testing.assert_allclose(v[jhit], jv[jhit], **UV_TOL)


@pytest.mark.parametrize("kernel", ["queue_serve", "bvh2_serve"])
def test_attic_plain_work_counts(np_rng, kernel):
    """The ray-triangle tests that K7's and K8's plain versions count for
    the kernels' bounds equal a count made slot by slot: per slab and lane
    that takes it, the slab's triangles with an id >= 0 (the padding after
    them never hits)."""
    work = {}
    if kernel == "queue_serve":
        _, acc = _serve_accels(np_rng)
        f, _, (lids, _, _) = _schedule(acc, _geo(np_rng, 512))
        t_bq.serve_multi_plain(acc, lids, f, stats=work)
        # a lane's bound stays >= 0 from the start, as hits have t >= 0
        live = (f[t_bs.TB] >= 0).reshape(-1, t_bs.BLK).sum(dim=1).numpy()
        want = {"slots": 0, "tests": 0}
        real = (acc.tris[:, 9] >= 0).sum(dim=1).numpy()
        for b, row in enumerate(lids.numpy()):
            for lid in row[row >= 0]:
                want["slots"] += 1
                want["tests"] += int(live[b]) * int(real[lid])
        assert (real < t_bq.K).any()
    else:
        acc = t_b2.build(*rand_tris(np_rng, 2000), device="cpu")
        ids, rays, wanted = _bvh2_serve_args(np_rng, acc)
        t_b2.serve_plain(acc, ids, rays, wanted, stats=work)
        want = {"lanes": 0, "tests": 0}
        real = (acc.tris[:, 9] >= 0).sum(dim=1).numpy()
        for c, row in enumerate(ids.numpy()):
            # NONE_ID and the padding ids lie past the table
            for sid in row[row < acc.n_nodes]:
                n = int((wanted[c].numpy() == sid).sum())
                want["lanes"] += n
                want["tests"] += n * int(real[sid])
        assert (real < t_b2.LEAF).any()
    assert want["tests"] > 0
    assert work == want


# ---------------------------------------------------------------------------
# Host steps, bit-equal
# ---------------------------------------------------------------------------

def test_chip_smoke_k8_recorder(np_rng):
    """chip_smoke._k8_recorded, whose launches the card replays to time K8
    a query: the query's result is unchanged, each round's serve
    arguments are kept once, in order, and bvh2.serve is restored."""
    acc = t_b2.build(*rand_tris(np_rng, 2000), device="cpu")
    o, d = rand_rays(np_rng, 1024)
    args = (acc, tvec(o), tvec(d), torch.full((1024,), 1e30))
    serve = t_b2.serve
    got, launched = chip_smoke._k8_recorded(t_b2.intersect_bvh, *args)
    assert t_b2.serve is serve
    want = t_b2.intersect_bvh(*args)
    for g, w in zip((got[0], got[1], got[2].x, got[2].y),
                    (want[0], want[1], want[2].x, want[2].y)):
        assert torch.equal(g, w)
    calls = []
    t_b2.serve = lambda *a: calls.append(a) or serve(*a)
    try:
        t_b2.intersect_bvh(*args)
    finally:
        t_b2.serve = serve
    assert len(launched) == len(calls) > 1
    for (ids, rays, want_ids), call in zip(launched, calls):
        assert torch.equal(ids, call[1]) and torch.equal(want_ids, call[3])
        assert torch.equal(rays, call[2])


def test_bvh2_cull_topk_bit_equal(np_rng):
    """Keys and rest_min; a quarter of the rays have maxt 1, 16 have -1."""
    tris = rand_tris(np_rng, 2000)
    j_acc = j_b2.build(*tris)
    t_acc = t_b2.build(*tris, device="cpu")
    o, d = rand_rays(np_rng, 1024)
    d[:8] = [0.0, 0.0, -1.0]
    mt = np.where(np.arange(1024) % 4 == 0, 1.0, 3e38).astype(np.float32)
    mt[-16:] = -1.0
    jp, jr = j_b2._cull_topk(j_acc, *(jnp.asarray(a) for a in (*o.T, *d.T)),
                             jnp.asarray(mt))
    tp, tr = t_b2.cull_topk(t_acc, *(torch.as_tensor(np.ascontiguousarray(a))
                                     for a in (*o.T, *d.T)),
                            torch.as_tensor(mt))
    np.testing.assert_array_equal(tp.numpy(), np.asarray(jp).astype(np.int64))
    np.testing.assert_array_equal(tr.numpy(), np.asarray(jr))
    assert (tr.numpy() < t_b2.BIG).sum() > 100


def test_pallas_coherence_key_bit_equal(np_rng):
    tris = rand_tris(np_rng, 500)
    o, d = rand_rays(np_rng, 4096)
    d[:8] = [0.0, 0.0, -1.0]
    want = np.asarray(j_bp._coherence_key(j_bp.build(*tris), jvec(o),
                                          jvec(d)))
    got = t_bp._coherence_key(t_bp.build(*tris, device="cpu"), tvec(o),
                              tvec(d))
    np.testing.assert_array_equal(got.numpy(), want.astype(np.int32))
    assert len(np.unique(want)) > 100


# ---------------------------------------------------------------------------
# Queries
# ---------------------------------------------------------------------------

# case -> (port module, JAX module, rays, closest-hit name, any-hit name)
QUERY_CASES = {
    "bvh2": (t_b2, j_b2, 1024, "intersect_bvh", "occluded_bvh"),
    "queue": (t_bq, j_bq, 512, "intersect_bvh", "occluded_bvh"),
    "pallas": (t_bp, j_bp, 1024, "intersect_bvh", "occluded_bvh"),
    "pallas_sorted": (t_bp, j_bp, 1024, "intersect_bvh_sorted",
                      "occluded_bvh_sorted"),
}


@pytest.mark.parametrize("case", sorted(QUERY_CASES))
def test_queries_match_jax(np_rng, case):
    """Closest hit and any-hit (maxt 2) equal JAX's, by the edge-grazing
    rule; a maxt short of every hit finds no occluder; inactive lanes
    never hit."""
    t_mod, j_mod, n, closest, anyhit = QUERY_CASES[case]
    tris = rand_tris(np_rng, 2000)
    j_acc = j_mod.build(*tris)
    t_acc = t_mod.build(*tris, device="cpu")
    o, d = rand_rays(np_rng, n)
    maxt = np.full(n, 1e30, np.float32)
    two = np.full(n, 2.0, np.float32)
    jt, jp, juv, jv = getattr(j_mod, closest)(j_acc, jvec(o), jvec(d),
                                              jnp.asarray(maxt))
    jocc = np.asarray(getattr(j_mod, anyhit)(j_acc, jvec(o), jvec(d),
                                             jnp.asarray(two)))
    t, p, uv, v = getattr(t_mod, closest)(t_acc, tvec(o), tvec(d),
                                          torch.as_tensor(maxt))
    if case == "bvh2":
        # jitted on the CPU, JAX's bvh2 misses hits that its eager run
        # (jax.disable_jit, half a minute here) and the dense oracle find
        # (ROADMAP queue 3): the port keeps every JAX hit, never farther,
        # and is held to the dense oracle (the port's, which
        # test_naive_matches_jax holds to JAX's; it saves two XLA compiles)
        jv = np.asarray(jv)
        assert (v.numpy() >= jv).all()
        assert (t.numpy()[jv] <= np.asarray(jt)[jv] + 1e-4).all()
        jt, jp, juv, jv = t_is.intersect_naive(
            tvec(o), tvec(d), torch.as_tensor(maxt), *(tvec(x) for x in tris))
    assert_hits_agree(t, p, v, jt, jp, jv,
                      uv=((uv.x, uv.y), (juv.x, juv.y)))
    occ = getattr(t_mod, anyhit)(t_acc, tvec(o), tvec(d),
                                 torch.as_tensor(two)).numpy()
    if case == "bvh2":
        assert (occ >= jocc).all()
        jocc = t_is.occluded_naive(tvec(o), tvec(d), torch.as_tensor(two),
                                   *(tvec(x) for x in tris)).numpy()
    np.testing.assert_array_equal(occ, jocc)
    valid = v.numpy()
    short = np.where(valid, t.numpy() * 0.9, 1e30).astype(np.float32)
    assert not getattr(t_mod, anyhit)(t_acc, tvec(o), tvec(d),
                                      torch.as_tensor(short)).numpy()[
                                          valid].any()
    act = np.arange(n) % 2 == 0
    v3 = getattr(t_mod, closest)(t_acc, tvec(o), tvec(d),
                                 torch.as_tensor(maxt),
                                 active=torch.as_tensor(act))[3].numpy()
    assert not v3[~act].any()
    np.testing.assert_array_equal(v3[act], valid[act])


def test_queue_wide_path_matches_oracle(np_rng, monkeypatch):
    """16,384 rays: wider than the gather serve, so the cycles run K7's
    plain version and the width ladder; held against JAX's dense oracle
    (JAX's own queue at this width takes a minute in interpret mode)."""
    tris = rand_tris(np_rng, 2000)
    acc = t_bq.build(*tris, device="cpu")
    o, d = rand_rays(np_rng, 16384)
    n = o.shape[0]
    calls = []
    plain = t_bq.serve_multi_plain

    def counting(*args):
        calls.append(1)
        return plain(*args)

    monkeypatch.setattr(t_bq, "serve_multi_plain", counting)
    t, p, _, v = t_bq.intersect_bvh(acc, tvec(o), tvec(d), 1e30)
    assert calls
    p0v, e1v, e2v = (jvec(x) for x in tris)
    jt, jp, _, jv = j_is.intersect_naive(jvec(o), jvec(d), jnp.full(n, 1e30),
                                         p0v, e1v, e2v)
    assert_hits_agree(t, p, v, jt, jp, jv, rtol=1e-4)


@pytest.mark.parametrize("case", ["pallas", "bvh2", "queue"])
def test_carried_accel_answers_as_port_build(np_rng, case):
    """JAX's accel leaves, carried over with accel_arrays /
    accel_from_arrays, answer the queries as the port's own build does."""
    t_mod, j_mod = {"pallas": (t_bp, j_bp), "bvh2": (t_b2, j_b2),
                    "queue": (t_bq, j_bq)}[case]
    tris = rand_tris(np_rng, 2000)
    arrays, meta = convert.accel_arrays(j_mod.build(*tris))
    assert meta["kind"] == {"queue": "serve"}.get(case, case)
    carried = convert.accel_from_arrays(arrays, meta, device="cpu")
    own = t_mod.build(*tris, device="cpu")
    assert type(carried) is type(own)
    o, d = rand_rays(np_rng, 512)
    for fn, maxt in (("intersect_bvh", 1e30), ("occluded_bvh", 2.0)):
        got = getattr(t_mod, fn)(carried, tvec(o), tvec(d), maxt)
        want = getattr(t_mod, fn)(own, tvec(o), tvec(d), maxt)
        for g, w in zip(got if fn == "intersect_bvh" else (got,),
                        want if fn == "intersect_bvh" else (want,)):
            if hasattr(g, "x"):
                g, w = torch.stack([g.x, g.y]), torch.stack([w.x, w.y])
            assert torch.equal(g, w)
    if case != "queue":
        with pytest.raises(NotImplementedError, match="attic"):
            convert.scene_from_arrays({}, {"accel": meta}, device="cpu")


def test_cpu_tensors_never_launch(np_rng, monkeypatch):
    """On CPU tensors the wrappers of K5-K8 run their plain versions and
    never reach a launch; a tensor on another device is refused, never
    served by a plain version."""
    def refuse(*args, **kwargs):
        raise AssertionError("a CPU query reached native.launch")

    monkeypatch.setattr(native, "launch", refuse)
    tris = rand_tris(np_rng, 2000)
    o, d = rand_rays(np_rng, 8200)
    for mod in (t_bp, t_bq, t_b2):
        monkeypatch.setattr(mod, "LAUNCHES", dict.fromkeys(mod.LAUNCHES, 0))
        acc = mod.build(*tris, device="cpu")
        n = 8200 if mod is t_bq else 1024   # the queue's K6/K7 path
        mod.intersect_bvh(acc, tvec(o[:n]), tvec(d[:n]), 1e30)
        mod.occluded_bvh(acc, tvec(o[:1024]), tvec(d[:1024]), 2.0)
        assert all(v == 0 for v in mod.LAUNCHES.values())
    meta = torch.empty((9, 512), device="meta")
    lk = torch.zeros(512, dtype=torch.int32, device="meta")
    s_acc = t_bq.build(*tris, device="cpu")
    with pytest.raises(ValueError, match="CUDA"):
        t_bq.cull_topk(s_acc, meta, lk)
    with pytest.raises(ValueError, match="CUDA"):
        t_bq.serve_multi(s_acc, torch.zeros((4, t_bq.T), dtype=torch.int32),
                         meta)
    p_acc = t_bp.build(*tris, device="cpu")
    with pytest.raises(ValueError, match="CUDA"):
        t_bp.traverse(p_acc, torch.empty((3, 1024), device="meta"),
                      torch.empty((3, 1024), device="meta"),
                      torch.empty(1024, device="meta"), True)
    b_acc = t_b2.build(*tris, device="cpu")
    with pytest.raises(ValueError, match="CUDA"):
        t_b2.serve(b_acc, torch.zeros((1, 4), dtype=torch.int32),
                   torch.empty((1, 8, 128), device="meta"),
                   torch.zeros((1, 128), dtype=torch.int32))
