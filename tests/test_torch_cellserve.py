"""Port parity, cellserve accel: the host build is bit-equal to the JAX
package's, and closest-hit / any-hit queries agree with JAX's cellserve on
the CPU (JAX's reference serve; the port's plain version of kernel K1).
Also the serve's own rules: the per-sub-block windows cover every pair's
cell, the tie rule keeps the first row and column reaching the minimum,
and a CPU tensor never launches the kernel."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mitsuba3_tpu.core.vec import Vec3 as JVec3
from mitsuba3_tpu.ops import cellserve as j_cs

import chip_smoke
from mitsuba3_tpu_torch.convert import pack_occupancy
from mitsuba3_tpu_torch.core.vec import Vec3 as TVec3
from mitsuba3_tpu_torch.ops import cellserve as t_cs

torch.set_num_threads(1)


def rand_tris(np_rng, n):
    """The random soup of tests/test_bvh.py."""
    base = np_rng.uniform(-2, 2, (n, 3)).astype(np.float32)
    e1 = np_rng.normal(0, 0.3, (n, 3)).astype(np.float32)
    e2 = np_rng.normal(0, 0.3, (n, 3)).astype(np.float32)
    return base, e1, e2


def rand_rays(np_rng, n_ray=1024):
    """The rays of tests/test_bvh.py's cellserve test: random, a block of
    axis-aligned ones and a block starting deep inside the geometry."""
    o = np_rng.uniform(-4, 4, (n_ray, 3)).astype(np.float32)
    d = np_rng.normal(size=(n_ray, 3)).astype(np.float32)
    d[:64] = 0.0
    d[0:64:3, 0] = 1.0
    d[1:64:3, 1] = -1.0
    d[2:64:3, 2] = 1.0
    o[64:128] = np_rng.uniform(-0.5, 0.5, (64, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    return o, d


def jvec(a):
    return JVec3(*(jnp.asarray(a[:, i]) for i in range(3)))


def tvec(a):
    return TVec3(*(torch.as_tensor(np.ascontiguousarray(a[:, i]))
                   for i in range(3)))


def assert_build_equal(j_acc, t_acc):
    np.testing.assert_array_equal(t_acc.tris.numpy(), np.asarray(j_acc.tris))
    np.testing.assert_array_equal(t_acc.start.numpy(),
                                  np.asarray(j_acc.start))
    occ_bytes = np.asarray(np.asarray(j_acc.occ_bytes, np.float32), np.uint8)
    np.testing.assert_array_equal(
        pack_occupancy(t_acc.occ.numpy(), occ_bytes.shape[0]), occ_bytes)
    np.testing.assert_array_equal(t_acc.lo.numpy(), np.asarray(j_acc.lo))
    np.testing.assert_array_equal(t_acc.inv_cell.numpy(),
                                  np.asarray(j_acc.inv_cell))
    for name in ("res", "n_tris", "pair_slots", "max_steps"):
        assert getattr(t_acc, name) == getattr(j_acc, name), name


@pytest.mark.parametrize("pair_slots", [8, 2])
def test_build_bit_equal_random_soup(np_rng, pair_slots):
    p0, e1, e2 = rand_tris(np_rng, 2000)
    # degenerate faces (padding) are dropped by both builds
    e1[:5] = 0.0
    assert_build_equal(j_cs.build(p0, e1, e2, pair_slots=pair_slots),
                       t_cs.build(p0, e1, e2, pair_slots=pair_slots,
                                  device="cpu"))


def test_build_bit_equal_terrain64k():
    p0, e1, e2 = chip_smoke.make_terrain(int(np.sqrt(65536 / 2)) + 1)
    assert p0.shape[0] == 65522
    t_acc = t_cs.build(p0, e1, e2, device="cpu")
    assert_build_equal(j_cs.build(p0, e1, e2), t_acc)
    assert t_acc.res == 16 and tuple(t_acc.tris.shape) == (1318, 16, 128)


@pytest.mark.parametrize("pad_min", ["64", "16"])
def test_build_bit_equal_pad_min(monkeypatch, pad_min):
    """MI3T_CELLS_PAD_MIN, which JAX's build reads, and the port's build's
    pad_min: the small interior (8,624 faces, res 8) has cells above and
    below 16 and 64 triangles, and the aligned CSR equals JAX's at either
    threshold."""
    monkeypatch.setenv("MI3T_CELLS_PAD_MIN", pad_min)
    p0, e1, e2 = chip_smoke.make_interior(9000)
    t_acc = t_cs.build(p0, e1, e2, device="cpu", pad_min=int(pad_min))
    assert_build_equal(j_cs.build(p0, e1, e2), t_acc)
    counts = np.diff(t_acc.start.numpy()[:-1])
    assert (counts >= int(pad_min)).any() and (
        (counts > 0) & (counts < int(pad_min))).any()


@pytest.mark.parametrize("pair_slots", [8, 2])
def test_queries_match_jax(np_rng, pair_slots):
    """intersect_cells / occluded_cells against JAX's on the CPU, with the
    tolerances of tests/test_bvh.py (pair_slots=2 forces the overflow and
    resume rounds)."""
    p0, e1, e2 = rand_tris(np_rng, 2000)
    o, d = rand_rays(np_rng)
    n = o.shape[0]
    j_acc = j_cs.build(p0, e1, e2, pair_slots=pair_slots)
    t_acc = t_cs.build(p0, e1, e2, pair_slots=pair_slots, device="cpu")
    jo, jd, to, td = jvec(o), jvec(d), tvec(o), tvec(d)
    big = np.full(n, 1e30, np.float32)

    t1, pr1, uv1, v1 = (np.asarray(x) if not hasattr(x, "x") else x
                        for x in j_cs.intersect_cells(j_acc, jo, jd,
                                                      jnp.asarray(big)))
    t2, pr2, uv2, v2 = t_cs.intersect_cells(t_acc, to, td,
                                            torch.as_tensor(big))
    assert (v1 == v2.numpy()).all()
    sel = v1
    p_eq = pr1[sel] == pr2.numpy()[sel]
    assert p_eq.mean() > 0.999
    np.testing.assert_allclose(t2.numpy()[sel][p_eq], t1[sel][p_eq],
                               rtol=1e-4, atol=1e-5)
    assert (t2.numpy()[sel][~p_eq] <= t1[sel][~p_eq] + 1e-4).all()
    np.testing.assert_allclose(uv2.x.numpy()[sel][p_eq],
                               np.asarray(uv1.x)[sel][p_eq], atol=2e-3)
    np.testing.assert_allclose(uv2.y.numpy()[sel][p_eq],
                               np.asarray(uv1.y)[sel][p_eq], atol=2e-3)

    # any-hit: a maxt short of every true hit reports no occlusion, and
    # the answers at maxt = 2 equal JAX's
    short = np.where(v1, t1 * 0.9, 1e30).astype(np.float32)
    assert not t_cs.occluded_cells(t_acc, to, td,
                                   torch.as_tensor(short)).numpy()[sel].any()
    two = np.full(n, 2.0, np.float32)
    occ_j = np.asarray(j_cs.occluded_cells(j_acc, jo, jd, jnp.asarray(two)))
    occ_t = t_cs.occluded_cells(t_acc, to, td, torch.as_tensor(two)).numpy()
    assert (occ_j == occ_t).all()

    # inactive lanes never report hits
    act = np.arange(n) % 2 == 0
    _, _, _, v3 = t_cs.intersect_cells(t_acc, to, td, torch.as_tensor(big),
                                       active=torch.as_tensor(act))
    assert not v3.numpy()[~act].any()
    occ3 = t_cs.occluded_cells(t_acc, to, td, torch.as_tensor(two),
                               active=torch.as_tensor(act)).numpy()
    assert not occ3[~act].any()
    assert (occ3[act] == occ_j[act]).all()


def test_pairgen_slots_equal_jax(np_rng):
    """The DDA's (cell, ray) slots, resume distances and overflow flags
    are the JAX package's, bit for bit."""
    p0, e1, e2 = rand_tris(np_rng, 2000)
    o, d = rand_rays(np_rng)
    j_acc = j_cs.build(p0, e1, e2, pair_slots=2)
    t_acc = t_cs.build(p0, e1, e2, pair_slots=2, device="cpu")
    maxt = np.full(o.shape[0], 1e30, np.float32)
    jog, jdg = j_cs._grid_ray(j_acc, jvec(o), jvec(d))
    jti, jto, jinv = j_cs._clip(j_acc, jog, jdg, jnp.asarray(maxt))
    j_out = j_cs._pairgen(j_acc, jog, jdg, jinv, jti, jto, jti <= jto,
                          jnp.zeros_like(jti))
    tog, tdg = t_cs._grid_ray(t_acc, tvec(o), tvec(d))
    tti, tto, tinv = t_cs._clip(t_acc, tog, tdg, torch.as_tensor(maxt))
    t_out = t_cs._pairgen(t_acc, tog, tdg, tinv, tti, tto, tti <= tto,
                          torch.zeros_like(tti))
    for a, b in zip(j_out, t_out):
        np.testing.assert_array_equal(b.numpy(), np.asarray(a))


def test_sub_block_windows_cover_every_pair(np_rng):
    p0, e1, e2 = rand_tris(np_rng, 2000)
    o, d = rand_rays(np_rng)
    acc = t_cs.build(p0, e1, e2, device="cpu")
    to, td = tvec(o), tvec(d)
    og, dg = t_cs._grid_ray(acc, to, td)
    t_in, t_out, inv = t_cs._clip(acc, og, dg,
                                  torch.full((o.shape[0],), 1e30))
    slots, _, _ = t_cs._pairgen(acc, og, dg, inv, t_in, t_out,
                                t_in <= t_out, torch.zeros_like(t_in))
    pair, rays, r0, nr = t_cs.sort_pairs(acc, slots, to, td)
    cells = slots.reshape(-1)[pair].long()
    sub = torch.arange(pair.shape[0]) // t_cs.K
    first_row = acc.start[cells] // t_cs.K
    end_row = (acc.start[cells + 1] + t_cs.K - 1) // t_cs.K
    has_tris = acc.start[cells + 1] > acc.start[cells]
    assert (r0[sub][has_tris] <= first_row[has_tris]).all()
    assert ((r0 + nr)[sub][has_tris] >= end_row[has_tris]).all()
    # padding sub-blocks (no used pair) have an empty window
    assert (nr[(pair.shape[0] + t_cs.K - 1) // t_cs.K:] == 0).all()
    lane = pair % o.shape[0]
    np.testing.assert_array_equal(rays[0, :pair.shape[0]].numpy(),
                                  o[lane.numpy(), 0])


def _slab(tris_rows):
    """[(p0, e1, e2, id) per column] rows -> [R, 16, K] slab table."""
    out = np.zeros((len(tris_rows), 16, t_cs.K), np.float32)
    out[:, 9] = -1.0
    for r, row in enumerate(tris_rows):
        for col, (p0, e1, e2, pid) in row.items():
            out[r, 0:3, col], out[r, 3:6, col] = p0, e1
            out[r, 6:9, col], out[r, 9, col] = e2, pid
    return torch.as_tensor(out)


def test_serve_tie_rule_first_row_then_first_column():
    """A triangle binned into several cells appears more than once in a
    window with identical t: the first row wins across rows (strict <)
    and the first column within a row."""
    tri = ([-1.0, -1.0, 2.0], [3.0, 0.0, 0.0], [0.0, 3.0, 0.0])
    far = ([-1.0, -1.0, 5.0], [3.0, 0.0, 0.0], [0.0, 3.0, 0.0])
    tris = _slab([{9: (*far, 1), 7: (*tri, 11), 2: (*tri, 12)},
                  {0: (*tri, 13), 5: (*far, 14)}])
    rays = torch.zeros((6, t_cs.K))
    rays[5] = 1.0                          # every pair: o = 0, d = +z
    r0 = torch.zeros(1, dtype=torch.int32)
    for nr_val, prim in ((2, 12), (1, 12)):
        t, p, u, v = t_cs.serve_blocks(tris, rays, r0,
                                       torch.full((1,), nr_val,
                                                  dtype=torch.int32), True)
        assert (t == 2.0).all() and (p == prim).all()
        assert torch.allclose(u, torch.full_like(u, 1 / 3))
    # any-hit returns the same t and nothing else
    t, p, _, _ = t_cs.serve_blocks(tris, rays, r0,
                                   torch.full((1,), 2, dtype=torch.int32),
                                   False)
    assert (t == 2.0).all() and p is None
    # an empty window (padding sub-block) is a miss
    t, p, u, v = t_cs.serve_blocks(tris, rays, r0,
                                   torch.zeros(1, dtype=torch.int32), True)
    assert (t == t_cs.BIG).all() and (p == -1).all()
    assert (u == 0).all() and (v == 0).all()


def test_cpu_tensors_take_the_plain_path(np_rng, monkeypatch):
    """On CPU tensors the wrapper runs serve_blocks_plain and the launch
    counter stays 0; a tensor on another device is refused, never served
    by the plain version."""
    p0, e1, e2 = rand_tris(np_rng, 2000)
    o, d = rand_rays(np_rng, 256)
    acc = t_cs.build(p0, e1, e2, device="cpu")
    monkeypatch.setattr(t_cs, "LAUNCHES", {"closest": 0, "anyhit": 0})
    calls = []
    plain = t_cs.serve_blocks_plain

    def counting_plain(*args, **kwargs):
        calls.append(args[-1])
        return plain(*args, **kwargs)

    monkeypatch.setattr(t_cs, "serve_blocks_plain", counting_plain)
    t_cs.intersect_cells(acc, tvec(o), tvec(d), 1e30)
    t_cs.occluded_cells(acc, tvec(o), tvec(d), 2.0)
    assert t_cs.LAUNCHES == {"closest": 0, "anyhit": 0}
    assert True in calls and False in calls
    meta = torch.empty((6, t_cs.K), device="meta")
    with pytest.raises(ValueError, match="CUDA"):
        t_cs.serve_blocks(acc.tris, meta, torch.zeros(1, dtype=torch.int32),
                          torch.zeros(1, dtype=torch.int32), True)
