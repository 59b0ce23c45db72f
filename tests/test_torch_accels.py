"""Port parity, the accels of ``MI3T_ACCEL=xla``, ``grid`` and ``none``
and a hand-made ``HybridAccel`` (the grid's closest hits, bvh_tiled's
any-hit): the bvh_xla and grid builds are bit-equal to the JAX package's;
their queries equal JAX's (the grid's against eager JAX, bit for bit;
bvh_xla's against jitted JAX, whose compiled loop contracts
multiply-adds, so t, u and v within an ulp's worth and prim and valid
exactly) and the dense oracle's; the small terrain renders as JAX renders
it through each; ``auto`` builds bvh_xla on a CPU device, as JAX's does;
and a JAX scene's accel of each new kind carries across.

JAX's closest grid query with an infinite maxt reports false hits at
t 3.4e38 (ROADMAP queue 3); the port clamps maxt to 3e38, as both
packages' bvh_xla do, and the JAX side of a grid render here gets the
same clamp (``guarded_jax_grid``)."""
import contextlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mitsuba3_tpu as mj
from mitsuba3_tpu.core.vec import Vec3 as JVec3
from mitsuba3_tpu.ops import bvh_tiled as j_bt
from mitsuba3_tpu.ops import bvh_xla as j_bx
from mitsuba3_tpu.ops import grid as j_grid
from mitsuba3_tpu.render.scene import HybridAccel as JHybrid

import chip_smoke
import mitsuba3_tpu_torch as mt
from mitsuba3_tpu_torch.convert import arrays_from_scene, scene_from_arrays
from mitsuba3_tpu_torch.core.vec import Vec3 as TVec3
from mitsuba3_tpu_torch.ops import bvh_tiled as t_bt
from mitsuba3_tpu_torch.ops import bvh_xla as t_bx
from mitsuba3_tpu_torch.ops import grid as t_grid
from mitsuba3_tpu_torch.ops.intersect import intersect_naive, occluded_naive
from mitsuba3_tpu_torch.render.scene import HybridAccel as THybrid

torch.set_num_threads(1)
SEED, SPP = 5, 4
FIELDS = {"xla": (("bounds", "left", "right", "parent", "is_left", "tri",
                   "prim"), ("n_nodes",)),
          "grid": (("table", "lo", "inv_cell"), ("res", "max_steps", "k"))}
MODULES = {"xla": (j_bx, t_bx), "grid": (j_grid, t_grid)}
QUERY = {"xla": ("intersect_bvh", "occluded_bvh"),
         "grid": ("intersect_grid", "occluded_grid")}
_RENDERS = {}


@contextlib.contextmanager
def guarded_jax_grid():
    """JAX's closest grid query with maxt clamped to 3e38, as the port's
    is."""
    orig = j_grid.intersect_grid

    def guarded(g, o, d, maxt, active=None):
        return orig(g, o, d, jnp.minimum(maxt, jnp.float32(3e38)),
                    active=active)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(j_grid, "intersect_grid", guarded)
        yield


def soup(np_rng, n=2000):
    """The random soup of tests/test_bvh.py."""
    return (np_rng.uniform(-2, 2, (n, 3)).astype(np.float32),
            np_rng.normal(0, 0.3, (n, 3)).astype(np.float32),
            np_rng.normal(0, 0.3, (n, 3)).astype(np.float32))


def small_terrain():
    return chip_smoke.make_terrain(int(np.sqrt(9000 / 2)) + 1)


def rays(np_rng, n=1024):
    """Random rays, a third of them with a short maxt and a tenth
    inactive."""
    o = np_rng.uniform(-4, 4, (n, 3)).astype(np.float32)
    d = np_rng.normal(size=(n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    maxt = np.where(np_rng.random(n) < 0.3, np_rng.uniform(0.5, 3.0, n),
                    1e30).astype(np.float32)
    return o, d, maxt, np_rng.random(n) < 0.9


def jvec(a):
    return JVec3(*(jnp.asarray(a[:, i]) for i in range(3)))


def tvec(a):
    return TVec3(*(torch.as_tensor(np.ascontiguousarray(a[:, i]))
                   for i in range(3)))


def assert_accels_equal(t_acc, j_acc, kind):
    arrays, statics = FIELDS[kind]
    for name in arrays:
        want = np.asarray(getattr(j_acc, name))
        got = getattr(t_acc, name).numpy()
        assert got.dtype == want.dtype, name
        np.testing.assert_array_equal(got, want, err_msg=name)
    for name in statics:
        assert getattr(t_acc, name) == getattr(j_acc, name), name


# ---------------------------------------------------------------------------
# Builds and queries
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("scene", ["soup", "small_terrain"])
@pytest.mark.parametrize("kind", ["xla", "grid"])
def test_build_bit_equal(np_rng, kind, scene):
    tris = soup(np_rng) if scene == "soup" else small_terrain()
    j_mod, t_mod = MODULES[kind]
    assert_accels_equal(t_mod.build(*tris, device="cpu"),
                        j_mod.build(*tris), kind)


def test_grid_build_spills_like_jax(np_rng):
    """A coarse grid (res 8) over the soup: cells past K = 8 triangles
    chain spill rows, which the port's one scatter lays out as JAX's
    per-cell loop does."""
    tris = soup(np_rng, 3000)
    t_acc = t_grid.build(*tris, res=8, device="cpu")
    assert_accels_equal(t_acc, j_grid.build(*tris, res=8), "grid")
    assert t_acc.table.shape[0] > 8 ** 3 + 100


@pytest.mark.parametrize("mode", ["closest", "anyhit"])
@pytest.mark.parametrize("kind", ["xla", "grid"])
def test_queries_match_jax(np_rng, kind, mode):
    tris = soup(np_rng)
    o, d, maxt, act = rays(np_rng)
    j_mod, t_mod = MODULES[kind]
    j_acc, t_acc = j_mod.build(*tris), t_mod.build(*tris, device="cpu")
    fn = QUERY[kind][mode == "anyhit"]
    before = dict(t_mod.STEPS)
    args = (jvec(o), jvec(d), jnp.asarray(maxt))
    # the grid's JAX loop runs eagerly (bit for bit); bvh_xla's eager loop
    # takes ~30 s, so it runs jitted
    with jax.disable_jit() if kind == "grid" else contextlib.nullcontext():
        want = getattr(j_mod, fn)(j_acc, *args, active=jnp.asarray(act))
    got = getattr(t_mod, fn)(t_acc, tvec(o), tvec(d), torch.as_tensor(maxt),
                             active=torch.as_tensor(act))
    assert t_mod.STEPS[mode] > before[mode]
    if mode == "anyhit":
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
        assert 0 < int(got.sum()) < int(act.sum())
        return
    t, prim, uv, valid = (x.numpy() for x in (got[0], got[1], got[2].x,
                                               got[3]))
    np.testing.assert_array_equal(valid, np.asarray(want[3]))
    np.testing.assert_array_equal(prim, np.asarray(want[1]))
    assert valid.sum() > 100
    if kind == "grid":
        np.testing.assert_array_equal(t, np.asarray(want[0]))
        np.testing.assert_array_equal(uv, np.asarray(want[2].x))
        np.testing.assert_array_equal(got[2].y.numpy(),
                                      np.asarray(want[2].y))
    else:
        np.testing.assert_allclose(t, np.asarray(want[0]), rtol=1e-5)
        np.testing.assert_allclose(uv[valid], np.asarray(want[2].x)[valid],
                                   rtol=0, atol=1e-4)
        np.testing.assert_allclose(got[2].y.numpy()[valid],
                                   np.asarray(want[2].y)[valid], rtol=0,
                                   atol=1e-4)


@pytest.mark.parametrize("kind", ["xla", "grid"])
def test_queries_match_dense_oracle(np_rng, kind):
    """Against the dense test with the tolerances of tests/test_bvh.py:
    the formulas differ in their det and t guards, which part only
    edge-grazing slivers."""
    tris = soup(np_rng)
    o, d, maxt, act = rays(np_rng)
    t_mod = MODULES[kind][1]
    acc = t_mod.build(*tris, device="cpu")
    args = (tvec(o), tvec(d), torch.as_tensor(maxt))
    ftris = tuple(tvec(a) for a in tris)
    t1, p1, _, v1 = intersect_naive(*args, *ftris,
                                    active=torch.as_tensor(act))
    t2, p2, _, v2 = getattr(t_mod, QUERY[kind][0])(
        acc, *args, active=torch.as_tensor(act))
    assert torch.equal(v1, v2)
    p_eq = (p1 == p2)[v1]
    assert p_eq.float().mean() > 0.999
    assert torch.allclose(t1[v1][p_eq], t2[v1][p_eq], rtol=1e-4, atol=1e-5)
    occ1 = occluded_naive(*args, *ftris, active=torch.as_tensor(act))
    occ2 = getattr(t_mod, QUERY[kind][1])(acc, *args,
                                          active=torch.as_tensor(act))
    assert (occ1 == occ2).float().mean() > 0.999


def test_infinite_maxt_grid_query_keeps_to_real_hits(np_rng):
    """Rays leaving the small terrain's surface: the port's closest grid
    query with an infinite maxt equals JAX's with maxt 1e30 bit for bit
    and agrees with bvh_xla on every lane; JAX's own with an infinite
    maxt reports hits at t 3.4e38 on the rays that escape."""
    p0, e1, e2 = small_terrain()
    n = 1024
    f = np_rng.integers(0, p0.shape[0], n)
    nrm = np.cross(e1[f], e2[f])
    nrm *= np.sign(nrm[:, 2:3]) / np.linalg.norm(nrm, axis=1, keepdims=True)
    o = (p0[f] + 0.3 * e1[f] + 0.3 * e2[f] + 1e-4 * nrm).astype(np.float32)
    d = np_rng.normal(size=(n, 3)).astype(np.float32)
    d[:, 2] = np.abs(d[:, 2])
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    j_acc = j_grid.build(p0, e1, e2)
    t_acc = t_grid.build(p0, e1, e2, device="cpu")
    inf = np.full(n, np.inf, np.float32)
    got = t_grid.intersect_grid(t_acc, tvec(o), tvec(d), torch.as_tensor(inf))
    with jax.disable_jit():
        want = j_grid.intersect_grid(j_acc, jvec(o), jvec(d),
                                     jnp.full(n, 1e30, jnp.float32))
        jax_inf = j_grid.intersect_grid(j_acc, jvec(o), jvec(d),
                                        jnp.asarray(inf))
    for g, w in zip((got[0], got[1], got[3]), (want[0], want[1], want[3])):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    ref = t_bx.intersect_bvh(t_bx.build(p0, e1, e2, device="cpu"), tvec(o),
                             tvec(d), torch.as_tensor(inf))
    assert torch.equal(ref[3], got[3]) and 0 < int(got[3].sum()) < n
    false_hits = np.asarray(jax_inf[3]) & ~got[3].numpy()
    assert false_hits.any()
    assert (np.asarray(jax_inf[0])[false_hits] > 3e38).all()


# ---------------------------------------------------------------------------
# Renders, the loader's choice and conversion
# ---------------------------------------------------------------------------

def _hybrid(pkg_hybrid, grid_mod, tiled_mod, scene, **kw):
    """`scene` (loaded under MI3T_ACCEL=grid) with a HybridAccel: its grid
    for closest hits, a bvh_tiled over the same faces for any-hit."""
    v = np.asarray(scene.vertices)
    p = v[np.asarray(scene.faces)]
    return scene.replace(accel=pkg_hybrid(
        closest=scene.accel,
        anyhit=tiled_mod.build(p[:, 0], p[:, 1] - p[:, 0],
                               p[:, 2] - p[:, 0], **kw)))


def load_both(monkeypatch, kind, width=16):
    monkeypatch.setenv("MI3T_ACCEL", "grid" if kind == "hybrid" else kind)
    j_scene = mj.load_dict(chip_smoke.small_terrain_dict(
        mj.ScalarTransform4f, width=width))
    t_scene = mt.load_dict(chip_smoke.small_terrain_dict(
        mt.ScalarTransform4f, width=width), device="cpu")
    if kind == "hybrid":
        j_scene = _hybrid(JHybrid, j_grid, j_bt, j_scene)
        t_scene = _hybrid(THybrid, t_grid, t_bt, t_scene, device="cpu")
    return j_scene, t_scene


@pytest.mark.parametrize("kind", ["xla", "grid", "hybrid", "none"])
def test_small_terrain_render_matches_jax(monkeypatch, kind):
    j_scene, t_scene = load_both(monkeypatch, kind)
    want_type = {"xla": t_bx.BVHXLA, "grid": t_grid.GridAccel,
                 "hybrid": THybrid, "none": type(None)}[kind]
    assert type(t_scene.accel) is want_type
    with guarded_jax_grid():
        img_j, rays_j = mj.render_with_stats(j_scene, seed=SEED, spp=SPP)
    img_j = np.asarray(img_j)
    img_t, rays_t = mt.render_with_stats(t_scene, seed=SEED, spp=SPP)
    img_t = img_t.numpy()
    _RENDERS[kind] = img_t
    assert img_t.shape == (16, 16, 3) and np.isfinite(img_t).all()
    assert np.isclose(img_t, img_j, rtol=1e-3, atol=1e-3).mean() > 0.995
    assert np.allclose(img_t.mean(), img_j.mean(), rtol=1e-3)
    assert abs(rays_t - float(rays_j)) <= 1e-3 * float(rays_j)
    if len(_RENDERS) > 1:
        # the same triangles whatever the accel
        first = next(iter(_RENDERS.values()))
        assert np.isclose(img_t, first, rtol=1e-3, atol=1e-3).mean() > 0.995


def test_auto_builds_bvh_xla_on_a_cpu_device(monkeypatch):
    monkeypatch.delenv("MI3T_ACCEL", raising=False)
    d = chip_smoke.small_terrain_dict(mj.ScalarTransform4f, width=8)
    j_scene = mj.load_dict(d)
    t_scene = mt.load_dict(chip_smoke.small_terrain_dict(
        mt.ScalarTransform4f, width=8), device="cpu")
    assert type(j_scene.accel).__name__ == "BVHXLA"
    assert type(t_scene.accel) is t_bx.BVHXLA
    assert_accels_equal(t_scene.accel, j_scene.accel, "xla")


@pytest.mark.parametrize("kind", ["xla", "grid", "hybrid"])
def test_jax_accel_carried_across(monkeypatch, kind):
    """A JAX scene's accel of each new kind (its arrays and static fields)
    becomes the port's accel of that kind, equal to the port's own."""
    j_scene, t_scene = load_both(monkeypatch, kind, width=8)
    arrays, meta = arrays_from_scene(j_scene)
    assert meta["accel"]["kind"] == kind
    carried = scene_from_arrays(arrays, meta, device="cpu")
    assert type(carried.accel) is type(t_scene.accel)
    own, own_meta = arrays_from_scene(t_scene)
    assert own_meta["accel"] == meta["accel"]
    for name, want in arrays.items():
        if name.startswith("accel."):
            np.testing.assert_array_equal(own[name], want, err_msg=name)
    img = mt.render(carried, seed=SEED, spp=2).numpy()
    np.testing.assert_array_equal(
        img, mt.render(t_scene, seed=SEED, spp=2).numpy())
