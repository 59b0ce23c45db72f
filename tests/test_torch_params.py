"""Port parity for ``utils/params.py``: ``traverse`` gives the JAX
package's keys; ``update()`` after a vertex edit gives the JAX package's
area-emitter tables and rebuilt accel (cellserve, bvh_serve, bvh_tiled,
bvh_xla, the grid and a HybridAccel) bit for bit, after an environment
edit its sampling tables, and leaves the scene it started from as it
was; and a two-step SGD loop on the small terrain's vertices through
``prb`` and ``update()`` ends where the JAX package's does."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mitsuba3_tpu as mj
from mitsuba3_tpu.ops import bvh_tiled as j_bt
from mitsuba3_tpu.ops import grid as j_grid
from mitsuba3_tpu.render import scene as j_scene_mod

import chip_smoke
import mitsuba3_tpu_torch as mt
from mitsuba3_tpu_torch.convert import arrays_from_scene
from mitsuba3_tpu_torch.ops import bvh_tiled as t_bt
from mitsuba3_tpu_torch.ops import grid as t_grid
from mitsuba3_tpu_torch.render import scene as t_scene_mod

torch.set_num_threads(1)


def cornell(transform_pkg):
    return transform_pkg.cornell_box(16, 16, max_depth=3)


def terrain(transform_pkg, width=16):
    return chip_smoke.small_terrain_dict(transform_pkg.ScalarTransform4f,
                                         width=width)


def load_both(monkeypatch, make, accel="cells"):
    monkeypatch.setenv("MI3T_ACCEL", accel)
    return mj.load_dict(make(mj)), mt.load_dict(make(mt), device="cpu")


def bump(v):
    """The vertices lifted by a smooth bump (along z for the terrain, y
    for the Cornell box's up axis)."""
    v = np.array(v, np.float32)
    r2 = v[:, 0] ** 2 + v[:, 2 if abs(v[:, 1]).max() > 1.5 else 1] ** 2
    v[:, 1 if abs(v[:, 1]).max() > 1.5 else 2] += (
        0.2 * np.exp(-r2)).astype(np.float32)
    return v


def assert_scenes_equal(t_scene, j_scene):
    t_arrays, t_meta = arrays_from_scene(t_scene)
    j_arrays, j_meta = arrays_from_scene(j_scene)
    assert sorted(t_arrays) == sorted(j_arrays)
    for name, want in j_arrays.items():
        got = t_arrays[name]
        assert got.dtype == want.dtype, name
        np.testing.assert_array_equal(got, want, err_msg=name)
    assert t_meta == j_meta


@pytest.mark.parametrize("make", [cornell, terrain],
                         ids=["cornell", "small_terrain"])
def test_traverse_keys_equal_jax(monkeypatch, make):
    j_scene, t_scene = load_both(monkeypatch, make)
    pj, pt = mj.traverse(j_scene), mt.traverse(t_scene)
    assert list(pt.keys()) == list(pj.keys())
    for k, v in pt.items():
        np.testing.assert_array_equal(v.numpy(), np.asarray(pj[k]),
                                      err_msg=k)
    assert "vertices" in pt and "missing" not in pt
    with pytest.raises(KeyError):
        pt["missing"] = 1.0


def with_hybrid(pkg_hybrid, grid_mod, tiled_mod, scene, **kw):
    """`scene` (loaded under MI3T_ACCEL=grid) with a hand-made
    HybridAccel: its grid for closest hits, bvh_tiled for any-hit."""
    p = np.asarray(scene.vertices)[np.asarray(scene.faces)]
    return scene.replace(accel=pkg_hybrid(
        closest=scene.accel, anyhit=tiled_mod.build(
            p[:, 0], p[:, 1] - p[:, 0], p[:, 2] - p[:, 0], **kw)))


def accel_geometry(acc):
    """The triangle array of an accel (a hybrid's closest side's)."""
    acc = getattr(acc, "closest", acc)
    for name in ("tris", "tri", "table"):
        if hasattr(acc, name):
            return getattr(acc, name)


@pytest.mark.parametrize("accel", ["cells", "serve", "tiled", "xla", "grid",
                                   "hybrid"])
def test_vertex_update_rebuilds_accel_like_jax(monkeypatch, accel):
    """The small terrain (8,978 faces) under each accel: after a vertex
    edit, update() rebuilds the loader's accel type (a HybridAccel as a
    grid and a bvh_tiled, as JAX rebuilds one), and every leaf of the new
    scene equals JAX's bit for bit; the old scene is untouched."""
    j_scene, t_scene = load_both(monkeypatch, terrain,
                                 "grid" if accel == "hybrid" else accel)
    if accel == "hybrid":
        j_scene = with_hybrid(j_scene_mod.HybridAccel, j_grid, j_bt, j_scene)
        t_scene = with_hybrid(t_scene_mod.HybridAccel, t_grid, t_bt, t_scene,
                              device="cpu")
    v = bump(np.asarray(j_scene.vertices))
    old = arrays_from_scene(t_scene)
    pj, pt = mj.traverse(j_scene), mt.traverse(t_scene)
    pj["vertices"] = v
    pt["vertices"] = torch.as_tensor(v)
    new_t = pt.update()
    assert_scenes_equal(new_t, pj.update())
    assert type(new_t.accel) is type(t_scene.accel)
    if accel == "hybrid":
        assert type(new_t.accel.closest) is t_grid.GridAccel
        assert type(new_t.accel.anyhit) is t_bt.BVHTiled
    assert_scenes_equal(t_scene, mt.convert.scene_from_arrays(*old, "cpu"))
    assert not torch.equal(accel_geometry(new_t.accel),
                           accel_geometry(t_scene.accel))


def test_vertex_update_area_tables_like_jax():
    """The Cornell box (dense, area light): a vertex edit that moves the
    light refreshes face_inv_total_area and ef_cdf as JAX does (float64
    sums, float32 tables), bit for bit."""
    j_scene = mj.load_dict(cornell(mj))
    t_scene = mt.load_dict(cornell(mt), device="cpu")
    v = np.asarray(j_scene.vertices) * np.float32(1.1)
    pj, pt = mj.traverse(j_scene), mt.traverse(t_scene)
    pj["vertices"] = v
    pt["vertices"] = v
    new_t = pt.update()
    assert_scenes_equal(new_t, pj.update())
    assert not torch.equal(new_t.face_inv_total_area,
                           t_scene.face_inv_total_area)


def test_env_and_table_updates_like_jax(monkeypatch, np_rng):
    """An env_data edit rebuilds the environment's sampling tables; the
    other keys replace their tables; set_dirty and update(values) apply
    as JAX's do."""
    j_scene, t_scene = load_both(monkeypatch, terrain)
    env = np_rng.uniform(0, 2, (4, 8, 3)).astype(np.float32)
    edits = {"env_data": env,
             "bsdf_params": np_rng.uniform(0, 1, tuple(
                 t_scene.bsdf_params.shape)).astype(np.float32),
             "env_scale": np.float32(0.7),
             "de_params": np_rng.uniform(0, 1, tuple(
                 t_scene.de_params.shape)).astype(np.float32),
             "sensor.to_world.origin": np.asarray([0.1, -4, 3.2],
                                                  np.float32)}
    pj, pt = mj.traverse(j_scene), mt.traverse(t_scene)
    new_j = pj.update(edits)
    new_t = pt.update(edits)
    assert_scenes_equal(new_t, new_j)
    assert float(new_t.env_warp.marg_cdf[0, -1]) > 0
    # set_dirty re-applies what is stored: nothing changes
    pt.set_dirty("bsdf_params")
    assert_scenes_equal(pt.scene(), new_j)


def _sgd_loop(pkg, scene, target, lr, steps, grad_fn):
    params = pkg.traverse(scene)
    opt = pkg.ad.SGD(lr=lr, params={"vertices": params["vertices"]})
    for it in range(steps):
        g = grad_fn(params.update(), opt["vertices"], target, it)
        opt.step({"vertices": g})
        params["vertices"] = opt["vertices"]
    return params.update()


def test_sgd_vertex_loop_matches_jax(monkeypatch):
    """Two SGD steps on the small terrain's vertices (16^2, 4 spp, prb,
    cellserve rebuilt by update() after each step) from a bumped start
    toward the flat target: the vertices each package ends with agree
    within 1e-3 of the largest move (the PRB gradients' 1e-4 of their
    largest, compounded over two steps and two accel rebuilds)."""
    monkeypatch.setenv("MI3T_ACCEL", "cells")

    def prb(pkg):
        return chip_smoke._prb_dict(terrain(pkg))
    j0, t0 = mj.load_dict(prb(mj)), mt.load_dict(prb(mt), device="cpu")
    # one target for both loops: the port's render of the flat terrain
    target_t = mt.render(t0, seed=9, spp=4)
    target_j = jnp.asarray(target_t.numpy())
    v = bump(np.asarray(j0.vertices))
    pj, pt = mj.traverse(j0), mt.traverse(t0)
    pj["vertices"] = v
    pt["vertices"] = v
    sj, st = pj.update(), pt.update()
    lr = 2.0

    def grad_j(scene, verts, target, it):
        def loss(x):
            img = mj.render(scene.replace(vertices=x), seed=it, spp=4)
            return jnp.mean((img - target) ** 2)
        return jax.grad(loss)(verts)

    def grad_t(scene, verts, target, it):
        x = verts.clone().requires_grad_(True)
        img = mt.render(scene.replace(vertices=x), seed=it, spp=4)
        return torch.autograd.grad(torch.mean((img - target) ** 2), x)[0]

    end_j = _sgd_loop(mj, sj, target_j, lr, 2, grad_j)
    end_t = _sgd_loop(mt, st, target_t, lr, 2, grad_t)
    move_j = np.asarray(end_j.vertices) - v
    move_t = end_t.vertices.numpy() - v
    scale = np.abs(move_j).max()
    assert 1e-4 < scale < 0.1
    np.testing.assert_allclose(move_t, move_j, rtol=0, atol=1e-3 * scale)
    assert isinstance(end_t.accel, mt.ops.cellserve.CellServe)
