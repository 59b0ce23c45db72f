"""Port parity for true instancing (``render/instancing.py``, the loader's
``shapegroup`` and ``instance``) against the JAX package.

The instance table and the prototypes' face ranges equal JAX's; the
instanced closest-hit and any-hit queries give JAX's instance and prim
ids bit-equal, t within 1e-5 and uv within 2e-4 (JAX's compiled loop
contracts multiply-adds: its eager run equals the port's bit for bit, at
ten times the test's time) on a scene with a dense prototype and one
above 8192 faces with its own cellserve (K1's plain version here, JAX's
kernel in interpret mode); tests/
test_instancing.py's scene renders per pixel as JAX's instanced render
and as its flattened one (``MI3T_FLATTEN_INSTANCES=1``, set on the JAX
side only: the port has no such switch); a vertex edit rebuilds the
prototype's accel as JAX's ``update()`` does; the shapegroup errors are
JAX's; and a PRB gradient of ``bsdf_params`` on a scene with an analytic
sphere, an SDF blob and two instances is within 1e-4 of ``jax.grad``'s.
Scenes above 8192 faces set ``MI3T_ACCEL=cells`` on both sides.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mitsuba3_tpu as mj
from mitsuba3_tpu.core.vec import Vec3 as JV3
from mitsuba3_tpu.render import instancing as inst_j
from mitsuba3_tpu.utils.params import traverse as traverse_j

import chip_smoke
import mitsuba3_tpu_torch as mt
from mitsuba3_tpu_torch.convert import (accel_arrays, arrays_from_scene,
                                        scene_from_arrays)
from mitsuba3_tpu_torch.core.vec import Vec3 as TV3
from mitsuba3_tpu_torch.render import instancing as inst_t
from test_instancing import _scene_dict
from test_torch_prb import _assert_grads_close, _grads_jax, _grads_port
from test_torch_shapes import _sdf_sphere_grid

torch.set_num_threads(1)
FIELD = {"width": 16, "tiles": 2, "side": 66, "scatter": 6}


@pytest.fixture(scope="module")
def field():
    """(JAX scene, port scene) of a small instanced field: prototype R
    (make_terrain(66), 8,450 faces: its own cellserve) in 4 instances,
    prototype G (3,980 faces: dense) in 6."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("MI3T_ACCEL", "cells")
        sj = mj.load_dict(chip_smoke.instanced_field_dict(
            mj.ScalarTransform4f, **FIELD))
        st = mt.load_dict(chip_smoke.instanced_field_dict(
            mt.ScalarTransform4f, **FIELD), device="cpu")
    return sj, st


def test_instance_table_matches_jax(field):
    sj, st = field
    for f in inst_t.INSTANCE_FIELDS:
        np.testing.assert_array_equal(getattr(st.instances, f).numpy(),
                                      np.asarray(getattr(sj.instances, f)),
                                      err_msg=f)
    assert st.proto_ranges == sj.proto_ranges == ((8, 8704), (8712, 4096))
    assert st.n_query_faces == sj.n_query_faces == 8
    assert [a is None for a in st.proto_accels] == [False, True]
    for f in ("vertices", "faces", "face_shape", "face_bsdf", "face_uv",
              "face_normals", "face_medium", "bsdf_params"):
        np.testing.assert_array_equal(getattr(st, f).numpy(),
                                      np.asarray(getattr(sj, f)), err_msg=f)
    ja, _ = accel_arrays(sj.proto_accels[0])
    ta, _ = accel_arrays(st.proto_accels[0])
    for k in ja:
        np.testing.assert_array_equal(ta[k], ja[k], err_msg=k)


def _field_rays(n=2048, seed=3):
    """Seeded rays from the field's camera toward its instances."""
    rng = np.random.default_rng(seed)
    o = np.tile([[0.0, -9.0, 5.0]], (n, 1)).astype(np.float32)
    tgt = np.stack([rng.uniform(-4, 4, n), rng.uniform(-4, 4, n),
                    rng.uniform(0, 1.2, n)], -1).astype(np.float32)
    d = tgt - o
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    return o, d, rng.uniform(size=n) > 0.05


def test_intersect_instances_match_jax(field):
    """Closest instanced hits on 2,048 rays, an active mask: both
    prototypes hit, ids bit-equal, t and uv allclose."""
    sj, st = field
    o, d, act = _field_rays()
    n = o.shape[0]
    rj = inst_j.intersect_instances(
        sj, JV3.from_array(jnp.asarray(o)), JV3.from_array(jnp.asarray(d)),
        jnp.full(n, 1e30, jnp.float32), jnp.asarray(act))
    rt = inst_t.intersect_instances(
        st, TV3(*torch.tensor(o).T), TV3(*torch.tensor(d).T),
        torch.full((n,), 1e30), torch.tensor(act))
    tj, pj, uj, vj, ij, okj = (np.asarray(x) for x in (
        rj[0], rj[1], rj[2].x, rj[2].y, rj[3], rj[4]))
    for name, a, b in (("prim", pj, rt[1]), ("instance", ij, rt[3]),
                       ("valid", okj, rt[4])):
        np.testing.assert_array_equal(b.numpy(), a, err_msg=name)
    base_g = st.proto_ranges[1][0]
    assert (pj[okj] < base_g).sum() > 50 and (pj[okj] >= base_g).sum() > 50
    np.testing.assert_allclose(rt[0].numpy(), tj, rtol=1e-5)
    np.testing.assert_allclose(rt[2].x.numpy()[okj], uj[okj], atol=2e-4)
    np.testing.assert_allclose(rt[2].y.numpy()[okj], vj[okj], atol=2e-4)


def test_occluded_instances_match_jax(field):
    """Any-hit instanced queries up to maxt 9 on the same rays."""
    sj, st = field
    o, d, act = _field_rays(seed=4)
    n = o.shape[0]
    occ_j = np.asarray(inst_j.occluded_instances(
        sj, JV3.from_array(jnp.asarray(o)), JV3.from_array(jnp.asarray(d)),
        jnp.full(n, 9.0, jnp.float32), jnp.asarray(act)))
    occ_t = inst_t.occluded_instances(
        st, TV3(*torch.tensor(o).T), TV3(*torch.tensor(d).T),
        torch.full((n,), 9.0), torch.tensor(act)).numpy()
    np.testing.assert_array_equal(occ_t, occ_j)
    assert 20 < occ_j.sum() < act.sum()


def test_instanced_render_matches_jax_and_flattened(monkeypatch):
    """tests/test_instancing.py's 10-instance scene: the port's render per
    pixel against JAX's instanced render, and against JAX's flattened
    lowering as tests/test_instancing.py holds JAX's own."""
    d = _scene_dict(10, width=16, spp=4)
    sj = mj.load_dict(d)
    st = mt.load_dict(d, device="cpu")
    img_j, rays_j = mj.render_with_stats(sj, spp=4, seed=3)
    img_t, rays_t = mt.render_with_stats(st, spp=4, seed=3)
    img_j, img_t = np.asarray(img_j), img_t.numpy()
    assert np.isfinite(img_t).all() and img_t.max() > 0
    assert np.isclose(img_t, img_j, rtol=1e-3, atol=1e-3).mean() > 0.995
    np.testing.assert_allclose(img_t.mean(), img_j.mean(), rtol=1e-3)
    assert abs(rays_t - float(rays_j)) <= 1e-3 * float(rays_j)
    monkeypatch.setenv("MI3T_FLATTEN_INSTANCES", "1")
    s_flat = mj.load_dict(d)
    assert s_flat.instances is None
    img_f = np.asarray(mj.render(s_flat, spp=4, seed=3))
    assert np.isclose(img_t, img_f, rtol=1e-3, atol=2e-3).mean() > 0.95
    np.testing.assert_allclose(img_t.mean(), img_f.mean(), rtol=2e-3)


def test_vertex_edit_rebuilds_prototype_accel(field):
    """Prototype R's vertices lifted through traverse/update(): the
    prototype's cellserve and the base accel rebuilt as JAX's update()
    rebuilds them, array for array."""
    sj, st = field
    base, count = st.proto_ranges[0]
    rows = np.unique(st.faces[base:base + count].numpy().ravel())
    pj, pt = traverse_j(sj), mt.traverse(st)
    vj = np.asarray(sj.vertices).copy()
    vj[rows, 2] += 0.05
    pj["vertices"] = jnp.asarray(vj)
    pt["vertices"] = torch.tensor(vj)
    sj2, st2 = pj.update(), pt.update()
    ja, _ = accel_arrays(sj2.proto_accels[0])
    ta, _ = accel_arrays(st2.proto_accels[0])
    old, _ = accel_arrays(st.proto_accels[0])
    assert not np.array_equal(ta["tris"], old["tris"])
    for k in ja:
        np.testing.assert_array_equal(ta[k], ja[k], err_msg=k)
    assert st2.proto_accels[1] is None and st2.accel is None


def _group_with(member):
    d = _scene_dict(1, width=8, spp=1)
    d["grp"] = dict(d["grp"], extra=member)
    return d


SHAPEGROUP_ERRORS = {
    "emitter": _group_with({"type": "rectangle",
                            "emitter": {"type": "area", "radiance": 1.0}}),
    "sdfgrid": _group_with({"type": "sdfgrid",
                            "grid": np.zeros((4, 4, 4), np.float32)}),
    "ellipsoids": _group_with({"type": "ellipsoids",
                               "means": np.zeros((2, 3))}),
    "unknown": dict(_scene_dict(1, width=8, spp=1), inst_0={
        "type": "instance", "ref": {"type": "ref", "id": "nope"}}),
}


@pytest.mark.parametrize("case", sorted(SHAPEGROUP_ERRORS))
def test_shapegroup_errors_match_jax(case):
    d = SHAPEGROUP_ERRORS[case]
    with pytest.raises(ValueError) as ej:
        mj.load_dict(d)
    with pytest.raises(ValueError) as et:
        mt.load_dict(d, device="cpu")
    assert str(et.value) == str(ej.value)


def test_convert_carries_instances(field):
    """scene_from_arrays(arrays_from_scene(JAX scene)) gives the port's
    load_dict scene: the instance table, the prototype ranges, their
    accels and n_query_faces; the two render the same image."""
    sj, st = field
    conv = scene_from_arrays(*arrays_from_scene(sj), device="cpu")
    assert conv.proto_ranges == st.proto_ranges
    assert conv.n_query_faces == st.n_query_faces
    for f in inst_t.INSTANCE_FIELDS:
        np.testing.assert_array_equal(getattr(conv.instances, f).numpy(),
                                      getattr(st.instances, f).numpy())
    assert conv.proto_accels[1] is None
    ca, _ = accel_arrays(conv.proto_accels[0])
    ta, _ = accel_arrays(st.proto_accels[0])
    for k in ta:
        np.testing.assert_array_equal(ca[k], ta[k], err_msg=k)
    np.testing.assert_array_equal(
        mt.render(conv, seed=1, spp=2).numpy(),
        mt.render(st, seed=1, spp=2).numpy())


def _mixed_dict(pkg):
    """A PRB scene (8^2, max_depth 3) holding an analytic sphere, an SDF
    blob and two instances of a cube-and-sphere shapegroup on a floor."""
    T = pkg.ScalarTransform4f
    return {
        "type": "scene",
        "integrator": {"type": "prb", "max_depth": 3},
        "sensor": {"type": "perspective", "fov": 50.0,
                   "to_world": T().look_at(origin=[0, -5, 3],
                                           target=[0, 0, 0.5],
                                           up=[0, 0, 1]),
                   "film": {"width": 8, "height": 8,
                            "rfilter": {"type": "box"}},
                   "sampler": {"type": "independent", "sample_count": 4}},
        "floor": {"type": "rectangle", "to_world": T().scale(4.0),
                  "bsdf": {"type": "diffuse"}},
        "ball": {"type": "sphere", "center": [-1.2, 0, 0.6], "radius": 0.6,
                 "bsdf": {"type": "diffuse", "reflectance": {
                     "type": "rgb", "value": [0.3, 0.7, 0.4]}}},
        "blob": {"type": "sdfgrid", "grid": _sdf_sphere_grid(16),
                 "to_world": T().translate([0.2, -0.5, 0.0]).scale(1.5),
                 "bsdf": {"type": "diffuse", "reflectance": {
                     "type": "rgb", "value": [0.8, 0.3, 0.2]}}},
        "grp": chip_smoke.shapegroup_g(T),
        "inst_a": {"type": "instance", "ref": {"type": "ref", "id": "grp"},
                   "to_world": T().translate([1.3, 0.2, 0.3])},
        "inst_b": {"type": "instance", "ref": {"type": "ref", "id": "grp"},
                   "to_world": T().translate([0.6, 1.2, 0.3])
                   .rotate([0, 0, 1], 30).scale(1.3)},
        "light": {"type": "point", "position": [2, -2, 4],
                  "intensity": {"type": "rgb", "value": [30, 30, 30]}},
        "env": {"type": "constant", "radiance": 0.3},
    }


def test_prb_grads_mixed_scene_match_jax():
    """d mean(image) / d(bsdf_params) through prb on the mixed scene:
    finite, within 1e-4 of jax.grad's largest entry, nonzero on the
    sphere's, the blob's and the instances' rows."""
    sj = mj.load_dict(_mixed_dict(mj))
    st = mt.load_dict(_mixed_dict(mt), device="cpu")
    gj = _grads_jax(sj, ("bsdf_params",), 4, 0)
    gt = _grads_port(st, ("bsdf_params",), 4, 0)
    assert np.isfinite(np.asarray(gj["bsdf_params"])).all()
    _assert_grads_close(gj, gt, ("bsdf_params",), 1e-4)
    g = gt["bsdf_params"].numpy()
    assert (np.abs(g[:, 0:3]).max(axis=1) > 0).sum() >= 4
