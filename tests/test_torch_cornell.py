"""Port parity for the Cornell box, the dense path of ``bench.py``: the
rotate transform, the discrete pick of the area NEE, the rectangle and
cube shapes, the loader's leaves (bit-equal to JAX's), the dense
intersector, area-light NEE and MIS pdfs against the JAX scene on random
rays, a 32^2 render per pixel against JAX at the same seed, and the
Z-test of ``tests/test_regression.py`` against its stored reference."""
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mitsuba3_tpu as mj
from mitsuba3_tpu.core import distr as distr_j
from mitsuba3_tpu.core.vec import Vec2 as Vec2J
from mitsuba3_tpu.core.vec import Vec3 as Vec3J
from mitsuba3_tpu.render.records import Ray as RayJ
from mitsuba3_tpu import shapes as shapes_j

import chip_smoke
import mitsuba3_tpu_torch as mt
from mitsuba3_tpu_torch.convert import arrays_from_scene, scene_from_arrays
from mitsuba3_tpu_torch.core import distr as distr_t
from mitsuba3_tpu_torch.core.vec import Vec2, Vec3
from mitsuba3_tpu_torch.render.records import Ray
from mitsuba3_tpu_torch import shapes as shapes_t
from test_regression import DATA, REF_SPP, TEST_SPP, _z_test

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def cornell():
    """(JAX scene, port scene) of the 32^2 Cornell box, max_depth 4."""
    return (mj.load_dict(mj.cornell_box(32, 32, max_depth=4)),
            mt.load_dict(mt.cornell_box(32, 32, max_depth=4), device="cpu"))


@pytest.mark.parametrize("axis,angle", [([1, 0, 0], 90), ([0, 1, 0], -17),
                                        ([0.3, -1, 2], 18.25)])
def test_rotate_matches_jax(axis, angle):
    a = mj.ScalarTransform4f().translate([0.1, 2, -3]).rotate(axis, angle)
    b = mt.ScalarTransform4f().translate([0.1, 2, -3]).rotate(axis, angle)
    np.testing.assert_array_equal(a.matrix, b.matrix)
    np.testing.assert_array_equal(a.inverse_matrix, b.inverse_matrix)


def test_discrete_pick_matches_jax(np_rng):
    """searchsorted side="right", clipped, as the area NEE picks a face;
    DiscreteDistribution.sample scales the sample by the total first."""
    pmf = np_rng.uniform(0.1, 1.0, 17).astype(np.float32)
    xi = np.concatenate([np_rng.uniform(0, 1, 1000),
                         [0.0, 1.0, 0.999999]]).astype(np.float32)
    dj = distr_j.DiscreteDistribution.from_pmf(pmf)
    dt = distr_t.DiscreteDistribution.from_pmf(pmf)
    np.testing.assert_array_equal(np.asarray(dj.sample(xi)),
                                  dt.sample(torch.as_tensor(xi)).numpy())
    cdf = np.asarray(dj.cdf) / float(dj.total)
    ref = np.clip(np.searchsorted(cdf, xi, side="right"), 0, 16)
    np.testing.assert_array_equal(
        distr_t.pick(torch.as_tensor(cdf), torch.as_tensor(xi)).numpy(), ref)


@pytest.mark.parametrize("stype", ["rectangle", "cube"])
def test_shapes_match_jax(stype):
    """Canonical geometry, uvs and face areas, and a to_world applied."""
    spec_j = {"type": stype, "to_world": mj.ScalarTransform4f().translate(
        [0.335, -0.7, 0.38]).rotate([0, 1, 0], -17).scale(0.3)}
    spec_t = {"type": stype, "to_world": mt.ScalarTransform4f().translate(
        [0.335, -0.7, 0.38]).rotate([0, 1, 0], -17).scale(0.3)}
    for a, b in ((shapes_j.build_shape({"type": stype}),
                  shapes_t.build_shape({"type": stype})),
                 (shapes_j.build_shape(spec_j), shapes_t.build_shape(spec_t))):
        np.testing.assert_array_equal(a.vertices, b.vertices)
        np.testing.assert_array_equal(a.faces, b.faces)
        np.testing.assert_array_equal(a.uvs, b.uvs)
        np.testing.assert_array_equal(a.face_areas(), b.face_areas())


def test_cornell_leaves_equal_jax(cornell):
    """Every array leaf equal to JAX's (integers and floats bit-equal),
    the static fields too; the dense branch (no accel), 36 faces padded to
    40 and one area emitter with its sampling tables."""
    sj, st = cornell
    aj, meta_j = arrays_from_scene(sj)
    at, meta_t = arrays_from_scene(st)
    assert sorted(aj) == sorted(at)
    for name in aj:
        assert aj[name].dtype == at[name].dtype, name
        np.testing.assert_array_equal(aj[name], at[name], err_msg=name)
    assert meta_j == meta_t
    assert st.accel is None and meta_t["accel"] == {"kind": "dense"}
    assert st.faces.shape[0] == 40 and int((st.face_shape >= 0).sum()) == 36
    assert st.n_area_emitters == 1 and st.n_emitters == 1
    np.testing.assert_array_equal(st.ef_face.numpy(), [0, 1])
    assert float(st.ef_cdf[-1]) == 1.0 and st.textures == ()


def test_gather_face_attrs_equals_one_hot(cornell, np_rng):
    """Below 1024 faces JAX gathers with a one-hot matmul at HIGHEST
    precision; the port's row take gives the same values."""
    sj, st = cornell
    prim = np_rng.integers(0, 40, 500).astype(np.int32)
    np.testing.assert_array_equal(
        np.asarray(sj.gather_face_attrs(jnp.asarray(prim)))[:19],
        st.gather_face_attrs(torch.as_tensor(prim)).numpy()[:19])


def _rays(np_rng, n):
    """Rays from inside the box toward random directions, maxt random
    (some short of the walls), every third lane inactive."""
    o = np_rng.uniform(-0.9, 0.9, (n, 3)).astype(np.float32)
    d = np_rng.normal(size=(n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    maxt = np_rng.uniform(0.2, 4.0, n).astype(np.float32)
    active = np.arange(n) % 3 != 0
    return o, d, maxt, active


def _vj(a):
    return Vec3J(*(jnp.asarray(a[:, i]) for i in range(3)))


def _vt(a):
    return Vec3(*(torch.as_tensor(np.ascontiguousarray(a[:, i]))
                  for i in range(3)))


def test_dense_queries_match_jax(cornell, np_rng):
    """Closest hit (t, prim, barycentrics, valid) and any-hit of the dense
    branch on 2,000 random rays; t and barycentrics rtol 1e-6."""
    sj, st = cornell
    o, d, maxt, active = _rays(np_rng, 2000)
    pj = sj.ray_intersect_preliminary(
        RayJ(o=_vj(o), d=_vj(d), maxt=jnp.asarray(maxt)),
        active=jnp.asarray(active))
    pt = st.ray_intersect_preliminary(
        Ray(o=_vt(o), d=_vt(d), maxt=torch.as_tensor(maxt)),
        active=torch.as_tensor(active))
    valid = np.asarray(pj.is_valid())
    np.testing.assert_array_equal(valid, pt.is_valid().numpy())
    assert valid.mean() > 0.3 and not valid[~active].any()
    np.testing.assert_array_equal(np.asarray(pj.prim_index),
                                  pt.prim_index.numpy())
    for a, b in ((pj.t, pt.t), (pj.prim_uv.x, pt.prim_uv.x),
                 (pj.prim_uv.y, pt.prim_uv.y)):
        np.testing.assert_allclose(np.asarray(a)[valid], b.numpy()[valid],
                                   rtol=1e-6, atol=1e-7)
    occ_j = sj.ray_test(RayJ(o=_vj(o), d=_vj(d), maxt=jnp.asarray(maxt)),
                        active=jnp.asarray(active))
    occ_t = st.ray_test(Ray(o=_vt(o), d=_vt(d), maxt=torch.as_tensor(maxt)),
                        active=torch.as_tensor(active))
    np.testing.assert_array_equal(np.asarray(occ_j), occ_t.numpy())
    assert 0.1 < np.asarray(occ_j).mean() < 0.9


def _hits(scenes, np_rng, n=3000):
    """Surface interactions of random rays on both scenes (JAX, port),
    the rays' origins, and the hit mask."""
    sj, st = scenes
    o, d, _, _ = _rays(np_rng, n)
    inf = np.full(n, np.inf, np.float32)
    rj = RayJ(o=_vj(o), d=_vj(d), maxt=jnp.asarray(inf))
    rt = Ray(o=_vt(o), d=_vt(d), maxt=torch.as_tensor(inf))
    sij, aj = sj.compute_surface_interaction(rj, sj.ray_intersect_preliminary(
        rj))
    sit, at = st.compute_surface_interaction(rt, st.ray_intersect_preliminary(
        rt))
    return (sij, aj), (sit, at), o, np.array(sij.is_valid())


def _close(a, b, mask=None, rtol=1e-5, atol=1e-6):
    a, b = np.asarray(a), b.detach().numpy()
    if mask is not None:
        a, b = a[mask], b[mask]
    np.testing.assert_allclose(b, a, rtol=rtol, atol=atol)


def test_area_nee_matches_jax(cornell, np_rng):
    """sample_emitter_direction (area branch: the face pick, the triangle
    warp, the solid-angle pdf, em_idx from column 16) with and without the
    shadow test, on hits of random rays; rtol 1e-5."""
    (sij, _), (sit, _), _, hit = _hits(cornell, np_rng)
    sj, st = cornell
    s1 = np_rng.uniform(0, 1, hit.size).astype(np.float32)
    s2 = np_rng.uniform(0, 1, (hit.size, 2)).astype(np.float32)
    n_lit = {}
    for vis in (False, True):
        dsj, wj = sj.sample_emitter_direction(
            sij, jnp.asarray(s1), Vec2J(jnp.asarray(s2[:, 0]),
                                        jnp.asarray(s2[:, 1])),
            active=jnp.asarray(hit), test_visibility=vis)
        dst, wt = st.sample_emitter_direction(
            sit, torch.as_tensor(s1), Vec2(torch.as_tensor(s2[:, 0]),
                                           torch.as_tensor(s2[:, 1])),
            active=torch.as_tensor(hit), test_visibility=vis)
        np.testing.assert_array_equal(np.asarray(dsj.emitter_index),
                                      dst.emitter_index.numpy())
        np.testing.assert_array_equal(np.asarray(dsj.prim_index),
                                      dst.prim_index.numpy())
        assert set(np.unique(dst.prim_index.numpy())) == {0, 1}
        _close(dsj.pdf, dst.pdf)
        for cj, ct in ((dsj.p, dst.p), (dsj.d, dst.d), (wj, wt)):
            for comp in "xyz":
                _close(getattr(cj, comp), getattr(ct, comp))
        _close(dsj.dist, dst.dist)
        n_lit[vis] = int((dst.pdf > 0).sum())
    # the boxes shadow part of the floor: the test removes some samples
    assert 0.3 * hit.size < n_lit[False] and 0 < n_lit[True] < n_lit[False]


def test_emitter_hit_pdf_and_eval_match_jax(cornell, np_rng):
    """pdf_emitter_direction_hit (the MIS pdf of a BSDF-sampled light hit)
    and eval_emitter (one-sided area radiance) on rays aimed at the light
    from random points; rtol 1e-5."""
    sj, st = cornell
    n = 2000
    o = np_rng.uniform(-0.9, 0.9, (n, 3)).astype(np.float32)
    # targets on and around the light (y = 0.99, |x| <= 0.23, |z| <= 0.19)
    tgt = np.stack([np_rng.uniform(-0.4, 0.4, n), np.full(n, 0.99),
                    np_rng.uniform(-0.3, 0.3, n)], -1).astype(np.float32)
    d = tgt - o
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    inf = np.full(n, np.inf, np.float32)
    rj = RayJ(o=_vj(o), d=_vj(d), maxt=jnp.asarray(inf))
    rt = Ray(o=_vt(o), d=_vt(d), maxt=torch.as_tensor(inf))
    sij, aj = sj.compute_surface_interaction(rj,
                                             sj.ray_intersect_preliminary(rj))
    sit, at = st.compute_surface_interaction(rt,
                                             st.ray_intersect_preliminary(rt))
    emissive = np.asarray(aj["emitter"]) >= 0
    assert 0.2 < emissive.mean() < 0.9
    _close(sj.pdf_emitter_direction_hit(rj.o, sij, aj),
           st.pdf_emitter_direction_hit(rt.o, sit, at))
    ej, et = sj.eval_emitter(sij, aj), st.eval_emitter(sit, at)
    for comp in "xyz":
        _close(getattr(ej, comp), getattr(et, comp))
    assert float(et.x.max()) == pytest.approx(18.387)


def test_cornell_render_matches_jax(cornell):
    """32^2 at 4 spp, seed 5: per pixel against JAX (isclose 1e-3 on
    > 99.5 % of values, means rtol 1e-3), ray count within 1e-3; the JAX
    scene's leaves carried into the port render the same image."""
    sj, st = cornell
    img_j, rays_j = mj.render_with_stats(sj, seed=5, spp=4)
    img_j, rays_j = np.asarray(img_j), float(rays_j)
    for scene in (st, scene_from_arrays(*arrays_from_scene(sj),
                                        device="cpu")):
        img_t, rays_t = mt.render_with_stats(scene, seed=5, spp=4)
        img_t = img_t.numpy()
        assert img_t.shape == (32, 32, 3) and np.isfinite(img_t).all()
        assert np.isclose(img_t, img_j, rtol=1e-3, atol=1e-3).mean() > 0.995
        assert np.allclose(img_t.mean(), img_j.mean(), rtol=1e-3)
        assert abs(rays_t - rays_j) <= 1e-3 * rays_j


def _moment_render(d, spp, seed):
    """(mean XYZ, per-pixel XYZ variance) of the scene dict `d` rendered
    by the port's moment integrator around its own integrator on the CPU,
    read as tests/test_regression.py:50-62 reads it."""
    _, mean_xyz, var_xyz = chip_smoke.moment_mean_var(mt, d, spp, seed,
                                                      device="cpu")
    return mean_xyz, var_xyz


def test_cornell_z_test_against_reference():
    """tests/test_regression.py's Z-test (significance 0.01, Šidák) of the
    port's 32^2 Cornell (max_depth 4) at 256 spp against the stored 1024
    spp reference of the JAX package, with its outlier allowance."""
    ref = np.load(os.path.join(DATA, "ref_cornell_diffuse.npz"))
    mean, var = _moment_render(mt.cornell_box(32, 32, max_depth=4),
                               TEST_SPP, seed=3)
    fails, n_pix = _z_test(mean, var, TEST_SPP, ref["mean_xyz"],
                           ref["var_xyz"], REF_SPP)
    assert fails <= max(3, n_pix // 500), (fails, n_pix)
