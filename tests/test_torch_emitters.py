"""Port parity for the lights of ROADMAP item 4 and the shapes that carry
them: the sphere, disk and cylinder tessellations (scene arrays bit-equal
to the JAX loader's, the analytic ones refused), a sphere emitter's cone
NEE and its MIS pdf, ``directionalarea`` (zero on hits and in NEE), the
projector's textured frustum (``_eval_delta_emitter``) on 4,096 lanes,
the ``sunsky`` and ``timed_sunsky`` environments baked at load, renders
of each per pixel, PRB gradients of a sphere-lit and a projector-lit
scene against ``jax.grad``, ``traverse``/``update()`` of a projector row
and of a sphere light's vertices, ``convert.py`` both ways and XML
lowering. Inputs come from numpy seeds; JAX's renders run eagerly.
Every tolerance is stated at its assert."""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mitsuba3_tpu as mj
from mitsuba3_tpu.core import warp as warp_j
from mitsuba3_tpu.core.vec import Vec2 as Vec2J
from mitsuba3_tpu.core.vec import Vec3 as Vec3J
from mitsuba3_tpu.render.records import Ray as RayJ
from mitsuba3_tpu.render.scene import _RefPoint as RefJ
from mitsuba3_tpu.utils import xml as xml_j
from mitsuba3_tpu.utils.params import traverse as traverse_j

import chip_smoke
import mitsuba3_tpu_torch as mt
from mitsuba3_tpu_torch.convert import arrays_from_scene, scene_from_arrays
from mitsuba3_tpu_torch.core import warp as warp_t
from mitsuba3_tpu_torch.core.vec import Vec2, Vec3
from mitsuba3_tpu_torch.render.records import Ray
from mitsuba3_tpu_torch.render.scene import _RefPoint as RefT
from mitsuba3_tpu_torch.utils import xml as xml_t
from test_torch_prb import _grads_jax, _grads_port
from test_torch_xml import _equal_leaves, _plain

torch.set_num_threads(1)

N = 4096


def _vj(a):
    return Vec3J(jnp.asarray(a[:, 0]), jnp.asarray(a[:, 1]),
                 jnp.asarray(a[:, 2]))


def _vt(a):
    a = torch.as_tensor(a)
    return Vec3(a[:, 0], a[:, 1], a[:, 2])


def _close(a, b, mask=None, rtol=1e-5, atol=1e-6):
    a, b = np.asarray(a), b.detach().numpy()
    if mask is not None:
        a, b = a[mask], b[mask]
    np.testing.assert_allclose(b, a, rtol=rtol, atol=atol)


def _close3(vj, vt, mask=None, rtol=1e-5, atol=1e-6):
    for c in "xyz":
        _close(getattr(vj, c), getattr(vt, c), mask, rtol, atol)



def shapes_dict(mi, case):
    """A Cornell box (16^2) with tessellated shapes: `case` names them."""
    T = mi.ScalarTransform4f
    d = mi.cornell_box(16, 16, max_depth=4)
    light = {"type": "area", "radiance": {"type": "rgb", "value": [6, 5, 4]}}
    if case == "sphere":
        d["ball"] = {"type": "sphere", "center": [0.2, 0.3, 0.1],
                     "radius": 0.2, "emitter": light}
    elif case == "sphere to_world":
        d["ball"] = {"type": "sphere", "to_world": T().translate(
            [0.1, 0.4, 0]).rotate([0, 1, 1], 30).scale(0.15),
            "emitter": light}
    elif case == "ellipsoid":
        # a non-uniform scale: tessellated, but no cone row
        d["ball"] = {"type": "sphere", "to_world": T().translate(
            [0, 0.4, 0]).scale([0.2, 0.1, 0.2]), "emitter": light}
    elif case == "disk and cylinders":
        d["disk"] = {"type": "disk", "to_world": T().translate(
            [0, 0.98, 0]).rotate([1, 0, 0], 90).scale(0.3),
            "emitter": light}
        d["pipe"] = {"type": "cylinder", "radius": 0.1, "p0": [0.4, -1, 0.4],
                     "p1": [0.4, -0.4, 0.45], "flip_normals": True}
        d["oval"] = {"type": "cylinder", "to_world": T().translate(
            [-0.5, -1, 0.5]).scale([0.1, 0.2, 0.5])}
    return d


@pytest.mark.parametrize("case", ["sphere", "sphere to_world", "ellipsoid",
                                  "disk and cylinders"])
def test_tessellated_shape_arrays_bit_equal(case):
    """Every scene array and static field (em_sphere and its slots
    included) equals the JAX loader's."""
    sj = mj.load_dict(shapes_dict(mj, case))
    st = mt.load_dict(shapes_dict(mt, case), device="cpu")
    _equal_leaves(st, sj)
    # slot 0 is the Cornell box's own light
    assert st.em_sphere_slots == ((1,) if case.startswith("sphere") else ())
    assert (st.em_sphere is None) == (case != "sphere"
                                      and case != "sphere to_world")


@pytest.mark.parametrize("spec", [
    {"type": "sphere", "radius": 0.3},
    {"type": "disk", "to_world": [[0, 0, 2, 1], [0, 2, 0, 0], [-2, 0, 0, 0],
                                  [0, 0, 0, 1]]},
    {"type": "cylinder"}])
def test_analytic_shapes_refused(spec):
    """A sphere, disk or cylinder the JAX loader makes analytic (no
    emitter, no flip_normals, rigid uniform scale) is an analytic row in
    the port too: every scene array and static field equals JAX's, and the
    shape adds no face."""
    dj, dt = mj.cornell_box(8, 8), mt.cornell_box(8, 8)
    dj["thing"] = dt["thing"] = spec
    sj, st = mj.load_dict(dj), mt.load_dict(dt, device="cpu")
    _equal_leaves(st, sj)
    assert st.analytic_prims.shape[0] == 1
    assert st.faces.shape == mt.load_dict(mt.cornell_box(8, 8),
                                          device="cpu").faces.shape


def test_uniform_cone_matches_jax(np_rng):
    s = np_rng.uniform(0, 1, (N, 2)).astype(np.float32)
    cosmax = np_rng.uniform(-0.5, 0.999, N).astype(np.float32)
    vj = warp_j.square_to_uniform_cone(jnp.asarray(s), jnp.asarray(cosmax))
    vt = warp_t.square_to_uniform_cone(
        Vec2(torch.as_tensor(s[:, 0]), torch.as_tensor(s[:, 1])),
        torch.as_tensor(cosmax))
    for k, c in enumerate("xyz"):
        np.testing.assert_allclose(getattr(vt, c).numpy(),
                                   np.asarray(vj[..., k]), rtol=1e-5,
                                   atol=2e-6)
    pj = warp_j.square_to_uniform_cone_pdf(vj, jnp.asarray(cosmax))
    pt = warp_t.square_to_uniform_cone_pdf(vt, torch.as_tensor(cosmax))
    np.testing.assert_allclose(pt.numpy(), np.asarray(pj), rtol=1e-6)


@pytest.fixture(scope="module")
def sphere_scenes():
    return (mj.load_dict(chip_smoke.sphere_cornell_dict(mj, 16, 16, 4)),
            mt.load_dict(chip_smoke.sphere_cornell_dict(mt, 16, 16, 4),
                         device="cpu"))


def test_cone_nee_matches_jax(sphere_scenes, np_rng):
    """sample_emitter_direction_from on 4,096 points of the box (some
    inside the sphere, where the area branch stays): the cone's direction,
    point, normal, distance and pdf, and the weight. The direction, pdf
    and weight agree to rtol 1e-5, atol 2e-6 (the cone's sin/cos are an
    ulp apart between the packages, ROADMAP queue 3); the point on the
    sphere, its distance and normal to atol 5e-4: t = b - sqrt(disc)
    cancels near the cone's rim, where that ulp of the direction grows to
    5e-5 in the point and, over the radius 0.18, to 2.5e-4 in the
    normal."""
    sj, st = sphere_scenes
    p = np_rng.uniform(-0.95, 0.95, (N, 3)).astype(np.float32)
    p[:64] = [0.0, 0.72, 0.0] + np_rng.uniform(-0.1, 0.1, (64, 3))
    s1 = np_rng.uniform(0, 1, N).astype(np.float32)
    s2 = np_rng.uniform(0, 1, (N, 2)).astype(np.float32)
    dsj, wj = sj.sample_emitter_direction_from(
        _vj(p), jnp.asarray(s1), Vec2J(jnp.asarray(s2[:, 0]),
                                       jnp.asarray(s2[:, 1])))
    dst, wt = st.sample_emitter_direction_from(
        _vt(p), torch.as_tensor(s1), Vec2(torch.as_tensor(s2[:, 0]),
                                          torch.as_tensor(s2[:, 1])))
    np.testing.assert_array_equal(np.asarray(dsj.emitter_index),
                                  dst.emitter_index.numpy())
    _close(dsj.pdf, dst.pdf, atol=2e-6)
    _close3(dsj.d, dst.d, atol=2e-6)
    _close3(wj, wt, atol=2e-6)
    _close(dsj.dist, dst.dist, rtol=0, atol=5e-4)
    _close3(dsj.p, dst.p, rtol=0, atol=5e-4)
    _close3(dsj.n, dst.n, rtol=0, atol=5e-4)
    # the cone's pdf is 1 / (E * solid angle) from outside the sphere
    assert np.isclose(dst.pdf.numpy()[64:], 1.0 / (
        1.0 * 2 * np.pi * (1 - np.sqrt(np.maximum(1 - 0.18 ** 2 / np.sum(
            (p[64:] - [0, 0.72, 0]) ** 2, 1), 0)))), rtol=1e-2).mean() > 0.99


def test_sphere_hit_pdf_matches_jax(sphere_scenes, np_rng):
    """pdf_emitter_direction_hit (the cone's density on hits of the
    sphere from outside) and eval_emitter on rays aimed at the sphere;
    rtol 1e-5."""
    sj, st = sphere_scenes
    o = np_rng.uniform(-0.9, 0.9, (N, 3)).astype(np.float32)
    tgt = np.asarray([0.0, 0.72, 0.0]) + np_rng.uniform(-0.25, 0.25, (N, 3))
    d = (tgt - o).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    inf = np.full(N, np.inf, np.float32)
    rj = RayJ(o=_vj(o), d=_vj(d), maxt=jnp.asarray(inf))
    rt = Ray(o=_vt(o), d=_vt(d), maxt=torch.as_tensor(inf))
    sij, aj = sj.compute_surface_interaction(rj,
                                             sj.ray_intersect_preliminary(rj))
    sit, at = st.compute_surface_interaction(rt,
                                             st.ray_intersect_preliminary(rt))
    assert 0.3 < (np.asarray(aj["emitter"]) >= 0).mean() < 0.95
    _close(sj.pdf_emitter_direction_hit(rj.o, sij, aj),
           st.pdf_emitter_direction_hit(rt.o, sit, at))
    _close3(sj.eval_emitter(sij, aj), st.eval_emitter(sit, at))


def test_directionalarea_gives_zeros_like_jax(np_rng):
    """A directionalarea emitter is never seen by a sampled ray and adds
    nothing to NEE: eval_emitter is 0 on its hits and its NEE lanes carry
    weight 0 (the disk's do not), as in JAX; rtol 1e-5."""
    make = chip_smoke.directionalarea_cornell_dict
    sj = mj.load_dict(make(mj, 16, 16, 4))
    st = mt.load_dict(make(mt, 16, 16, 4), device="cpu")
    assert st.em_directional == tuple(sj.em_directional) == (0,)
    p = np_rng.uniform(-0.9, 0.9, (N, 3)).astype(np.float32)
    s1 = np_rng.uniform(0, 1, N).astype(np.float32)
    s2 = np_rng.uniform(0, 1, (N, 2)).astype(np.float32)
    dsj, wj = sj.sample_emitter_direction_from(
        _vj(p), jnp.asarray(s1), Vec2J(jnp.asarray(s2[:, 0]),
                                       jnp.asarray(s2[:, 1])))
    dst, wt = st.sample_emitter_direction_from(
        _vt(p), torch.as_tensor(s1), Vec2(torch.as_tensor(s2[:, 0]),
                                          torch.as_tensor(s2[:, 1])))
    _close(dsj.pdf, dst.pdf)
    _close3(wj, wt)
    on_dir = dst.emitter_index.numpy() == 0
    assert 0.2 < on_dir.mean() < 0.8
    assert (wt.to_array().numpy()[on_dir] == 0).all()
    assert (wt.to_array().numpy()[~on_dir].max(1) > 0).mean() > 0.3
    # rays straight up into the ceiling light
    o = np.stack([np_rng.uniform(-0.2, 0.2, N), np.full(N, 0.5),
                  np_rng.uniform(-0.15, 0.15, N)], -1).astype(np.float32)
    up = np.tile(np.float32([0, 1, 0]), (N, 1))
    inf = np.full(N, np.inf, np.float32)
    rj = RayJ(o=_vj(o), d=_vj(up), maxt=jnp.asarray(inf))
    rt = Ray(o=_vt(o), d=_vt(up), maxt=torch.as_tensor(inf))
    sij, aj = sj.compute_surface_interaction(rj,
                                             sj.ray_intersect_preliminary(rj))
    sit, at = st.compute_surface_interaction(rt,
                                             st.ray_intersect_preliminary(rt))
    assert (at["emitter"].numpy() == 0).mean() > 0.9
    ej, et = sj.eval_emitter(sij, aj), st.eval_emitter(sit, at)
    _close3(ej, et)
    assert float(et.to_array().abs().max()) == 0.0


@pytest.fixture(scope="module")
def projector_scenes():
    make = chip_smoke.projector_cornell_dict
    return (mj.load_dict(make(mj, 16, 16, 4, 24)),
            mt.load_dict(make(mt, 16, 16, 4, 24), device="cpu"))


def test_projector_eval_delta_matches_jax(projector_scenes, np_rng):
    """_eval_delta_emitter of the projector slot at 4,096 points (inside
    and outside its frustum, behind it): direction, point, normal, the
    bitmap-weighted irradiance over dist^2, distance; rtol 1e-5."""
    sj, st = projector_scenes
    assert st.projector_textures == (1,)
    p = np_rng.uniform(-1.0, 1.0, (N, 3)).astype(np.float32)
    k = np.zeros(N, np.int32)
    outj = sj._eval_delta_emitter(RefJ(p=_vj(p), t=jnp.asarray(p[:, 0])),
                                  jnp.asarray(k))
    outt = st._eval_delta_emitter(RefT(p=_vt(p), t=torch.as_tensor(p[:, 0])),
                                  torch.as_tensor(k))
    for a, b in zip(outj[:4], outt[:4]):
        _close3(a, b)
    _close(outj[4], outt[4])
    lit = outt[3].any_positive().numpy()
    assert 0.1 < lit.mean() < 0.9


def test_sunsky_env_data_matches_jax(monkeypatch):
    """sunsky and timed_sunsky baked at load: env_data [128, 256, 3],
    env_scale and the warp tables equal JAX's (the same numpy). The small
    terrain gets cellserve on both sides."""
    monkeypatch.setenv("MI3T_ACCEL", "cells")
    for timed in (False, True):
        dj = chip_smoke.sunsky_dict(chip_smoke.small_terrain_dict,
                                    mj.ScalarTransform4f, timed, width=8)
        dt = chip_smoke.sunsky_dict(chip_smoke.small_terrain_dict,
                                    mt.ScalarTransform4f, timed, width=8)
        for spec in (dt["env"], dict(dt["env"], turbidity=5.5, sun_scale=2,
                                     sky_scale=0.5)
                     if not timed else dict(dt["env"], year=2021, month=1,
                                            latitude=-33.9, longitude=18.4,
                                            timezone=2.0, minute=15.0)):
            sj = mj.load_dict(dict(dj, env=spec))
            st = mt.load_dict(dict(dt, env=spec), device="cpu")
            assert tuple(st.env_data.shape) == (128, 256, 3)
            np.testing.assert_array_equal(st.env_data.numpy(),
                                          np.asarray(sj.env_data))
            assert float(st.env_scale) == float(sj.env_scale)
            for name in ("density", "marg_cdf", "cond_cdf"):
                np.testing.assert_array_equal(
                    getattr(st.env_warp, name).numpy(),
                    np.asarray(getattr(sj.env_warp, name)))


def sunsky_yard(mi, timed):
    """A floor and a cube under the sky (16^2): the environment seen
    directly and sampled by NEE."""
    T = mi.ScalarTransform4f
    return {"type": "scene", "integrator": {"type": "path", "max_depth": 2},
            "sensor": {"type": "perspective", "fov": 60.0,
                       "to_world": T().look_at(origin=[0, 1.2, 4],
                                               target=[0, 0.5, 0],
                                               up=[0, 1, 0]),
                       "film": {"width": 16, "height": 16}},
            "floor": {"type": "rectangle", "to_world": T().rotate(
                [1, 0, 0], -90).scale(5)},
            "box": {"type": "cube", "to_world": T().translate(
                [0, 0.5, 0]).scale(0.5)},
            "sky": ({"type": "timed_sunsky", "hour": 9.0} if timed
                    else {"type": "sunsky", "sun_direction": [0.4, 0.7, 0.3]})}


def every_light_dict(mi, integrator="path"):
    """One Cornell box (16^2, max_depth 2) with every new light: the
    sphere light (cone NEE), the directionalarea ceiling light and the
    disk of ``directionalarea_cornell_dict``, the projector of
    ``projector_cornell_dict`` (a 24^2 bitmap) and the cylinders of
    ``shapes_dict``."""
    d = chip_smoke.directionalarea_cornell_dict(mi, 16, 16, 2, integrator)
    d["ball"] = chip_smoke.sphere_cornell_dict(mi, 16, 16, 2)["light"]
    d["projector"] = chip_smoke.projector_cornell_dict(
        mi, 16, 16, 2, 24)["projector"]
    tubes = shapes_dict(mi, "disk and cylinders")
    d["pipe"], d["oval"] = tubes["pipe"], tubes["oval"]
    return d


SCENES = {
    "every light": lambda mi: every_light_dict(mi),
    "every light direct": lambda mi: every_light_dict(mi, "direct"),
    "sunsky": lambda mi: sunsky_yard(mi, False),
    "timed_sunsky": lambda mi: sunsky_yard(mi, True),
}


@pytest.mark.parametrize("name", sorted(SCENES))
def test_light_renders_match_jax(name):
    """16^2, 4 spp, seed 5, max_depth 2, per pixel: allclose rtol 1e-5,
    atol 1e-5 (4e-6 apart at most here), ray counts equal."""
    sj = mj.load_dict(SCENES[name](mj))
    st = mt.load_dict(SCENES[name](mt), device="cpu")
    with jax.disable_jit():
        img_j, rays_j = mj.render_with_stats(sj, seed=5, spp=4)
    img_t, rays_t = mt.render_with_stats(st, seed=5, spp=4)
    img_j, img_t = np.asarray(img_j), img_t.numpy()
    assert img_t.shape == (16, 16, 3) and np.isfinite(img_t).all()
    assert img_t.mean() > 0
    np.testing.assert_allclose(img_t, img_j, rtol=1e-5, atol=1e-5)
    assert rays_t == float(rays_j)


def sphere_projector_dict(mi):
    """The sphere-lit Cornell (8^2, prb, max_depth 3) with the projector
    of ``chip_smoke.projector_cornell_dict`` (an 8^2 bitmap) beside it."""
    d = chip_smoke.sphere_cornell_dict(mi, 8, 8, 3, "prb")
    d["projector"] = chip_smoke.projector_cornell_dict(mi, 8, 8, 3,
                                                       8)["projector"]
    return d


def test_prb_light_grads_match_jax():
    """d mean(render) / dθ of an 8^2, 4 spp, max_depth 3 PRB render of a
    sphere-lit and projector-lit Cornell (BSDF rows, the sphere's
    radiance, the vertices, the projector's row and its texture) within
    1e-4 of the largest entry of jax.grad's per table (the texture per
    texel), every entry finite."""
    names = ("bsdf_params", "em_radiance", "vertices", "de_params",
             "textures")
    sj = mj.load_dict(sphere_projector_dict(mj))
    st = mt.load_dict(sphere_projector_dict(mt), device="cpu")
    gj = _grads_jax(sj, names, 4, 3)
    gt = _grads_port(st, names, 4, 3)
    for k in names:
        pairs = (zip(gj[k], gt[k]) if isinstance(gj[k], tuple)
                 else [(gj[k], gt[k])])
        for a, b in pairs:
            a, b = np.asarray(a), b.numpy()
            assert a.shape == b.shape and np.isfinite(b).all(), k
            scale = np.abs(a).max()
            assert scale > 0, k
            np.testing.assert_allclose(b, a, rtol=0, atol=1e-4 * scale,
                                       err_msg=k)


def test_traverse_update_of_lights_matches_jax(projector_scenes,
                                               sphere_scenes):
    """A projector row edit (its scale and texture id) through traverse:
    the port's rows, its projector texture table and the render follow
    JAX's; a sphere light's vertices moved: em_sphere stays as loaded
    in both packages."""
    sj, st = projector_scenes
    pj, pt = traverse_j(sj), mt.traverse(st)
    rows = np.asarray(sj.de_params).copy()
    rows[0, 3:6] *= 0.5
    rows[0, 12] = 0.0       # the texture dropped: a uniform projector
    pj["de_params"] = jnp.asarray(rows)
    pt["de_params"] = rows
    uj, ut = pj.update(), pt.update()
    assert st.projector_textures == (1,) and ut.projector_textures == ()
    np.testing.assert_array_equal(ut.de_params.numpy(),
                                  np.asarray(uj.de_params))
    # the uniform projector: its irradiance is the row's, no lookup
    k = torch.zeros(64, dtype=torch.int32)
    p = torch.linspace(-0.5, 0.5, 64)
    rad = ut._eval_delta_emitter(RefT(p=Vec3(p, p * 0 - 0.9, p * 0.3),
                                      t=p), k)[3]
    radj = uj._eval_delta_emitter(RefJ(p=Vec3J(
        jnp.asarray(p.numpy()), jnp.asarray(p.numpy() * 0 - 0.9),
        jnp.asarray(p.numpy() * 0.3)), t=jnp.asarray(p.numpy())),
        jnp.zeros(64, jnp.int32))[3]
    _close3(radj, rad)
    assert float(rad.x.max()) > 0
    sj, st = sphere_scenes
    pj, pt = traverse_j(sj), mt.traverse(st)
    v = np.asarray(sj.vertices) + np.float32([0.0, -0.1, 0.0])
    pj["vertices"] = jnp.asarray(v)
    pt["vertices"] = v
    uj, ut = pj.update(), pt.update()
    np.testing.assert_array_equal(ut.em_sphere.numpy(),
                                  np.asarray(uj.em_sphere))
    np.testing.assert_array_equal(ut.em_sphere.numpy(), st.em_sphere.numpy())
    np.testing.assert_array_equal(ut.ef_cdf.numpy(), np.asarray(uj.ef_cdf))


def test_convert_carries_lights(sphere_scenes, projector_scenes):
    """JAX's leaves carried into the port (em_sphere, its slots, the
    directionalarea slots, the projector row and texture) render as the
    port's own scene does; the port's arrays round-trip."""
    dirarea = (mj.load_dict(chip_smoke.directionalarea_cornell_dict(
        mj, 8, 8, 3)), mt.load_dict(chip_smoke.directionalarea_cornell_dict(
            mt, 8, 8, 3), device="cpu"))
    for sj, st in (sphere_scenes, projector_scenes, dirarea):
        carried = scene_from_arrays(*arrays_from_scene(sj), device="cpu")
        again = scene_from_arrays(*arrays_from_scene(st), device="cpu")
        for s in (carried, again):
            assert (s.em_sphere_slots, s.em_directional,
                    s.projector_textures) == (st.em_sphere_slots,
                                              st.em_directional,
                                              st.projector_textures)
            np.testing.assert_array_equal(
                mt.render(s, seed=1, spp=2).numpy(),
                mt.render(st, seed=1, spp=2).numpy())


def test_xml_lights_lower_as_jax(tmp_path):
    """Sphere, disk and cylinder shapes with area and directionalarea
    emitters, a projector with a bitmap file and sunsky/timed_sunsky
    environments lower from XML to JAX's dicts and load to its leaves."""
    np.save(tmp_path / "proj.npy", chip_smoke.projector_irradiance(8))
    shapes = ('<shape type="sphere"><point name="center" x="0" y="0.5" '
              'z="0"/><float name="radius" value="0.2"/><emitter '
              'type="area"><rgb name="radiance" value="4, 3, 2"/></emitter>'
              '</shape><shape type="disk"><transform name="to_world">'
              '<scale value="0.3"/><translate y="0.9"/></transform><emitter '
              'type="directionalarea"><rgb name="radiance" value="2"/>'
              '</emitter></shape><shape type="cylinder"><float name="radius"'
              ' value="0.1"/><boolean name="flip_normals" value="true"/>'
              '</shape><shape type="rectangle"><transform name="to_world">'
              '<rotate x="1" angle="-90"/><translate y="-1"/></transform>'
              '</shape>')
    skies = ('<emitter type="sunsky"><float name="turbidity" value="4"/>'
             '</emitter>',
             '<emitter type="timed_sunsky"><float name="hour" value="8.5"/>'
             '<integer name="day" value="3"/></emitter>',
             '<emitter type="projector"><float name="fov" value="50"/>'
             '<float name="scale" value="5"/><texture type="bitmap" '
             'name="irradiance"><string name="filename" value="proj.npy"/>'
             '</texture><transform name="to_world"><lookat origin="0, 0.9, 0"'
             ' target="0, -1, 0" up="0, 0, 1"/></transform></emitter>')
    for k, sky in enumerate(skies):
        path = tmp_path / f"scene{k}.xml"
        path.write_text('<scene version="3.0.0"><sensor type="perspective">'
                        '<film type="hdrfilm"><integer name="width" '
                        'value="8"/><integer name="height" value="8"/>'
                        '</film></sensor>' + shapes + sky + '</scene>')
        dj = xml_j.parse_file(str(path))
        dt = xml_t.parse_file(str(path))
        assert _plain(dt) == _plain(dj)
        _equal_leaves(mt.load_file(str(path), device="cpu"),
                      mj.load_dict(dj))
