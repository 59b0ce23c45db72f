"""Port parity, scene: the port's ``load_dict`` gives the JAX package's
leaves (for the small terrain and the full terrain64k dict, and the rows
of point, spot and directional emitters), ``scene_from_arrays`` carries a
scene across and round-trips, and the scene's shading functions
(delta-emitter evaluation included) agree with JAX's on random inputs."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mitsuba3_tpu as mj
from mitsuba3_tpu import bsdfs as j_bsdfs
from mitsuba3_tpu.core.vec import Vec2 as JVec2
from mitsuba3_tpu.core.vec import Vec3 as JVec3
from mitsuba3_tpu.render import records as j_records

import chip_smoke
import mitsuba3_tpu_torch as mt
from mitsuba3_tpu_torch import bsdfs as t_bsdfs
from mitsuba3_tpu_torch.ad import prb
from mitsuba3_tpu_torch.convert import arrays_from_scene, scene_from_arrays
from mitsuba3_tpu_torch.core.vec import Vec2 as TVec2
from mitsuba3_tpu_torch.core.vec import Vec3 as TVec3
from mitsuba3_tpu_torch.render import records as t_records

torch.set_num_threads(1)
N = 1024
FLOAT_TOL = dict(rtol=1e-6, atol=1e-6)
SHADE_TOL = dict(rtol=1e-5, atol=1e-6)


def load_both(monkeypatch, make_dict):
    """The same dict loaded by JAX (cellserve accel, as on the TPU) and by
    the port on the CPU."""
    monkeypatch.setenv("MI3T_ACCEL", "cells")
    return (mj.load_dict(make_dict(mj.ScalarTransform4f)),
            mt.load_dict(make_dict(mt.ScalarTransform4f), device="cpu"))


def assert_arrays_equal(got, want):
    assert sorted(got) == sorted(want)
    for name, w in want.items():
        g = got[name]
        assert g.shape == w.shape, name
        assert g.dtype == w.dtype, (name, g.dtype, w.dtype)
        if np.issubdtype(w.dtype, np.floating):
            np.testing.assert_allclose(g, w, err_msg=name, **FLOAT_TOL)
        else:
            np.testing.assert_array_equal(g, w, err_msg=name)


@pytest.mark.parametrize("make_dict", [chip_smoke.small_terrain_dict,
                                       chip_smoke.terrain64k_dict],
                         ids=["small_terrain", "terrain64k"])
def test_load_dict_leaves_equal_jax(monkeypatch, make_dict):
    j_scene, t_scene = load_both(monkeypatch, make_dict)
    j_arrays, j_meta = arrays_from_scene(j_scene)
    t_arrays, t_meta = arrays_from_scene(t_scene)
    assert_arrays_equal(t_arrays, j_arrays)
    assert t_meta == j_meta


def test_scene_from_arrays_round_trips(monkeypatch):
    j_scene, t_scene = load_both(monkeypatch, chip_smoke.small_terrain_dict)
    arrays, meta = arrays_from_scene(t_scene)
    again = scene_from_arrays(arrays, meta, "cpu")
    assert_arrays_equal(arrays_from_scene(again)[0], arrays)
    assert arrays_from_scene(again)[1] == meta
    # a scene carried over from JAX's leaves holds exactly those leaves
    j_arrays, j_meta = arrays_from_scene(j_scene)
    carried = scene_from_arrays(j_arrays, j_meta, "cpu")
    assert_arrays_equal(arrays_from_scene(carried)[0], j_arrays)
    assert torch.equal(carried.face_table, t_scene.face_table)


def random_hits(np_rng, scene):
    """Random rays and preliminary hits on real faces (some misses)."""
    n_faces = int((np.asarray(scene.face_shape) >= 0).sum())
    prim = np_rng.integers(0, n_faces, N).astype(np.int32)
    prim[::17] = -1
    b = np_rng.random((N, 2)).astype(np.float32)
    flip = b.sum(1) > 1
    b[flip] = 1 - b[flip]
    o = np_rng.uniform(-3, 3, (N, 3)).astype(np.float32)
    o[:, 2] = np.abs(o[:, 2]) + 2
    d = np_rng.normal(size=(N, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    t = np_rng.uniform(0.5, 5, N).astype(np.float32)
    return prim, b, o, d, t


def j_inputs(prim, b, o, d, t):
    ray = j_records.Ray.make(JVec3(*(jnp.asarray(o[:, i]) for i in range(3))),
                             JVec3(*(jnp.asarray(d[:, i]) for i in range(3))))
    pi = j_records.PreliminaryIntersection(
        t=jnp.asarray(t), prim_uv=JVec2(jnp.asarray(b[:, 0]),
                                        jnp.asarray(b[:, 1])),
        prim_index=jnp.asarray(prim),
        shape_index=jnp.asarray(np.where(prim >= 0, prim, -1)))
    return ray, pi


def t_inputs(prim, b, o, d, t):
    def c(a, i):
        return torch.as_tensor(np.ascontiguousarray(a[:, i]))
    ray = t_records.Ray.make(TVec3(c(o, 0), c(o, 1), c(o, 2)),
                             TVec3(c(d, 0), c(d, 1), c(d, 2)))
    pi = t_records.PreliminaryIntersection(
        t=torch.as_tensor(t), prim_uv=TVec2(c(b, 0), c(b, 1)),
        prim_index=torch.as_tensor(prim),
        shape_index=torch.as_tensor(np.where(prim >= 0, prim, -1)))
    return ray, pi


def close(t_val, j_val, tol=SHADE_TOL):
    if hasattr(j_val, "x"):
        for c in "xyz" if hasattr(j_val, "z") else "xy":
            close(getattr(t_val, c), getattr(j_val, c), tol)
        return
    j_np = np.asarray(j_val)
    t_np = t_val.numpy()
    if np.issubdtype(j_np.dtype, np.floating):
        np.testing.assert_allclose(t_np, j_np, **tol)
    else:
        np.testing.assert_array_equal(t_np, j_np)


@pytest.fixture
def shading(monkeypatch, np_rng):
    j_scene, t_scene = load_both(monkeypatch, chip_smoke.small_terrain_dict)
    inputs = random_hits(np_rng, j_scene)
    j_ray, j_pi = j_inputs(*inputs)
    t_ray, t_pi = t_inputs(*inputs)
    j_si, j_attrs = j_scene.compute_surface_interaction(j_ray, j_pi)
    t_si, t_attrs = t_scene.compute_surface_interaction(t_ray, t_pi)
    return j_scene, t_scene, j_si, j_attrs, t_si, t_attrs


def test_compute_surface_interaction_matches_jax(shading):
    _, _, j_si, j_attrs, t_si, t_attrs = shading
    for name in ("p", "t", "n", "uv", "wi", "shape_index", "prim_index"):
        close(getattr(t_si, name), getattr(j_si, name))
    for axis in ("s", "t", "n"):
        close(getattr(t_si.sh_frame, axis), getattr(j_si.sh_frame, axis))
    for name in ("bsdf", "emitter", "inv_total_area"):
        close(t_attrs[name], j_attrs[name])


@pytest.mark.parametrize("test_visibility", [False, True])
def test_sample_emitter_direction_matches_jax(shading, np_rng,
                                              test_visibility):
    j_scene, t_scene, j_si, _, t_si, _ = shading
    s1 = np_rng.random(N).astype(np.float32)
    s2 = np_rng.random((N, 2)).astype(np.float32)
    active = np.array(j_si.is_valid())
    j_ds, j_w = j_scene.sample_emitter_direction(
        j_si, jnp.asarray(s1), JVec2(jnp.asarray(s2[:, 0]),
                                     jnp.asarray(s2[:, 1])),
        active=jnp.asarray(active), test_visibility=test_visibility)
    t_ds, t_w = t_scene.sample_emitter_direction(
        t_si, torch.as_tensor(s1),
        TVec2(torch.as_tensor(np.ascontiguousarray(s2[:, 0])),
              torch.as_tensor(np.ascontiguousarray(s2[:, 1]))),
        active=torch.as_tensor(active), test_visibility=test_visibility)
    for name in ("p", "n", "d", "pdf", "dist", "delta", "emitter_index"):
        close(getattr(t_ds, name), getattr(j_ds, name))
    close(t_w, j_w)
    if test_visibility:
        assert (t_ds.pdf.numpy() == 0).any()   # some samples are shadowed


def test_diffuse_sample_and_eval_match_jax(shading, np_rng):
    j_scene, t_scene, j_si, j_attrs, t_si, t_attrs = shading
    s1 = np_rng.random(N).astype(np.float32)
    s2 = np_rng.random((N, 2)).astype(np.float32)
    wo = np_rng.normal(size=(N, 3)).astype(np.float32)
    wo /= np.linalg.norm(wo, axis=1, keepdims=True)
    j_bs, j_w = j_bsdfs.sample(j_scene, j_attrs["bsdf"], j_si,
                               jnp.asarray(s1),
                               JVec2(jnp.asarray(s2[:, 0]),
                                     jnp.asarray(s2[:, 1])))
    t_bs, t_w = t_bsdfs.sample(
        t_scene, t_attrs["bsdf"], t_si, torch.as_tensor(s1),
        TVec2(torch.as_tensor(np.ascontiguousarray(s2[:, 0])),
              torch.as_tensor(np.ascontiguousarray(s2[:, 1]))))
    for name in ("wo", "pdf", "eta", "sampled_type", "sampled_component"):
        close(getattr(t_bs, name), getattr(j_bs, name))
    close(t_w, j_w)
    j_val, j_pdf = j_bsdfs.eval_pdf(
        j_scene, j_attrs["bsdf"], j_si,
        JVec3(*(jnp.asarray(wo[:, i]) for i in range(3))))
    t_val, t_pdf = t_bsdfs.eval_pdf(
        t_scene, t_attrs["bsdf"], t_si,
        TVec3(*(torch.as_tensor(np.ascontiguousarray(wo[:, i]))
                for i in range(3))))
    close(t_val, j_val)
    close(t_pdf, j_pdf)
    flags_j = np.asarray(j_bsdfs.lane_flags(j_scene.bsdf_types,
                                            j_attrs["bsdf"],
                                            j_scene.bsdf_flags))
    flags_t = t_bsdfs.lane_flags(t_scene.bsdf_types, t_attrs["bsdf"],
                                 t_scene.bsdf_flags).numpy()
    np.testing.assert_array_equal(flags_t, flags_j)


def test_flip_for_twosided_matches_jax(shading, np_rng):
    """The two-sided adapter's frame flip, on rows with and without the
    two-sided flag ([16])."""
    _, _, j_si, _, t_si, _ = shading
    params = np.zeros((t_bsdfs.N_PARAMS, N), np.float32)
    params[16] = np_rng.integers(0, 2, N)
    j_sf, j_sgn = j_bsdfs.flip_for_twosided(jnp.asarray(params), j_si)
    t_sf, t_sgn = t_bsdfs.flip_for_twosided(torch.as_tensor(params), t_si)
    close(t_sgn, j_sgn)
    close(t_sf.wi, j_sf.wi)
    assert (t_sgn.numpy() < 0).any() and (t_sgn.numpy() > 0).any()


# ---------------------------------------------------------------------------
# Point and spot delta emitters
# ---------------------------------------------------------------------------

def delta_scene_dict(transform, **lights):
    """A floor rectangle under the given delta emitters (dense path)."""
    return {
        "type": "scene",
        "integrator": {"type": "path", "max_depth": 3},
        "sensor": {"type": "perspective", "fov": 40.0,
                   "to_world": transform().look_at(
                       origin=[0, 1, -3], target=[0, 0, 0], up=[0, 1, 0]),
                   "film": {"width": 8, "height": 8}},
        "floor": {"type": "rectangle",
                  "to_world": transform().rotate([1, 0, 0], -90).scale(2.0),
                  "bsdf": {"type": "diffuse"}},
        **lights,
    }


DELTA_LIGHTS = {
    "point": lambda T: {"type": "point", "position": [0.2, 1.5, -0.1],
                        "intensity": {"type": "rgb", "value": [2, 3, 4]}},
    # to_world places the light; the position is ignored
    "point_to_world": lambda T: {
        "type": "point", "position": [9, 9, 9],
        "to_world": T().translate([0.3, 1.2, 0.4]), "intensity": 5.0},
    "spot": lambda T: {"type": "spot", "position": [0, 2, 0],
                       "direction": [0.1, -1, 0.2], "cutoff_angle": 35.0,
                       "intensity": {"type": "rgb", "value": [7, 6, 5]}},
    "spot_to_world": lambda T: {
        "type": "spot", "to_world": T().look_at(
            origin=[1, 2, -1], target=[0, 0, 0], up=[0, 1, 0]),
        "cutoff_angle": 25.0, "beam_width": 10.0, "intensity": 3.0},
    "directional": lambda T: {"type": "directional",
                              "direction": [0.3, -1, 0.2],
                              "irradiance": 2.0},
}


@pytest.mark.parametrize("light", sorted(DELTA_LIGHTS))
def test_delta_emitter_rows_equal_jax(light):
    """Each delta emitter's de_params row, beside a point light, and the
    scene's delta_emitter_types bit-equal to the JAX loader's."""
    def make(T):
        return delta_scene_dict(T, lamp=DELTA_LIGHTS[light](T),
                                bulb=DELTA_LIGHTS["point"](T))
    j_scene = mj.load_dict(make(mj.ScalarTransform4f))
    t_scene = mt.load_dict(make(mt.ScalarTransform4f), device="cpu")
    np.testing.assert_array_equal(t_scene.de_params.numpy(),
                                  np.asarray(j_scene.de_params))
    assert t_scene.delta_emitter_types == tuple(j_scene.delta_emitter_types)
    assert t_scene.n_emitters == j_scene.n_emitters == 2


def test_eval_delta_emitter_matches_jax(np_rng):
    """Direction, position, normal, radiance (1/dist² and the spot's
    falloff folded in) and distance toward point, spot and directional
    slots from random surface points, rtol 1e-6. The one exception is a
    spot's radiance inside its transition band (0 < falloff < 1): there
    the falloff is (cutoff - acos(cos θ)) / (cutoff - beam), which turns
    the one-ulp difference of the two packages' rsqrt (they agree on
    ~64 % of float32 inputs) into up to ~20 ulp, so those lanes are held
    at rtol 1e-4."""
    from mitsuba3_tpu.render.scene import _RefPoint

    lights = {name: DELTA_LIGHTS[name] for name in
              ("point", "spot", "spot_to_world", "directional")}

    def make(T):
        return delta_scene_dict(T, **{k: f(T) for k, f in lights.items()})
    j_scene = mj.load_dict(make(mj.ScalarTransform4f))
    t_scene = mt.load_dict(make(mt.ScalarTransform4f), device="cpu")
    p = np_rng.uniform(-2, 2, (N, 3)).astype(np.float32)
    p[:, 1] = np_rng.uniform(-0.5, 0.5, N)
    k = np_rng.integers(0, len(lights), N).astype(np.int32)
    t = np.ones(N, np.float32)
    j_out = j_scene._eval_delta_emitter(
        _RefPoint(p=JVec3(*(jnp.asarray(p[:, i]) for i in range(3))),
                  t=jnp.asarray(t)), jnp.asarray(k))
    t_out = t_scene._eval_delta_emitter(
        prb._RefPoint(p=TVec3(*(torch.as_tensor(np.ascontiguousarray(
            p[:, i])) for i in range(3))), t=torch.as_tensor(t)),
        torch.as_tensor(k))
    for tv, jv in zip(t_out[:3] + t_out[4:], j_out[:3] + j_out[4:]):
        close(tv, jv, FLOAT_TOL)
    # the spot lanes' falloff, recomputed from the port's own outputs
    de = t_scene.de_params.numpy()[k]
    d = np.stack([t_out[0].x, t_out[0].y, t_out[0].z], 1)
    cos_t = -(d * de[:, 6:9]).sum(1)
    band = (np.isin(k, [1, 2]) & (cos_t > de[:, 9])
            & ((de[:, 10] - np.arccos(np.clip(cos_t, -1, 1))) * de[:, 11]
               < 1.0))
    for c in "xyz":
        tv = getattr(t_out[3], c).numpy()
        jv = np.asarray(getattr(j_out[3], c))
        np.testing.assert_allclose(tv[~band], jv[~band], **FLOAT_TOL)
        np.testing.assert_allclose(tv[band], jv[band], rtol=1e-4, atol=0)
    rad = t_out[3].x.numpy()
    spot_lanes = np.isin(k, [1, 2])
    # spot lanes outside the cone, in the band and in the full beam
    assert (rad[spot_lanes] == 0).any() and band.sum() >= 8
    assert (rad[spot_lanes & ~band] > 0).any()
