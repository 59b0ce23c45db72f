"""Port parity for path replay backpropagation (``ad/prb.py``): the PRB
primal equals the path tracer's image; PRB gradients of every θ table
match ``jax.grad`` through the JAX ``prb`` on a small Cornell box (dense
intersector, area light) and on the small terrain (cellserve, whose
queries the replay re-issues; the port's plain K1 against JAX's
reference serve); the replay issues the primal's rays; and the backward
is one autograd.Function node that keeps no graph across bounces. Also
the delta lights' rows (point and spot) against ``jax.grad``."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mitsuba3_tpu as mj
from mitsuba3_tpu import sensors as sensors_j
from mitsuba3_tpu.ad import prb as prb_j
from mitsuba3_tpu.core.vec import Vec2 as Vec2J
from mitsuba3_tpu.render import sampler as sampler_j

import chip_smoke
import mitsuba3_tpu_torch as mt
from mitsuba3_tpu_torch import sensors
from mitsuba3_tpu_torch.ad import prb
from mitsuba3_tpu_torch.convert import arrays_from_scene, scene_from_arrays
from mitsuba3_tpu_torch.core import gather
from mitsuba3_tpu_torch.core.vec import Vec2, Vec3
from mitsuba3_tpu_torch.render import sampler as sampler_mod

torch.set_num_threads(1)
CORNELL_THETA = ("bsdf_params", "em_radiance", "textures", "env_data",
                 "vertices")
TERRAIN_THETA = ("bsdf_params", "env_data", "de_params")


def _prb(d):
    return chip_smoke._prb_dict(d)


@pytest.fixture(scope="module")
def cornell():
    """(JAX scene, port scene) of a 16^2 Cornell box, prb, max_depth 3."""
    return (mj.load_dict(_prb(mj.cornell_box(16, 16, max_depth=3))),
            mt.load_dict(_prb(mt.cornell_box(16, 16, max_depth=3)),
                         device="cpu"))


def _leaf(v):
    if isinstance(v, tuple):
        return tuple(_leaf(t) for t in v)
    return v.detach().clone().requires_grad_(True)


def _grads_port(scene, names, spp, seed):
    """d mean(render) / dθ through the port's prb (θ = `names`)."""
    theta = {k: _leaf(getattr(scene, k)) for k in names}
    mt.render(scene.replace(**theta), spp=spp, seed=seed).mean().backward()
    return {k: tuple(t.grad for t in v) if isinstance(v, tuple) else v.grad
            for k, v in theta.items()}


def _grads_jax(scene, names, spp, seed):
    def loss(theta):
        return mj.render(scene.replace(**theta), spp=spp, seed=seed).mean()
    return jax.grad(loss)({k: getattr(scene, k) for k in names})


def _assert_grads_close(gj, gt, names, rel):
    """allclose with atol = rel * max |JAX gradient| per table; each table
    the JAX side differentiates non-trivially must be nonzero here too."""
    for k in names:
        if isinstance(gj[k], tuple):
            assert len(gj[k]) == len(gt[k]) == 0, k
            continue
        a, b = np.asarray(gj[k]), gt[k].numpy()
        assert a.shape == b.shape and np.isfinite(b).all(), k
        scale = np.abs(a).max()
        np.testing.assert_allclose(b, a, rtol=0, atol=rel * scale + 1e-12,
                                   err_msg=k)


def test_prb_primal_matches_path(cornell):
    """The PRB primal and the path tracer draw the same numbers and give
    the same image (atol 1e-6), which matches JAX's prb per pixel."""
    sj, st = cornell
    path = mt.load_dict(mt.cornell_box(16, 16, max_depth=3), device="cpu")
    img_prb, rays_prb = mt.render_with_stats(st, seed=3, spp=8)
    img_path, rays_path = mt.render_with_stats(path, seed=3, spp=8)
    np.testing.assert_allclose(img_prb.numpy(), img_path.numpy(), atol=1e-6)
    assert rays_prb == rays_path
    img_j = np.asarray(mj.render(sj, seed=3, spp=8))
    assert np.isclose(img_prb.numpy(), img_j, rtol=1e-3,
                      atol=1e-3).mean() > 0.995


def test_prb_cornell_grads_match_jax(cornell):
    """Gradients of mean(render) at 4 spp w.r.t. all of θ the Cornell box
    holds (bsdf_params, em_radiance, textures (none), env_data (zero: no
    environment), vertices) within 1e-4 of each table's largest JAX
    gradient."""
    sj, st = cornell
    gj = _grads_jax(sj, CORNELL_THETA, 4, 0)
    gt = _grads_port(st, CORNELL_THETA, 4, 0)
    _assert_grads_close(gj, gt, CORNELL_THETA, 1e-4)
    for k in ("bsdf_params", "em_radiance", "vertices"):
        assert float(gt[k].abs().max()) > 0, k
    assert float(gt["env_data"].abs().max()) == 0.0


def test_prb_grads_from_jax_leaves(cornell):
    """The JAX scene's leaves carried into the port differentiate to the
    port's own load_dict's gradients, exactly."""
    sj, st = cornell
    carried = scene_from_arrays(*arrays_from_scene(sj), device="cpu")
    assert carried.integrator == st.integrator
    ga = _grads_port(carried, CORNELL_THETA, 4, 0)
    gb = _grads_port(st, CORNELL_THETA, 4, 0)
    for k in CORNELL_THETA:
        if k != "textures":
            assert torch.equal(ga[k], gb[k]), k


def test_prb_terrain_grads_match_jax(monkeypatch):
    """The small terrain (8,978 faces, cellserve; the port's plain K1
    against JAX's reference serve) at 8^2, 4 spp: gradients of
    bsdf_params, env_data and de_params (the sun) within 1e-4 of each
    table's largest JAX gradient."""
    monkeypatch.setenv("MI3T_ACCEL", "cells")
    sj = mj.load_dict(_prb(chip_smoke.small_terrain_dict(
        mj.ScalarTransform4f, width=8)))
    st = mt.load_dict(_prb(chip_smoke.small_terrain_dict(
        mt.ScalarTransform4f, width=8)), device="cpu")
    gj = _grads_jax(sj, TERRAIN_THETA, 4, 1)
    gt = _grads_port(st, TERRAIN_THETA, 4, 1)
    _assert_grads_close(gj, gt, TERRAIN_THETA, 1e-4)
    for k in TERRAIN_THETA:
        assert float(gt[k].abs().max()) > 0, k


def point_light_dict(transform, light):
    """tests/test_ad.py's point-light scene: a floor rectangle under one
    delta light, prb at max_depth 3, 6^2."""
    return {
        "type": "scene",
        "integrator": {"type": "prb", "max_depth": 3},
        "sensor": {"type": "perspective", "fov": 40.0,
                   "to_world": transform().look_at(
                       origin=[0, 1, -3], target=[0, 0, 0], up=[0, 1, 0]),
                   "film": {"width": 6, "height": 6}},
        "floor": {"type": "rectangle",
                  "to_world": transform().rotate([1, 0, 0], -90).scale(2.0),
                  "bsdf": {"type": "diffuse"}},
        "lamp": light,
    }


DELTA_LIGHTS = {
    "point": {"type": "point", "position": [0, 1.5, 0],
              "intensity": {"type": "rgb", "value": [2, 2, 2]}},
    "spot": {"type": "spot", "position": [0.2, 1.5, -0.3],
             "direction": [0, -1, 0.1], "cutoff_angle": 40.0,
             "intensity": {"type": "rgb", "value": [3, 2, 1]}},
}


@pytest.mark.parametrize("light", sorted(DELTA_LIGHTS))
def test_prb_delta_light_grads_match_jax(light):
    """Gradients of de_params (the light's position, intensity and, for
    the spot, axis and cone rows) under a point or spot light
    (tests/test_ad.py::test_prb_point_light_intensity_gradient_vs_fd's
    scene) within 1e-4 of the largest JAX gradient; position and
    intensity move the image."""
    sj = mj.load_dict(point_light_dict(mj.ScalarTransform4f,
                                       DELTA_LIGHTS[light]))
    st = mt.load_dict(point_light_dict(mt.ScalarTransform4f,
                                       DELTA_LIGHTS[light]), device="cpu")
    names = ("de_params",)
    gj = _grads_jax(sj, names, 16, 0)
    gt = _grads_port(st, names, 16, 0)
    _assert_grads_close(gj, gt, names, 1e-4)
    g = gt["de_params"].numpy()
    assert (np.abs(g[0, 0:3]) > 0).all() and (g[0, 3:6] > 0).all()


def _wavefront(scene, side):
    """bench.py:83-105's wavefront: pixel-centre rays, one sample each."""
    n = side * side
    idx = torch.arange(n, dtype=torch.int64)
    rng = sampler_mod.seed(7, torch.zeros_like(idx), idx, 1)
    px = ((idx % side).to(torch.float32) + 0.5) / side
    py = ((idx // side).to(torch.float32) + 0.5) / side
    return rng, sensors.sample_ray(scene.sensor, Vec2(px, py))


def test_replay_ray_count_equals_primal(cornell):
    """The backward replay issues exactly the primal's closest-hit and
    shadow queries (bench.py measures their ratio), and the primal's count
    equals JAX's on the same wavefront."""
    sj, st = cornell
    rng, ray = _wavefront(st, 24)
    cfg = st.integrator
    theta = {k: v for k, v in prb.extract_theta(st).items() if v is not None}
    L, _, n_fwd, _ = prb._loop(st, rng, ray, cfg, "primal")
    _, _, n_bwd, grads = prb._loop(st, rng, ray, cfg, "backward",
                                   dL=Vec3.ones(24 * 24, "cpu"), L_in=L,
                                   theta=theta)
    assert n_fwd == n_bwd > 24 * 24
    assert sorted(grads) == sorted(theta)
    chip_smoke_counts = chip_smoke._bwd_ratio(st, side=24)
    assert chip_smoke_counts == (n_fwd, n_bwd)

    n = 24 * 24
    idx = jnp.arange(n)
    rng_j = sampler_j.seed(jnp.uint32(7), n,
                           sample_idx=jnp.zeros(n, jnp.uint32),
                           pixel_id=idx.astype(jnp.int32),
                           stype=sj.sampler_type, spp=1,
                           base_seed=jnp.uint32(7))
    ray_j = sensors_j.sample_ray(sj.sensor, Vec2J(
        ((idx % 24).astype(jnp.float32) + 0.5) / 24.0,
        ((idx // 24).astype(jnp.float32) + 0.5) / 24.0))
    L_j, _, _, n_j, _ = prb_j._loop(sj, rng_j, ray_j,
                                    sj.integrator, "primal")
    assert float(n_j) == n_fwd
    np.testing.assert_allclose(L.to_array().numpy(),
                               np.stack([np.asarray(L_j.x), np.asarray(L_j.y),
                                         np.asarray(L_j.z)], -1),
                               rtol=1e-4, atol=1e-5)


def test_backward_is_one_function_that_frees_each_bounce(cornell,
                                                         monkeypatch):
    """L hangs off one autograd.Function node whose inputs are the θ
    leaves (no graph of the bounce loop is kept); its backward takes one
    local torch.autograd.grad per bounce that reaches live lanes."""
    _, st = cornell
    theta = {k: _leaf(getattr(st, k)) for k in ("bsdf_params",
                                                "em_radiance")}
    img = mt.render(st.replace(**theta), spp=2, seed=0)
    node = img.grad_fn
    seen, stack = set(), [node]
    while stack:
        fn = stack.pop()
        if fn is None or fn in seen:
            continue
        seen.add(fn)
        stack.extend(f for f, _ in fn.next_functions)
    prb_nodes = [f for f in seen if type(f).__name__ == "_PRBFunctionBackward"]
    assert len(prb_nodes) == 1
    assert {type(f).__name__ for f, _ in prb_nodes[0].next_functions
            if f is not None} == {"AccumulateGrad"}
    calls = []
    real_grad = torch.autograd.grad

    def counting_grad(*args, **kwargs):
        calls.append(1)
        return real_grad(*args, **kwargs)

    monkeypatch.setattr(torch.autograd, "grad", counting_grad)
    img.mean().backward()
    assert 1 <= len(calls) <= st.integrator.max_depth
    assert theta["bsdf_params"].grad is not None


@pytest.mark.parametrize("rows", [3, 40, 2000])
def test_take_rows_grad_equals_index_grad(np_rng, monkeypatch, rows):
    """The PRB gathers' backward (a one-hot product over lane chunks up to
    1024 rows, index_add_ above) equals indexing's own backward; the
    forward is the gather itself."""
    monkeypatch.setattr(gather, "CHUNK_ELEMS", 1000)   # several chunks
    table = torch.as_tensor(np_rng.normal(size=(rows, 4, 3)),
                            dtype=torch.float32)
    idx = torch.as_tensor(np_rng.integers(0, rows, 5000))
    w = torch.as_tensor(np_rng.normal(size=(5000, 4, 3)), dtype=torch.float32)
    a = table.clone().requires_grad_(True)
    b = table.clone().requires_grad_(True)
    out = gather.take_rows(a, idx)
    assert torch.equal(out, table[idx])
    (out * w).sum().backward()
    (b[idx] * w).sum().backward()
    torch.testing.assert_close(a.grad, b.grad, rtol=1e-5, atol=1e-5)


def _every_bsdf_no_panels(pkg, width, height, max_depth):
    """chip_smoke.every_bsdf_dict without its principled, principledthin
    and measured panels."""
    d = chip_smoke.every_bsdf_dict(pkg, width, height, max_depth)
    for key in chip_smoke.EVERY_BSDF_PANELS:
        del d[key]
    return d


def test_prb_every_bsdf_grads_match_jax(monkeypatch):
    """PRB gradients of bsdf_params and em_radiance on the 16^2 every-BSDF
    Cornell (max_depth 3, 4 spp: eleven BSDF types, adapters nested,
    delta and glass lobes on the path) against jax.grad, as
    tests/test_torch_glossy.py holds the glossy Cornell's. Most of its
    ~190 s on the CPU is XLA compiling JAX's two render jits (~32 s the
    primal, ~98 s the replay); run eagerly, JAX takes longer still. The
    scene leaves out the principled, principledthin and measured panels:
    with them JAX's jitted replay took more than 10 minutes and 12 GiB to
    compile on the CPU (29 GiB and 20 minutes with the measured panel's
    dense per-lane table walks), and tests/test_torch_curves.py holds the
    principled and principledthin rows' gradients to jax.grad."""
    from test_torch_glossy import assert_prb_grads_close, prb_grads_pair
    gj, gt = prb_grads_pair(_every_bsdf_no_panels, monkeypatch)
    assert_prb_grads_close(gj, gt)
    # the blend's roughconductor (alpha_u, alpha_v) and the masked
    # roughplastic (alpha) are differentiated
    st = mt.load_dict(_every_bsdf_no_panels(mt, 8, 8, 2), device="cpu")
    rc = st.bsdf_types.index(2)
    rp = st.bsdf_types.index(8)
    assert float(gt["bsdf_params"][rc, 6:8].abs().min()) > 0
    assert float(gt["bsdf_params"][rp, 11].abs()) > 0
