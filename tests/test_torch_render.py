"""Port parity, end to end: the small terrain (8,978 faces, cellserve
accel) rendered by the JAX package and by the port on the CPU at the same
seed agrees per pixel and in its ray count. Also the loader's device rule,
its refusal of plugins the port does not carry, and chip_smoke's copy of
the benchmark terrain. (The Cornell box, the dense path, is in
``test_torch_cornell.py``.)"""
import os
import sys

import numpy as np
import pytest
import torch

import mitsuba3_tpu as mj

import chip_smoke
import mitsuba3_tpu_torch as mt
from mitsuba3_tpu_torch.convert import arrays_from_scene, scene_from_arrays

torch.set_num_threads(1)
SEED, SPP = 5, 4


@pytest.fixture(scope="module")
def renders():
    """(jax image, jax rays, jax scene) of the small terrain."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("MI3T_ACCEL", "cells")
        scene = mj.load_dict(chip_smoke.small_terrain_dict(
            mj.ScalarTransform4f))
    img, rays = mj.render_with_stats(scene, seed=SEED, spp=SPP)
    return np.asarray(img), float(rays), scene


def test_small_terrain_render_matches_jax(renders):
    img_j, rays_j, _ = renders
    scene = mt.load_dict(chip_smoke.small_terrain_dict(mt.ScalarTransform4f),
                         device="cpu")
    img_t, rays_t = mt.render_with_stats(scene, seed=SEED, spp=SPP)
    img_t = img_t.numpy()
    assert img_t.shape == img_j.shape == (24, 24, 3)
    assert np.isfinite(img_t).all() and img_t.max() > 0
    assert np.isclose(img_t, img_j, rtol=1e-3, atol=1e-3).mean() > 0.995
    assert np.allclose(img_t.mean(), img_j.mean(), rtol=1e-3)
    assert abs(rays_t - rays_j) <= 1e-3 * rays_j


def test_render_from_jax_leaves_matches_jax(renders):
    """The JAX scene's leaves carried into the port render the same
    image as the port's own load_dict."""
    img_j, rays_j, j_scene = renders
    scene = scene_from_arrays(*arrays_from_scene(j_scene), device="cpu")
    img_t, rays_t = mt.render_with_stats(scene, seed=SEED, spp=SPP)
    assert np.isclose(img_t.numpy(), img_j, rtol=1e-3,
                      atol=1e-3).mean() > 0.995
    assert abs(rays_t - rays_j) <= 1e-3 * rays_j


def test_pass_split_render_is_deterministic():
    """Capping the wavefront splits the render into passes; each pass
    seeds its own streams, so the split render is reproducible and
    estimates the same image."""
    d = chip_smoke.small_terrain_dict(mt.ScalarTransform4f, width=12)
    scene = mt.load_dict(d, device="cpu")
    one, _ = mt.render_with_stats(scene, seed=1, spp=4)
    split_a, rays_a = mt.render_with_stats(scene, seed=1, spp=4,
                                           max_wavefront=12 * 12 * 2)
    split_b, rays_b = mt.render_with_stats(scene, seed=1, spp=4,
                                           max_wavefront=12 * 12 * 2)
    assert torch.equal(split_a, split_b) and rays_a == rays_b
    assert abs(float(split_a.mean()) - float(one.mean())) < 0.05


def test_load_dict_needs_a_card_unless_cpu_is_asked(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    d = chip_smoke.small_terrain_dict(mt.ScalarTransform4f)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        mt.load_dict(d)
    with pytest.raises(RuntimeError, match="CUDA"):
        mt.load_dict(d, device="cuda")
    assert mt.load_dict(d, device="cpu").device.type == "cpu"


def _with(d, **changes):
    d = dict(d)
    for key, val in changes.items():
        d[key] = val
    return d


def _sensor(d, **changes):
    s = dict(d["sensor"])
    s.update(changes)
    return _with(d, sensor=s)


BASE = chip_smoke.small_terrain_dict(mt.ScalarTransform4f)
UNPORTED = {
    "shape": (_with(BASE, ball={"type": "sphere"}), "'sphere'"),
    "bsdf": (_with(BASE, terrain=dict(BASE["terrain"], bsdf={
        "type": "roughconductor"})), "'roughconductor'"),
    "emitter": (_with(BASE, lamp={"type": "point"}), "'point'"),
    "integrator": (_with(BASE, integrator={"type": "direct"}), "'direct'"),
    "rfilter": (_sensor(BASE, film={"width": 8, "height": 8,
                                    "rfilter": {"type": "box"}}), "box"),
    "sampler": (_sensor(BASE, sampler={"type": "stratified"}),
                "'stratified'"),
    "texture": (_with(BASE, terrain=dict(BASE["terrain"], bsdf={
        "type": "diffuse", "reflectance": {"type": "bitmap"}})), "'bitmap'"),
    "disk_shape": (_with(BASE, lid={"type": "disk"}), "'disk'"),
    "area_emitter_type": (_with(BASE, panel={
        "type": "rectangle", "emitter": {"type": "directionalarea"}}),
        "'directionalarea'"),
}


@pytest.mark.parametrize("case", sorted(UNPORTED))
def test_unported_plugins_raise(case):
    d, name = UNPORTED[case]
    with pytest.raises(NotImplementedError, match=name):
        mt.load_dict(d, device="cpu")


@pytest.mark.parametrize("side", [20, int(np.sqrt(65536 / 2)) + 1])
def test_chip_smoke_terrain_equals_benchmark(side):
    sys.path.insert(0, os.path.join(os.path.dirname(
        os.path.dirname(os.path.abspath(__file__))), "benchmarks"))
    try:
        import bench_bvh
    finally:
        sys.path.pop(0)
    for a, b in zip(chip_smoke.make_terrain(side),
                    bench_bvh.make_terrain(side)):
        np.testing.assert_array_equal(a, b)
