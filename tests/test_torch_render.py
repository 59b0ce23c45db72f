"""Port parity, end to end: the small terrain (8,978 faces, cellserve
accel, a directional sun) and a small interior (8,624 faces, cellserve, a
point light) rendered by the JAX package and by the port on the CPU at
the same seed agree per pixel and in their ray counts. Also the loader's
device rule, its refusal of plugins the port does not carry, and
chip_smoke's copies of the benchmark terrain and interior. (The Cornell
box, the dense path, is in ``test_torch_cornell.py``.)"""
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


def test_small_terrain_render_matches_jax(renders, monkeypatch):
    img_j, rays_j, _ = renders
    monkeypatch.setenv("MI3T_ACCEL", "cells")
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


SMALL_INTERIOR = 9000     # make_interior's budget: 8,624 faces, above 8192


def _small_interiors(monkeypatch, max_depth):
    """(JAX scene, port scene) of bench.py's interior at 16^2 and 9,000
    triangles, cellserve pinned on both sides."""
    monkeypatch.setenv("MI3T_ACCEL", "cells")

    def make(transform):
        d = chip_smoke.interior_dict(transform, SMALL_INTERIOR, width=16)
        d["integrator"]["max_depth"] = max_depth
        return d
    scene = mt.load_dict(make(mt.ScalarTransform4f), device="cpu")
    assert scene.delta_emitter_types == (0,)          # one point light
    return mj.load_dict(make(mj.ScalarTransform4f)), scene


def _render_both(j_scene, t_scene):
    img_j, rays_j = mj.render_with_stats(j_scene, seed=SEED, spp=SPP)
    img_t, rays_t = mt.render_with_stats(t_scene, seed=SEED, spp=SPP)
    img_j, img_t = np.asarray(img_j), img_t.numpy()
    assert img_t.shape == img_j.shape == (16, 16, 3)
    assert np.isfinite(img_t).all() and img_t.mean() > 0
    assert np.allclose(img_t.mean(), img_j.mean(), rtol=1e-3)
    assert abs(rays_t - float(rays_j)) <= 1e-3 * float(rays_j)
    return img_j, img_t


def test_small_interior_render_matches_jax(monkeypatch):
    """bench.py's interior scene (a closed room: cellserve's straggler
    rounds through the port's plain K1) lit by its point light, at 16^2,
    4 spp, 9,000 triangles and max_depth 2 (the point light's NEE at the
    first hit and the shadow test), per pixel against JAX's render."""
    img_j, img_t = _render_both(*_small_interiors(monkeypatch, 2))
    assert np.isclose(img_t, img_j, rtol=1e-3, atol=1e-3).mean() > 0.995


def test_small_interior_depth4_matches_jax(monkeypatch):
    """The same at bench.py's max_depth 4: image mean and ray count
    within 1e-3 of JAX's, and per pixel on 98 % of the values (99.2 % at
    seed 5). The renders part on a few paths, for the cause that
    ``test_vertical_wall_normals_match_exact_arithmetic`` shows: on a
    vertical wall JAX's jitted normal has a z of about 1e-8 where the
    port's is 0, so the shading frame's handedness flips and the same
    cosine sample leaves in another, equally valid, direction (max_depth
    2 above agrees on every pixel)."""
    img_j, img_t = _render_both(*_small_interiors(monkeypatch, 4))
    assert np.isclose(img_t, img_j, rtol=1e-3, atol=1e-3).mean() > 0.98


def test_vertical_wall_normals_match_exact_arithmetic():
    """The cause of the depth-4 differences above. On the vertical faces
    of the small interior (those, not degenerate, whose normal's z,
    e1.x e2.y - e1.y e2.x, is 0 in float32 arithmetic) the port's geometric normal has z exactly
    0, as eager JAX does; JAX's jitted cross product (CPU compiler, as
    inside its render) gives some of them a z of up to ~1e-7, because it
    contracts a multiply and a subtract into one fused operation."""
    import jax
    from mitsuba3_tpu.core.vec import Vec3 as JVec3
    from mitsuba3_tpu_torch.core.vec import Vec3 as TVec3

    _, e1, e2 = chip_smoke.make_interior(SMALL_INTERIOR)
    area2 = np.linalg.norm(np.cross(e1.astype(np.float64), e2), axis=1)
    vertical = ((e1[:, 0] * e2[:, 1] - e1[:, 1] * e2[:, 0]) == 0) \
        & (area2 > 1e-4)
    a, b = torch.from_numpy(e1), torch.from_numpy(e2)
    z_t = TVec3(a[:, 0], a[:, 1], a[:, 2]).cross(
        TVec3(b[:, 0], b[:, 1], b[:, 2])).normalize().z.numpy()

    def z_j(u, v):
        return JVec3(u[:, 0], u[:, 1], u[:, 2]).cross(
            JVec3(v[:, 0], v[:, 1], v[:, 2])).normalize().z
    z_eager = np.asarray(z_j(e1, e2))
    z_jit = np.asarray(jax.jit(z_j)(e1, e2))
    assert vertical.sum() > 500
    assert (z_t[vertical] == 0).all() and (z_eager[vertical] == 0).all()
    assert (z_jit[vertical] != 0).sum() > 0
    assert np.abs(z_jit[vertical]).max() < 1e-7


def test_pass_split_render_is_deterministic(monkeypatch):
    """Capping the wavefront splits the render into passes; each pass
    seeds its own streams, so the split render is reproducible and
    estimates the same image."""
    monkeypatch.setenv("MI3T_ACCEL", "cells")
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
    monkeypatch.setenv("MI3T_ACCEL", "cells")
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
    # the Gaussian-primitive ellipsoids shape (ROADMAP item 11)
    "shape": (_with(BASE, ball={"type": "ellipsoids",
                                "means": [[0.0, 0.0, 1.0]]}),
              "'ellipsoids'"),
    # a polarized BSDF (ROADMAP item 9), under a twosided
    "bsdf": (_with(BASE, terrain=dict(BASE["terrain"], bsdf={
        "type": "twosided", "bsdf": {"type": "pplastic"}})), "'pplastic'"),
    # a curve property the JAX loader ignores (a curve's radii are its
    # control points' fourth column)
    "curve": (_with(BASE, strand={
        "type": "linearcurve", "radius": 0.02,
        "control_points": [[0, 0, 0, 0.01], [0, 0, 1, 0.01]]}),
        r"linearcurve properties \['radius'\]"),
    "integrator": (_with(BASE, integrator={"type": "stokes"}), "'stokes'"),
    # a perspective sensor's medium is ported (tests/test_torch_media.py);
    # a batch sensor's, which the JAX loader ignores, is refused
    "sensor_medium": (_with(BASE, sensor={
        "type": "batch", "film": BASE["sensor"]["film"],
        "sampler": BASE["sensor"]["sampler"],
        "cam": {k: v for k, v in BASE["sensor"].items()
                if k not in ("film", "sampler")},
        "medium": {"type": "homogeneous"}}), r"\['medium'\]"),
    "texture": (_with(BASE, terrain=dict(BASE["terrain"], bsdf={
        "type": "diffuse", "reflectance": {"type": "bitmap", "data": [[0.5]],
                                           "format": "rgb"}})),
                r"bitmap properties \['format'\]"),
    # a disk property the JAX loader ignores (a disk's size is its
    # to_world's)
    "disk_shape": (_with(BASE, lid={"type": "disk", "radius": 2.0}),
                   r"disk properties \['radius'\]"),
    "area_emitter_type": (_with(BASE, panel={
        "type": "rectangle", "emitter": {"type": "spot"}}), "'spot'"),
}


@pytest.mark.parametrize("case", sorted(UNPORTED))
def test_unported_plugins_raise(case):
    d, name, *kw = UNPORTED[case]
    with pytest.raises(NotImplementedError, match=name):
        mt.load_dict(d, device="cpu", **(kw[0] if kw else {}))


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


@pytest.mark.parametrize("n_tris", [SMALL_INTERIOR, 120000])
def test_chip_smoke_interior_equals_benchmark(n_tris):
    sys.path.insert(0, os.path.join(os.path.dirname(
        os.path.dirname(os.path.abspath(__file__))), "benchmarks"))
    try:
        import bench_bvh
    finally:
        sys.path.pop(0)
    for a, b in zip(chip_smoke.make_interior(n_tris),
                    bench_bvh.make_interior(n_tris)):
        np.testing.assert_array_equal(a, b)
