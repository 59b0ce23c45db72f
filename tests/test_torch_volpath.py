"""Port parity for the volumetric integrators: ``volpath`` and
``volpathmis`` renders per pixel against JAX at the same seed (a fog slab
lit by a point light and an environment, the smoke of
examples/03_volumetric.py on an 8^3 grid, and six media of the six phase
types around a camera that sits in a medium), ``volpath`` against
``path`` without media, the fog cube's Z-test against the stored
reference of tests/test_regression.py, and a fog cube written by
``write_file`` and read back by ``load_file``. The ``prbvolpath``
gradients are held in tests/test_torch_media.py, where JAX's compile of
them balances this file's renders. Inputs come from numpy
seeds; every tolerance is stated at its assert."""
import os

import numpy as np
import pytest
import torch

import mitsuba3_tpu as mj
from mitsuba3_tpu.utils import xml as xml_j

import chip_smoke
import mitsuba3_tpu_torch as mt
from mitsuba3_tpu_torch.convert import arrays_from_scene
from mitsuba3_tpu_torch.utils import xml as xml_t
from test_regression import DATA, REF_SPP, TEST_SPP, _z_test
from test_torch_cornell import _moment_render
from test_torch_media import PHASES, het_medium, hom_medium, slab_dict

torch.set_num_threads(1)


def fog_slab(mi, integrator):
    return slab_dict(mi, hom_medium({"type": "hg", "g": 0.5}), width=12,
                     integrator=integrator, spp=4, max_depth=8)


def smoke(mi, integrator):
    return chip_smoke.smoke_dict(mi, 12, 8, integrator, spp=4)


def phase_boxes(mi, integrator):
    """Six cubes, one medium of each phase type, inside a thin homogeneous
    fog that holds the camera too (sensor medium; the cubes' exterior)."""
    T = mi.ScalarTransform4f
    fog = {"type": "homogeneous", "sigma_t": {"type": "rgb", "value": 0.05},
           "albedo": {"type": "rgb", "value": 0.9}}
    d = slab_dict(mi, hom_medium(), width=12, integrator=integrator, spp=4,
                  max_depth=6, sensor_medium={"type": "ref", "id": "air"})
    d = {"type": "scene", "air": fog, **{k: v for k, v in d.items()
                                          if k not in ("type", "fog")}}
    d["sensor"]["fov"] = 45.0
    for k, ph in enumerate(PHASES.values()):
        x, y = (k % 3 - 1) * 1.1, (k // 3 - 0.5) * 1.1
        d[f"box{k}"] = {"type": "cube", "bsdf": {"type": "null"},
                        "to_world": T().translate([x, y, 0]).scale(0.45),
                        "interior": hom_medium(ph, sigma=(2.0, 1.5, 2.5)),
                        "exterior": {"type": "ref", "id": "air"}}
    return d


SCENES = {"fog": fog_slab, "smoke": smoke, "phases": phase_boxes}


def _hold_images(img_t, img_j, rays_t, rays_j, what):
    """Per pixel: isclose(rtol 1e-3, atol 1e-3) on > 99.5 % of values, the
    means at rtol 1e-3, ray counts within 1e-3."""
    assert np.isfinite(img_t).all(), what
    assert img_t.mean() > 0.0, what
    ok = np.isclose(img_t, img_j, rtol=1e-3, atol=1e-3)
    assert ok.mean() > 0.995, (what, ok.mean())
    assert np.allclose(img_t.mean(), img_j.mean(), rtol=1e-3), what
    assert abs(rays_t - rays_j) <= 1e-3 * rays_j, (what, rays_t, rays_j)


@pytest.mark.parametrize("case", ["fog-volpath", "fog-volpathmis",
                                  "smoke-volpath", "smoke-volpathmis",
                                  "phases-volpath"])
def test_volpath_renders_match_jax(case):
    """The render per pixel against JAX's at seed 5 (see _hold_images)."""
    name, integrator = case.split("-")
    make = SCENES[name]
    sj = mj.load_dict(make(mj, integrator))
    st = mt.load_dict(make(mt, integrator), device="cpu")
    img_j, rays_j = mj.render_with_stats(sj, seed=5)
    img_t, rays_t = mt.render_with_stats(st, seed=5)
    _hold_images(img_t.numpy(), np.asarray(img_j), rays_t, float(rays_j),
                 case)


def test_volpath_equals_path_without_media():
    """On a scene without media volpath is the path tracer (JAX's
    tests/test_medium.py:64): Cornell 16^2 at 64 spp, max_depth 4, image
    means within 0.01 at different seeds; and the port's volpath image
    per pixel equals JAX's volpath (see _hold_images)."""
    d_v = mt.cornell_box(16, 16, max_depth=4)
    d_v["integrator"] = {"type": "volpath", "max_depth": 4}
    img_v = mt.render(mt.load_dict(d_v, device="cpu"), spp=64, seed=3)
    img_p = mt.render(mt.load_dict(mt.cornell_box(16, 16, max_depth=4),
                                   device="cpu"), spp=64, seed=4)
    assert abs(float(img_v.mean()) - float(img_p.mean())) < 0.01
    d_j = mj.cornell_box(8, 8, max_depth=4)
    d_j["integrator"] = {"type": "volpath", "max_depth": 4}
    d_t = mt.cornell_box(8, 8, max_depth=4)
    d_t["integrator"] = {"type": "volpath", "max_depth": 4}
    img_j, rays_j = mj.render_with_stats(mj.load_dict(d_j), seed=2, spp=8)
    img_t, rays_t = mt.render_with_stats(mt.load_dict(d_t, device="cpu"),
                                         seed=2, spp=8)
    _hold_images(img_t.numpy(), np.asarray(img_j), rays_t, float(rays_j),
                 "cornell volpath")


def test_fog_cube_z_test_against_reference():
    """tests/test_regression.py's Z-test (significance 0.01, Šidák) of the
    port's 32^2 fog cube (volpath, max_depth 6) at 256 spp against the
    stored 1024 spp reference of the JAX package, with its outlier
    allowance."""
    ref = np.load(os.path.join(DATA, "ref_fog_cube.npz"))
    mean, var = _moment_render(chip_smoke.fog_cornell_dict(mt, 32, 32, 6),
                               TEST_SPP, seed=3)
    fails, n_pix = _z_test(mean, var, TEST_SPP, ref["mean_xyz"],
                           ref["var_xyz"], REF_SPP)
    assert fails <= max(3, n_pix // 500), (fails, n_pix)


def _fog_xml_dict(mi):
    """The fog cube with an HG phase, and the camera in a thin fog."""
    d = chip_smoke.fog_cornell_dict(mi, 16, 16, 6)
    d["fog"]["interior"]["phase"] = {"type": "hg", "g": 0.3}
    d["sensor"]["medium"] = hom_medium({"type": "rayleigh"},
                                       sigma=(0.05, 0.05, 0.05))
    return d


def test_fog_cube_xml_round_trip(tmp_path):
    """write_file of the fog cube dict (a ``<medium>`` in a shape and in
    the sensor, each with a ``<phase>``; both packages' writers) and
    load_file of the result: the port's scene equals load_dict's array for
    array, and the JAX writer's file loads in the port the same."""
    a_ref, meta_ref = arrays_from_scene(mt.load_dict(_fog_xml_dict(mt),
                                                     device="cpu"))
    assert meta_ref["phase_types"] == (2, 1)
    for writer, make in ((xml_t.write_file, mt), (xml_j.write_file, mj)):
        path = str(tmp_path / f"fog_{make.__name__}.xml")
        writer(_fog_xml_dict(make), path)
        a, meta = arrays_from_scene(mt.load_file(path, device="cpu"))
        assert sorted(a) == sorted(a_ref)
        for k in a:
            np.testing.assert_array_equal(a[k], a_ref[k], k)
        for k in ("medium_types", "phase_types", "sensor_medium",
                  "integrator"):
            assert meta[k] == meta_ref[k], k
