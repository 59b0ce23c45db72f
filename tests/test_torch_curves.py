"""Port parity for curves on the tube route (``shapes/curves.py``) and the
hair BSDF on them, against the JAX package.

The tube meshes (vertices, faces, uvs, normals) of ``linearcurve`` and
``bsplinecurve`` are bit-equal to JAX's, from a curve file and from
``control_points``, with ``tessellate`` and for a set above 512 cones; a
set of at most 512 cones is analytic round cones in both packages, with
bit-equal rows and the same render. tests/test_render.py:233's strands
with the hair
BSDF render per pixel as JAX's do (equal ray counts), and the PRB
gradients of the hair, principled and principledthin rows and of a
principled base_color texture are within 1e-4 of ``jax.grad``'s largest
entry (JAX jitted with ``jax_disable_most_optimizations``: eager is
slower)."""
import jax
import numpy as np
import pytest
import torch

import mitsuba3_tpu as mj
from mitsuba3_tpu.shapes import curves as curves_j

import chip_smoke
import mitsuba3_tpu_torch as mt
from mitsuba3_tpu_torch.shapes import curves as curves_t
from test_torch_glossy import _guarded_jax
from test_torch_prb import _assert_grads_close, _grads_jax, _grads_port

torch.set_num_threads(1)


def _strands(n=12, points=8, seed=4):
    """tests/test_render.py:233's strands: [n, points, 3]."""
    rng = np.random.default_rng(seed)
    out = []
    for k in range(n):
        x = -0.8 + 0.15 * k
        out.append([(x + 0.05 * rng.standard_normal(), -1.0 + 0.25 * i,
                     0.1 * rng.standard_normal()) for i in range(points)])
    return np.asarray(out)


@pytest.fixture(scope="module")
def hair_file(tmp_path_factory):
    return chip_smoke.write_curve_file(
        str(tmp_path_factory.mktemp("curves") / "hair.txt"), _strands(), 0.02)


def _control_points(strands, radius):
    cp = np.concatenate([np.concatenate(
        [s, np.full((len(s), 1), radius)], 1) for s in strands], 0)
    return cp, [len(strands[0]) * k for k in range(len(strands))]


def _spec(ctype, source, mode, hair_file):
    """A curve spec: from the file or control_points; `mode` "tessellate"
    (12 strands, tessellate) or "many" (90 strands: above 512 cones)."""
    strands = _strands() if mode == "tessellate" else _strands(90, 8, 9)
    if source == "file" and mode == "tessellate":
        spec = {"type": ctype, "filename": hair_file}
    else:
        cp, seg = _control_points(strands, 0.02)
        spec = {"type": ctype, "control_points": cp.tolist(),
                "segment_indices": seg}
    if mode == "tessellate":
        spec["tessellate"] = True
    spec["n_sides"] = 5
    if ctype == "bsplinecurve":
        spec["subdiv"] = 3
    return spec


CURVE_CASES = [(c, s, m) for c in ("linearcurve", "bsplinecurve")
               for s, m in (("file", "tessellate"),
                            ("control_points", "tessellate"),
                            ("control_points", "many"))]


@pytest.mark.parametrize("ctype,source,mode", CURVE_CASES)
def test_curve_mesh_bit_equal_to_jax(ctype, source, mode, hair_file,
                                     monkeypatch):
    """build_curve_mesh's vertices, faces, uvs and normals bit-equal to
    JAX's, and the loaded scene's face tables equal to JAX's; the port
    tessellates where JAX does. A scene above 8192 faces gets cellserve on
    both sides."""
    monkeypatch.setenv("MI3T_ACCEL", "cells")
    spec = _spec(ctype, source, mode, hair_file)
    bspline = ctype == "bsplinecurve"
    mj_mesh = curves_j.build_curve_mesh(spec, bspline)
    mt_mesh = curves_t.build_curve_mesh(spec, bspline)
    for f in ("vertices", "faces", "uvs", "normals"):
        np.testing.assert_array_equal(getattr(mt_mesh, f),
                                      getattr(mj_mesh, f), err_msg=f)
    if mode == "many":
        assert curves_t.curve_cone_rows(spec, bspline) is None
        assert curves_j.curve_cone_rows(spec, bspline) is None
    d = {"type": "scene", "hair": dict(spec, bsdf={"type": "hair"})}
    sj, st = mj.load_dict(d), mt.load_dict(d, device="cpu")
    assert sj.analytic_prims is None
    for f in ("vertices", "faces", "face_uv", "face_normals", "face_bsdf"):
        np.testing.assert_array_equal(getattr(st, f).numpy(),
                                      np.asarray(getattr(sj, f)), err_msg=f)


@pytest.mark.parametrize("ctype", ["linearcurve", "bsplinecurve"])
def test_analytic_curves_raise(ctype, hair_file):
    """A set of at most 512 cones with no emitter and no tessellate is
    analytic round cones (ops/analytic.py) in both packages: the loaded
    rows are bit-equal and the strands render per pixel as JAX's (in a
    diffuse BSDF: in hair, an ulp of the two packages' transcendentals
    moves one pixel of the 12^2 by 1.4 %, ROADMAP queue 3); an emitter
    makes it a tube in both. (Five strands: twelve B-splines, at 8 samples
    a span, make 864 cones, so the B-spline set keeps two strands.)"""
    bspline = ctype == "bsplinecurve"
    cp, seg = _control_points(_strands()[:2 if bspline else 5], 0.02)
    spec = {"type": ctype, "control_points": cp.tolist(),
            "segment_indices": seg, "bsdf": {"type": "hair"}}
    rows_j = curves_j.curve_cone_rows(spec, bspline)
    assert rows_j is not None
    np.testing.assert_array_equal(curves_t.curve_cone_rows(spec, bspline),
                                  rows_j)

    def scene(pkg):
        T = pkg.ScalarTransform4f
        return {"type": "scene",
                "integrator": {"type": "path", "max_depth": 2},
                "sensor": {"type": "perspective", "fov": 45.0,
                           "to_world": T().look_at(origin=[0, 0, -3],
                                                   target=[0, 0, 0],
                                                   up=[0, 1, 0]),
                           "film": {"width": 12, "height": 12,
                                    "rfilter": {"type": "box"}},
                           "sampler": {"type": "independent",
                                       "sample_count": 2}},
                "hair": dict(spec, bsdf={"type": "diffuse"}),
                "env": {"type": "constant", "radiance": 1.0}}
    sj, st = mj.load_dict(scene(mj)), mt.load_dict(scene(mt), device="cpu")
    np.testing.assert_array_equal(st.analytic_prims.numpy(),
                                  np.asarray(sj.analytic_prims))
    img_j = np.asarray(mj.render(sj, seed=1, spp=2))
    img_t = mt.render(st, seed=1, spp=2).numpy()
    assert np.isclose(img_t, img_j, rtol=1e-3, atol=1e-3).mean() > 0.995
    assert img_t.min() < 0.9 * img_t.max()     # the strands occlude
    lit = dict(spec, emitter={"type": "area", "radiance": 1.0})
    st = mt.load_dict({"type": "scene", "hair": lit}, device="cpu")
    assert st.n_area_emitters == 1 and st.analytic_prims is None


def _hair_scene(pkg, hair_file, extra=False):
    """tests/test_render.py:233's scene with both curve types (tessellated)
    in hair BSDFs; with `extra`, a principled panel with a checkerboard
    base_color behind them and a principledthin sheet."""
    T = pkg.ScalarTransform4f
    d = {"type": "scene",
         "integrator": {"type": "path", "max_depth": 3},
         "sensor": {"type": "perspective", "fov": 45.0,
                    "to_world": T().look_at(origin=[0, 0, -3],
                                            target=[0, 0, 0], up=[0, 1, 0]),
                    "film": {"width": 16, "height": 16,
                             "rfilter": {"type": "box"}},
                    "sampler": {"type": "independent", "sample_count": 4}},
         "hair": {"type": "linearcurve", "filename": hair_file,
                  "tessellate": True, "bsdf": dict(chip_smoke.HAIR_SIGMA_A)},
         "spline": {"type": "bsplinecurve", "filename": hair_file,
                    "tessellate": True, "n_sides": 4,
                    "to_world": T().translate([0.1, 0.3, 0.2]),
                    "bsdf": dict(chip_smoke.HAIR_EUMELANIN)},
         "light": {"type": "point", "position": [2, 2, -3],
                   "intensity": {"type": "rgb", "value": [30, 30, 30]}},
         "env": {"type": "constant",
                 "radiance": {"type": "rgb", "value": 0.1}}}
    if extra:
        d["panel"] = {"type": "rectangle",
                      "to_world": T().translate([0, 0, 0.6]).scale(1.5),
                      "bsdf": {"type": "twosided", "bsdf": {
                          "type": "principled", "metallic": 0.3,
                          "roughness": 0.4, "clearcoat": 0.5, "sheen": 0.4,
                          "base_color": {"type": "checkerboard",
                                         "color0": [0.7, 0.3, 0.2],
                                         "color1": [0.2, 0.4, 0.6]}}}}
        d["sheet"] = {"type": "rectangle",
                      "to_world": T().translate([0.5, -0.3, -0.8]).scale(
                          0.4),
                      "bsdf": {"type": "principledthin", "spec_trans": 0.5,
                               "diff_trans": 0.6, "roughness": 0.5}}
    return d


def test_hair_render_matches_jax(hair_file):
    """Both curve types' tubes in hair BSDFs (eumelanin and sigma_a) at
    16^2, max_depth 3, 4 spp: per pixel against JAX, equal ray counts."""
    sj = mj.load_dict(_hair_scene(mj, hair_file))
    st = mt.load_dict(_hair_scene(mt, hair_file), device="cpu")
    with jax.disable_jit():
        img_j, rays_j = mj.render_with_stats(sj, seed=1, spp=4)
    img_t, rays_t = mt.render_with_stats(st, seed=1, spp=4)
    img_j, img_t = np.asarray(img_j), img_t.numpy()
    assert int(rays_t) == int(rays_j)
    assert np.isfinite(img_t).all() and img_t.max() > 0
    assert np.isclose(img_t, img_j, rtol=1e-3, atol=1e-3).mean() > 0.995
    np.testing.assert_allclose(img_t.mean(), img_j.mean(), rtol=1e-3)
    # the fibers occlude the background somewhere in the center strip
    assert img_t[:, 5:11].mean() != img_t[:, 0:2].mean()


def test_prb_hair_principled_grads_match_jax(hair_file, monkeypatch):
    """PRB gradients of bsdf_params (the two hair rows, principled and
    principledthin) and textures (principled's checkerboard base_color)
    at 8^2, max_depth 3, 4 spp against jax.grad: within 1e-4 of each
    table's largest entry, every entry finite on both sides; the hair
    rows' sigma_a and the principled row's metallic, roughness and
    clearcoat gradients nonzero. JAX runs with the port's NaN guards
    (tests/test_torch_glossy.py::_guarded_jax): without them its gradient
    is NaN in columns 4-8 and 13 of all four rows and in the whole
    texture (ROADMAP queue 3); the port's is finite either way."""
    def make(pkg):
        d = chip_smoke._prb_dict(_hair_scene(pkg, hair_file, extra=True))
        d["sensor"]["film"].update(width=8, height=8)
        return d
    sj = mj.load_dict(make(mj))
    st = mt.load_dict(make(mt), device="cpu")
    names = ("bsdf_params", "textures")
    _guarded_jax(monkeypatch)
    jax.config.update("jax_disable_most_optimizations", True)
    try:
        gj = _grads_jax(sj, names, 4, 0)
    finally:
        jax.config.update("jax_disable_most_optimizations", False)
    gt = _grads_port(st, names, 4, 0)
    assert np.isfinite(np.asarray(gj["bsdf_params"])).all()
    _assert_grads_close(gj, gt, ("bsdf_params",), 1e-4)
    for a, b in zip(gj["textures"], gt["textures"]):
        a = np.asarray(a)
        assert np.isfinite(a).all() and np.isfinite(b.numpy()).all()
        np.testing.assert_allclose(b.numpy(), a, rtol=0,
                                   atol=1e-4 * np.abs(a).max())
        assert float(b.abs().max()) > 0
    g = gt["bsdf_params"]
    hair = [i for i, t in enumerate(st.bsdf_types) if t == 13]
    pr = st.bsdf_types.index(12)
    assert float(g[hair, 4:7].abs().min()) > 0
    assert float(g[pr, [4, 5, 11]].abs().min()) > 0
