"""Port parity for glossy and glass materials through the renderer:
``tests/test_regression.py``'s cornell_glossy (a gold roughconductor and a
plastic box) per pixel against JAX and by the Z-test against its stored
reference, the every-BSDF Cornell of ``chip_smoke.every_bsdf_dict`` per
pixel against JAX, PRB gradients of the glossy Cornell against
``jax.grad``, and the BSDFs and parameters the port refuses.

The JAX renders run eagerly (``jax.disable_jit``): the every-BSDF scene's
jitted render takes ~26 s to trace and compile on the CPU, its eager one
~9 s, and eager XLA rounds as the jitted one does here (the same ray
count and image)."""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mitsuba3_tpu as mj
from mitsuba3_tpu import bsdfs as bsdfs_j
from mitsuba3_tpu.core import frame as frame_j
from mitsuba3_tpu.core import math as math_j
from mitsuba3_tpu.core import warp as warp_j

import chip_smoke
import mitsuba3_tpu_torch as mt
from mitsuba3_tpu_torch.convert import arrays_from_scene, scene_from_arrays
from test_regression import DATA, REF_SPP, TEST_SPP, _z_test
from test_torch_cornell import _moment_render
from test_torch_prb import _assert_grads_close, _grads_jax, _grads_port

torch.set_num_threads(1)
GRAD_NAMES = ("bsdf_params", "em_radiance")


def _render_pair(make, size, max_depth, spp, seed):
    """(JAX image, JAX rays, port image, port rays, JAX scene, port
    scene) of ``make(pkg, size, size, max_depth)``."""
    sj = mj.load_dict(make(mj, size, size, max_depth))
    st = mt.load_dict(make(mt, size, size, max_depth), device="cpu")
    with jax.disable_jit():
        img_j, rays_j = mj.render_with_stats(sj, seed=seed, spp=spp)
    img_t, rays_t = mt.render_with_stats(st, seed=seed, spp=spp)
    return (np.asarray(img_j), float(rays_j), img_t.numpy(), rays_t, sj,
            st)


def _assert_images_close(img_j, rays_j, img_t, rays_t, shape):
    """The Cornell render's tolerance: > 99.5 % of values isclose 1e-3,
    means rtol 1e-3, ray counts within 1e-3."""
    assert img_t.shape == shape and np.isfinite(img_t).all()
    assert float(img_t.max()) > 0
    assert np.isclose(img_t, img_j, rtol=1e-3, atol=1e-3).mean() > 0.995
    assert np.allclose(img_t.mean(), img_j.mean(), rtol=1e-3)
    assert abs(rays_t - rays_j) <= 1e-3 * rays_j


def test_glossy_cornell_render_matches_jax():
    """32^2 cornell_glossy at max_depth 4, 4 spp, seed 5, per pixel
    against JAX; the JAX scene's leaves (BSDF rows, flags and adapter
    depth included) carried into the port render the same image."""
    img_j, rays_j, img_t, rays_t, sj, st = _render_pair(
        chip_smoke.glossy_cornell_dict, 32, 4, 4, 5)
    _assert_images_close(img_j, rays_j, img_t, rays_t, (32, 32, 3))
    aj, meta_j = arrays_from_scene(sj)
    at, meta_t = arrays_from_scene(st)
    np.testing.assert_array_equal(aj["bsdf_params"], at["bsdf_params"])
    assert meta_j == meta_t and meta_t["bsdf_types"] == (0, 0, 0, 2, 4)
    carried = scene_from_arrays(aj, meta_j, device="cpu")
    img_c, rays_c = mt.render_with_stats(carried, seed=5, spp=4)
    np.testing.assert_array_equal(img_c.numpy(), img_t)
    assert rays_c == rays_t


def test_glossy_cornell_z_test_against_reference():
    """tests/test_regression.py's Z-test (significance 0.01, Šidák) of the
    port's 32^2 cornell_glossy (max_depth 4) at 256 spp against the
    stored 1024 spp reference of the JAX package, with its outlier
    allowance."""
    ref = np.load(os.path.join(DATA, "ref_cornell_glossy.npz"))
    mean, var = _moment_render(chip_smoke.glossy_cornell_dict(mt, 32, 32, 4),
                               TEST_SPP, seed=3)
    fails, n_pix = _z_test(mean, var, TEST_SPP, ref["mean_xyz"],
                           ref["var_xyz"], REF_SPP)
    assert fails <= max(3, n_pix // 500), (fails, n_pix)


def test_every_bsdf_cornell_render_matches_jax():
    """The every-BSDF Cornell (14 types, twosided(mask(...)), a null
    rectangle) at 16^2, max_depth 4, 4 spp per pixel against JAX."""
    img_j, rays_j, img_t, rays_t, sj, st = _render_pair(
        chip_smoke.every_bsdf_dict, 16, 4, 4, 5)
    _assert_images_close(img_j, rays_j, img_t, rays_t, (16, 16, 3))
    assert set(st.bsdf_types) == set(range(11)) | {12, 15, 18}


def test_every_bsdf_depth8_parts_on_one_ulp():
    """ROADMAP queue 3's witness that the every-BSDF Cornell turns a
    rounding difference into different paths by max_depth 8: a 1-ulp
    larger eta of its small box's smooth dielectric leaves every value of
    the 16^2, 16 spp image (seed 5) within 1e-3 at max_depth 4, and parts
    more than 0.5 % of them at max_depth 8. So the card and the CPU, whose
    transcendental functions round differently, are held per pixel at
    max_depth 4 on this scene, and at max_depth 8 on it with a diffuse
    small box (``chip_smoke.every_bsdf_diffuse_box_dict``)."""
    close = {}
    for depth in (4, 8):
        scene = mt.load_dict(chip_smoke.every_bsdf_dict(mt, 16, 16, depth),
                             device="cpu")
        params = scene.bsdf_params.clone()
        row = scene.bsdf_types.index(3)
        params[row, 0] = float(np.nextafter(np.float32(params[row, 0]),
                                            np.float32(2)))
        img = mt.render(scene, seed=5, spp=16).numpy()
        img_ulp = mt.render(scene.replace(bsdf_params=params), seed=5,
                            spp=16).numpy()
        assert np.isfinite(img_ulp).all()
        close[depth] = np.isclose(img_ulp, img, rtol=1e-3, atol=1e-3).mean()
    assert close[4] == 1.0 and close[8] < 0.995, close


def _safe_sqrt_j(x):
    """The port's ``core.math.safe_sqrt`` in JAX: sqrt(max(x, 0)) with a
    zero gradient where x <= 0."""
    pos = x > 0.0
    return jnp.where(pos, jnp.sqrt(jnp.where(pos, x, 1.0)), 0.0)


def _guarded_jax(monkeypatch):
    """Give JAX the port's two NaN guards, neither of which changes a
    forward value (ROADMAP queue 3):
    - its masked BSDF dispatch reads, on the lanes of other types, the
      row of the first slot of the type it evaluates, as the port's does.
      Unguarded, the local ``jax.grad`` of JAX's PRB replay is NaN
      wherever one type's function meets another's row (a diffuse row's
      zero roughness under the roughconductor lobe), and its one-hot
      gather spreads a NaN to a whole column of the table: on the 16^2
      glossy Cornell every nonzero entry of the bsdf_params gradient is
      NaN;
    - ``safe_sqrt`` has a zero gradient where its argument is <= 0.
      Unguarded, a branch not taken (total internal reflection in the
      Fresnel term) gives 0 * inf: with the dispatch guarded, column 4
      of the glossy Cornell's table (plastic's eta) and columns 0 and 4
      of the every-BSDF Cornell's are NaN on every row."""
    def dispatch(scene, bsdf_idx, fn_name, *args, level=0):
        depth = getattr(scene, "adapter_max_depth", 1) or 1
        unique = tuple(t for t in sorted(set(scene.bsdf_types))
                       if level < depth or t not in bsdfs_j._ADAPTER_TYPES)
        lane_type = jnp.array(scene.bsdf_types, jnp.int32)[bsdf_idx]
        result = None
        for t in unique:
            mine = lane_type == t
            idx = (jnp.where(mine, bsdf_idx, scene.bsdf_types.index(t))
                   if len(unique) > 1 else bsdf_idx)
            out = getattr(bsdfs_j._REGISTRY[t], fn_name)(scene, idx, *args)
            result = out if result is None else jax.tree_util.tree_map(
                lambda new, old: jnp.where(mine, new, old), out, result)
        return result

    def dispatch_nested(scene, bsdf_idx, fn_name, *args):
        # JAX's own unroll counter, as its dispatch_nested keeps it
        bsdfs_j._nest_level += 1
        try:
            return dispatch(scene, bsdf_idx, fn_name, *args,
                            level=bsdfs_j._nest_level)
        finally:
            bsdfs_j._nest_level -= 1
    monkeypatch.setattr(bsdfs_j, "_dispatch", dispatch)
    monkeypatch.setattr(bsdfs_j, "dispatch_nested", dispatch_nested)
    for mod in (math_j, frame_j, warp_j):
        monkeypatch.setattr(mod, "safe_sqrt", _safe_sqrt_j)


def prb_grads_pair(make, monkeypatch, size=16, max_depth=3, spp=4, seed=0):
    """(jax.grad, port) gradients of mean(render) w.r.t. GRAD_NAMES under
    prb, JAX given the port's NaN guards (`_guarded_jax`)."""
    sj = mj.load_dict(chip_smoke._prb_dict(make(mj, size, size, max_depth)))
    st = mt.load_dict(chip_smoke._prb_dict(make(mt, size, size, max_depth)),
                      device="cpu")
    with monkeypatch.context() as mp:
        _guarded_jax(mp)
        gj = _grads_jax(sj, GRAD_NAMES, spp, seed)
    return gj, _grads_port(st, GRAD_NAMES, spp, seed)


def assert_prb_grads_close(gj, gt):
    """Every entry of both packages' gradients finite, and every port
    gradient within 1e-4 of each table's largest JAX gradient;
    em_radiance's gradient nonzero."""
    for k in GRAD_NAMES:
        assert np.isfinite(np.asarray(gj[k])).all(), k
    _assert_grads_close(gj, gt, GRAD_NAMES, 1e-4)
    assert float(gt["em_radiance"].abs().max()) > 0


def test_glossy_cornell_prb_grads_match_jax(monkeypatch):
    """PRB gradients of bsdf_params and em_radiance on a 16^2 glossy
    Cornell (max_depth 3, 4 spp) against jax.grad; the roughconductor's
    alpha_u and alpha_v gradients are nonzero."""
    gj, gt = prb_grads_pair(chip_smoke.glossy_cornell_dict, monkeypatch)
    assert_prb_grads_close(gj, gt)
    assert float(gt["bsdf_params"][3, 6:8].abs().min()) > 0


UNPORTED = {
    # normalmap, bumpmap and the textures below load: their cases give
    # them what the port still refuses
    "normalmap": {"type": "normalmap", "normalmap": 0.5,
                  "bsdf": {"type": "diffuse"}},
    "bumpmap": {"type": "bumpmap", "bumpmap": 1.0,
                "bsdf": {"type": "diffuse"}},
    # principled, principledthin, hair and measured load, and a sampled
    # spectrum as a color is projected to RGB: their cases give them a
    # sampled spectrum where a scalar is read, or a spectral table, which
    # the port refuses
    "principled": {"type": "principled", "roughness": {
        "type": "regular", "lambda_min": 400, "lambda_max": 700,
        "values": [0.2, 0.8]}},
    "principledthin": {"type": "principledthin", "spec_trans": {
        "type": "blackbody", "temperature": 3000.0}},
    "hair": {"type": "hair", "longitudinal_roughness": {
        "type": "regular", "lambda_min": 400, "lambda_max": 700,
        "values": [0.2, 0.8]}},
    "measured": {"type": "measured", "tables": {
        "wavelengths": np.linspace(400, 700, 4)}},
    "pplastic": {"type": "pplastic"},
    "polarizer": {"type": "polarizer"},
    "retarder": {"type": "retarder"},
    "circular": {"type": "circular"},
    "measured_polarized": {"type": "measured_polarized"},
    "twosided(principled)": {"type": "twosided", "bsdf": {
        "type": "principled", "metallic": {"type": "bitmap",
                                           "data": np.ones((2, 2, 3))}}},
    "bitmap": {"type": "conductor", "specular_reflectance": {
        "type": "bitmap", "filename": "x.png"}},
    "checkerboard": {"type": "roughplastic", "specular_reflectance": {
        "type": "checkerboard"}},
    "volume": {"type": "dielectric", "specular_transmittance": {
        "type": "volume", "volume": {"type": "constvolume"}}},
    "regular": {"type": "mask", "opacity": {
        "type": "regular", "lambda_min": 400, "lambda_max": 700,
        "values": [0.2, 0.8]}, "bsdf": {"type": "diffuse"}},
    "bitmap opacity": {"type": "mask", "opacity": {
        "type": "bitmap", "filename": "x.png", "format": "rgb"},
        "bsdf": {"type": "diffuse"}},
    "checkerboard weight": {"type": "blendbsdf", "weight": {
        "type": "checkerboard", "color0": {"type": "bitmap"}},
        "a": {"type": "diffuse"}, "b": {"type": "conductor"}},
}


@pytest.mark.parametrize("case", sorted(UNPORTED))
def test_unported_bsdf_raises(case):
    """BSDF types outside the slice, and parameters given as a texture
    where the port reads none (or a texture it cannot read), a volume or a
    spectrum, raise NotImplementedError naming them; nothing falls back to
    diffuse."""
    spec = UNPORTED[case]
    d = mt.cornell_box(8, 8, max_depth=2)
    d["small-box"]["bsdf"] = spec
    name = case.split("(")[-1].rstrip(")").split(" ")[0]
    with pytest.raises(NotImplementedError, match=name):
        mt.load_dict(d, device="cpu")
    d = mt.cornell_box(8, 8, max_depth=2)
    d["named"] = spec                      # a top-level named BSDF
    with pytest.raises(NotImplementedError, match=name):
        mt.load_dict(d, device="cpu")
