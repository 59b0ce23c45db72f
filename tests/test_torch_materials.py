"""Port parity for the slice's BSDFs: principled, principledthin, hair,
measured (isotropic and anisotropic tables, ``core/distr2d.py`` beyond
one slice, ``utils/tensor_io.py``) and a user's registered BSDF, against
the JAX package in the same process.

Module tests draw 4,096 random local frames (both sides of the surface)
and samples from a numpy seed. ``eval_pdf`` agrees at rtol 1e-4 (the
functions take log, exp, pow and asin: GTR1, hair's M_p and I0,
measured's elevation), the measured tables' on all but
``EVAL_OUTLIERS`` of the lanes; ``sample`` agrees on all but a stated
share of the lanes (the third entry of ``CASES``), within rtol 1e-3 /
atol 5e-5, since XLA's transcendentals differ from torch's by an ulp and
a sampled direction amplifies that (tests/test_torch_bsdf.py). Renders
agree per pixel with equal ray counts. JAX runs eagerly: at these sizes
that is faster than its jit. The PRB gradients of these rows are in
tests/test_torch_curves.py."""
import dataclasses
import functools
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mitsuba3_tpu as mj
from mitsuba3_tpu import bsdfs as bsdfs_j
from mitsuba3_tpu.core import distr2d as distr2d_j
from mitsuba3_tpu.core.vec import Vec2 as Vec2J
from mitsuba3_tpu.utils import tensor_io as tensor_io_j

import chip_smoke
import mitsuba3_tpu_torch as mt
from mitsuba3_tpu_torch import bsdfs as bsdfs_t
from mitsuba3_tpu_torch.convert import arrays_from_scene, scene_from_arrays
from mitsuba3_tpu_torch.core import distr2d as distr2d_t
from mitsuba3_tpu_torch.core.struct import struct
from mitsuba3_tpu_torch.core.vec import Vec2, Vec3
from mitsuba3_tpu_torch.utils import tensor_io as tensor_io_t
from test_torch_bsdf import N, _close, _close_vec, _dirs, _vj, _vt

torch.set_num_threads(1)
EVAL_OUTLIERS = {"measured_iso": 1e-3, "measured_aniso": 1e-3}
MEASURED_ISO = chip_smoke.measured_fields(1, 8, 16)
MEASURED_ANISO = chip_smoke.measured_fields(4, 8, 16)
# case -> (BSDF spec, rtol of eval_pdf, share of sample lanes that may
# miss rtol). The measured tables are piecewise constant: an ulp of the
# elevation moves a lane across a cell's edge, so their eval_pdf may miss
# rtol on EVAL_OUTLIERS of the lanes (1 of 4,096 in each case)
CASES = {
    "principled": ({"type": "principled", "metallic": 0.4,
                    "roughness": 0.35, "anisotropic": 0.3, "clearcoat": 0.6,
                    "sheen": 0.3, "spec_tint": 0.2, "flatness": 0.3,
                    "base_color": {"type": "rgb",
                                   "value": [0.8, 0.5, 0.3]}}, 1e-4, 2.5e-3),
    "principled_twosided": ({"type": "twosided", "bsdf": {
        "type": "principled", "clearcoat": 1.0, "clearcoat_gloss": 0.9,
        "roughness": 0.1}}, 1e-4, 2.5e-3),
    "principledthin": ({"type": "principledthin", "spec_trans": 0.6,
                        "diff_trans": 0.5, "roughness": 0.4,
                        "anisotropic": 0.2, "eta": 1.4, "sheen": 0.5,
                        "spec_tint": 0.4, "flatness": 0.3}, 1e-4, 2.5e-3),
    "hair": ({"type": "hair", "eumelanin": 1.3}, 1e-4, 5e-3),
    "hair_sigma_a": ({"type": "hair", "sigma_a": [0.25, 0.45, 0.9],
                      "longitudinal_roughness": 0.2,
                      "azimuthal_roughness": 0.5, "scale_tilt": 3.0},
                     1e-4, 5e-3),
    "measured_iso": ({"type": "measured", "tables": MEASURED_ISO}, 1e-4,
                     5e-3),
    "measured_aniso": ({"type": "measured", "tables": MEASURED_ANISO},
                       1e-4, 5e-3),
}


@functools.lru_cache(maxsize=None)
def _scenes(case):
    d = {"type": "scene",
         "quad": {"type": "rectangle", "bsdf": CASES[case][0]}}
    return mj.load_dict(d), mt.load_dict(d, device="cpu")


@dataclasses.dataclass
class _SIJ:
    wi: object
    t: jnp.ndarray
    uv: object
    wavelengths: object = None


@struct
class _SIT:
    wi: Vec3
    t: torch.Tensor
    uv: Vec2
    vcolor: object = None


def _frames(seed):
    """wi, wo on the sphere, s1, s2 and a uv per lane (hair reads
    h = 2 uv.y - 1)."""
    rng = np.random.default_rng(seed)
    return (_dirs(rng, N), _dirs(rng, N),
            rng.uniform(0, 1, N).astype(np.float32),
            rng.uniform(0, 1, (N, 2)).astype(np.float32),
            rng.uniform(0, 1, (N, 2)).astype(np.float32))


def _si(wi, uv):
    t = np.ones(N, np.float32)
    return (_SIJ(wi=_vj(wi), t=jnp.asarray(t),
                 uv=Vec2J(jnp.asarray(uv[:, 0]), jnp.asarray(uv[:, 1]))),
            _SIT(wi=_vt(wi), t=torch.as_tensor(t),
                 uv=Vec2(torch.as_tensor(uv[:, 0]),
                         torch.as_tensor(uv[:, 1]))))


def _slots(st):
    idx = np.full(N, len(st.bsdf_types) - 1, np.int32)
    return jnp.asarray(idx), torch.as_tensor(idx)


@pytest.mark.parametrize("case", sorted(CASES))
def test_rows_match_jax(case):
    """Rows, types, slot flags bit-equal; measured tables equal."""
    sj, st = _scenes(case)
    np.testing.assert_array_equal(np.asarray(sj.bsdf_params),
                                  st.bsdf_params.numpy())
    assert (tuple(sj.bsdf_types), tuple(sj.bsdf_flags)) == (
        st.bsdf_types, st.bsdf_flags)
    assert len(sj.measured_tables) == len(st.measured_tables)
    for tj, tt in zip(sj.measured_tables, st.measured_tables):
        for key in ("theta_i", "phi_i", "reduction", "spectra", "ndf",
                    "sigma"):
            np.testing.assert_array_equal(np.asarray(tj[key]),
                                          tt[key].numpy(), err_msg=key)
        for key in ("lum", "vndf"):
            for f in ("density", "marg_cdf", "cond_cdf"):
                np.testing.assert_array_equal(
                    np.asarray(getattr(tj[key], f)),
                    getattr(tt[key], f).numpy(), err_msg=f"{key}.{f}")


@pytest.mark.parametrize("case", sorted(CASES))
def test_eval_pdf_matches_jax(case):
    """eval_pdf on random wi, wo (value with the cosine, pdf)."""
    sj, st = _scenes(case)
    wi, wo, _, _, uv = _frames(11)
    si_j, si_t = _si(wi, uv)
    ij, it = _slots(st)
    vj, pj = bsdfs_j.eval_pdf(sj, ij, si_j, _vj(wo))
    vt, pt = bsdfs_t.eval_pdf(st, it, si_t, _vt(wo))
    rtol, out = CASES[case][1], EVAL_OUTLIERS.get(case, 0)
    _close_vec(vj, vt, rtol, "value", outliers=out)
    _close(pj, pt, rtol, "pdf", outliers=out)
    assert np.isfinite(pt.numpy()).all() and (pt.numpy() > 0).mean() > 0.1


@pytest.mark.parametrize("case", sorted(CASES))
def test_sample_matches_jax(case):
    """sample: the lobe equal on every lane; wo, pdf and weight at rtol
    1e-4 but on the case's share of outlier lanes."""
    sj, st = _scenes(case)
    wi, _, s1, s2, uv = _frames(7)
    si_j, si_t = _si(wi, uv)
    ij, it = _slots(st)
    bj, wj = bsdfs_j.sample(sj, ij, si_j, jnp.asarray(s1),
                            Vec2J(jnp.asarray(s2[:, 0]),
                                  jnp.asarray(s2[:, 1])))
    bt, wt = bsdfs_t.sample(st, it, si_t, torch.as_tensor(s1),
                            Vec2(torch.as_tensor(s2[:, 0]),
                                 torch.as_tensor(s2[:, 1])))
    out = CASES[case][2]
    same = (np.asarray(bj.sampled_type).astype(np.int64)
            == bt.sampled_type.numpy())
    assert same.mean() >= 1 - out, int((~same).sum())
    np.testing.assert_array_equal(np.asarray(bj.sampled_component)[same],
                                  bt.sampled_component.numpy()[same])
    _close_vec(bj.wo, bt.wo, 1e-4, "wo", outliers=out)
    _close(bj.pdf, bt.pdf, 1e-4, "pdf", outliers=out)
    _close_vec(wj, wt, 1e-4, "weight", outliers=out)
    assert (bt.pdf.numpy() > 0).mean() > 0.2


# ---------------------------------------------------------------------------
# The sliced warp and tensor I/O
# ---------------------------------------------------------------------------

def test_sliced_marginal_matches_jax():
    """SlicedMarginal2D with S = 6 slices of 8 x 16: sample, invert and
    eval per lane (slice k drawn per lane), and eval_bilinear_sliced,
    against JAX's dense row walks; tables bit-equal."""
    rng = np.random.default_rng(5)
    data = (rng.random((6, 8, 16)) ** 3).astype(np.float32)
    data[2, 3] = 0.0                       # an empty row
    wj = distr2d_j.SlicedMarginal2D.from_data(data)
    wt = distr2d_t.SlicedMarginal2D.from_data(data, "cpu")
    for f in ("density", "marg_cdf", "cond_cdf"):
        np.testing.assert_array_equal(np.asarray(getattr(wj, f)),
                                      getattr(wt, f).numpy())
    k = rng.integers(0, 6, N).astype(np.int32)
    s = rng.random((N, 2)).astype(np.float32)
    kj, kt = jnp.asarray(k), torch.as_tensor(k)
    sj = Vec2J(jnp.asarray(s[:, 0]), jnp.asarray(s[:, 1]))
    st = Vec2(torch.as_tensor(s[:, 0]), torch.as_tensor(s[:, 1]))
    pj, dj = wj.sample(kj, sj)
    pt, dt = wt.sample(kt, st)
    _close(pj.x, pt.x, 1e-6, "sample x")
    _close(pj.y, pt.y, 1e-6, "sample y")
    _close(dj, dt, 1e-6, "sample pdf")
    uj, ej = wj.invert(kj, pj)
    ut, et = wt.invert(kt, pt)
    _close(uj.x, ut.x, 1e-5, "invert x", atol=1e-6)
    _close(uj.y, ut.y, 1e-5, "invert y", atol=1e-6)
    _close(ej, et, 1e-6, "invert pdf")
    np.testing.assert_allclose(ut.x.numpy(), s[:, 0], atol=2e-5)
    _close(wj.eval(kj, sj), wt.eval(kt, st), 0, "eval", atol=0)
    tbl = rng.random((18, 8, 16)).astype(np.float32)
    k3 = (k * 3 + 1).astype(np.int32)
    _close(distr2d_j.eval_bilinear_sliced(jnp.asarray(tbl), jnp.asarray(k3),
                                          sj),
           distr2d_t.eval_bilinear_sliced(torch.as_tensor(tbl),
                                          torch.as_tensor(k3), st),
           1e-6, "eval_bilinear_sliced")


def test_tensor_io_round_trip_and_jax_files(tmp_path):
    """The port's write and read round-trip every field; a file JAX's
    write wrote reads the same, and both writers write the same bytes."""
    fields = dict(MEASURED_ANISO, wavelengths=np.arange(3, dtype=np.float64),
                  counts=np.arange(6, dtype=np.int32).reshape(2, 3))
    pt, pj = str(tmp_path / "t.bsdf"), str(tmp_path / "j.bsdf")
    tensor_io_t.write(pt, **fields)
    tensor_io_j.write(pj, **fields)
    with open(pt, "rb") as a, open(pj, "rb") as b:
        assert a.read() == b.read()
    for back in (tensor_io_t.read(pt), tensor_io_t.read(pj)):
        assert sorted(back) == sorted(fields)
        for key, v in fields.items():
            assert back[key].dtype == v.dtype, key
            np.testing.assert_array_equal(back[key], v, err_msg=key)


# ---------------------------------------------------------------------------
# Renders
# ---------------------------------------------------------------------------

def _half_diffuse_jax():
    """tests/test_custom_plugins.py:40's half_diffuse for the JAX package:
    its diffuse module under the row half_diffuse_lower writes."""
    from mitsuba3_tpu.bsdfs import diffuse
    return mj.register_bsdf(
        "half_diffuse", types.SimpleNamespace(
            FLAGS=diffuse.FLAGS, sample=diffuse.sample,
            eval_pdf=diffuse.eval_pdf), chip_smoke.half_diffuse_lower)


def _register():
    _half_diffuse_jax()
    chip_smoke.register_half_diffuse(mt)


def _materials(pkg, size, depth):
    return chip_smoke.materials_cornell_dict(
        pkg, size, size, depth, {"tables": MEASURED_ISO},
        {"tables": MEASURED_ANISO})


def _render_pair(dj, dt, spp, seed):
    sj = mj.load_dict(dj)
    st = mt.load_dict(dt, device="cpu")
    with jax.disable_jit():
        img_j, rays_j = mj.render_with_stats(sj, seed=seed, spp=spp)
    img_t, rays_t = mt.render_with_stats(st, seed=seed, spp=spp)
    return np.asarray(img_j), int(rays_j), img_t.numpy(), int(rays_t), sj, st


def _assert_images_close(img_j, img_t, rays_j, rays_t, close=0.995):
    """Ray counts equal; > `close` of the values isclose 1e-3, means rtol
    1e-3; every value finite and some positive."""
    assert np.isfinite(img_t).all() and img_t.max() > 0
    assert rays_t == rays_j
    share = np.isclose(img_t, img_j, rtol=1e-3, atol=1e-3).mean()
    assert share > close, share
    np.testing.assert_allclose(img_t.mean(), img_j.mean(), rtol=1e-3)


def test_materials_cornell_render_matches_jax():
    """The materials Cornell (principled floor and textured left wall,
    principledthin small box, measured back wall (isotropic) and tall box
    (anisotropic), half_diffuse right wall) at 16^2, max_depth 4, 4 spp,
    per pixel against JAX; the JAX scene's leaves (its measured tables
    among them) carried into the port render the same image."""
    _register()
    img_j, rays_j, img_t, rays_t, sj, st = _render_pair(
        _materials(mj, 16, 4), _materials(mt, 16, 4), 4, 5)
    _assert_images_close(img_j, img_t, rays_j, rays_t)
    assert set(st.bsdf_types) >= {12, 15, 18, bsdfs_t.custom_type(
        "half_diffuse")[0]}
    carried = scene_from_arrays(*arrays_from_scene(sj), device="cpu")
    img_c, rays_c = mt.render_with_stats(carried, seed=5, spp=4)
    np.testing.assert_array_equal(img_c.numpy(), img_t)
    assert rays_c == rays_t


def _backlit(pkg, dt, st):
    """tests/test_bsdf.py:389's principledthin sheet before a light."""
    d = {
        "type": "scene",
        "integrator": {"type": "path", "max_depth": 3},
        "sensor": {"type": "perspective", "fov": 45.0,
                   "to_world": pkg.ScalarTransform4f().look_at(
                       origin=[0, 0, -3], target=[0, 0, 0], up=[0, 1, 0]),
                   "film": {"width": 16, "height": 16,
                            "rfilter": {"type": "box"}},
                   "sampler": {"type": "independent", "sample_count": 8}},
        "sheet": {"type": "rectangle",
                  "bsdf": {"type": "principledthin",
                           "base_color": {"type": "rgb",
                                          "value": [0.8, 0.8, 0.8]},
                           "roughness": 0.3, "spec_trans": st,
                           "diff_trans": dt, "eta": 1.5}},
        "light": {"type": "rectangle",
                  "to_world": pkg.ScalarTransform4f().translate(
                      [0, 0, 2.0]).rotate([0, 1, 0], 180).scale(1.5),
                  "emitter": {"type": "area", "radiance": {
                      "type": "rgb", "value": [10, 10, 10]}}}}
    return d


@pytest.mark.parametrize("dt,st", [(1.0, 0.0), (0.5, 0.6)])
def test_principledthin_backlit_matches_jax(dt, st):
    """The backlit thin sheet, diffuse and specular transmission, per
    pixel against JAX at 8 spp; light comes through."""
    img_j, rays_j, img_t, rays_t, _, _ = _render_pair(
        _backlit(mj, dt, st), _backlit(mt, dt, st), 8, 3)
    _assert_images_close(img_j, img_t, rays_j, rays_t)
    assert img_t[4:12, 4:12].mean() > 0.05


def _half_scene(pkg, bsdf):
    """tests/test_custom_plugins.py's scene: a floor under a constant
    environment."""
    T = pkg.ScalarTransform4f
    return {"type": "scene",
            "integrator": {"type": "path", "max_depth": 3},
            "sensor": {"type": "perspective", "fov": 45.0,
                       "to_world": T().look_at(origin=[0, 1.0, -4],
                                               target=[0, 0, 0],
                                               up=[0, 1, 0]),
                       "film": {"width": 24, "height": 24,
                                "rfilter": {"type": "box"}},
                       "sampler": {"type": "independent",
                                   "sample_count": 8}},
            "floor": {"type": "rectangle",
                      "to_world": T().rotate([1, 0, 0], -90).scale(2.0),
                      "bsdf": bsdf},
            "env": {"type": "constant",
                    "radiance": {"type": "rgb", "value": 1.0}}}


def test_custom_bsdf_renders_as_jax_and_as_half_diffuse():
    """half_diffuse, registered in both packages (ids from 100; again
    keeps the id), renders as JAX's does and exactly as the port's
    diffuse at half the reflectance; lane_flags know its id."""
    _register()
    tid = chip_smoke.register_half_diffuse(mt)
    assert tid >= bsdfs_t.CUSTOM_BASE
    assert chip_smoke.register_half_diffuse(mt) == tid
    half = {"type": "half_diffuse",
            "reflectance": {"type": "rgb", "value": [0.8, 0.6, 0.4]}}
    img_j, rays_j, img_t, rays_t, _, st = _render_pair(
        _half_scene(mj, half), _half_scene(mt, half), 8, 2)
    _assert_images_close(img_j, img_t, rays_j, rays_t, close=0.999)
    assert st.bsdf_types == (tid,)
    assert int(bsdfs_t.lane_flags(st.bsdf_types, torch.zeros(
        1, dtype=torch.int64))[0]) == 0x2002
    diffuse = mt.load_dict(_half_scene(mt, {
        "type": "diffuse",
        "reflectance": {"type": "rgb", "value": [0.4, 0.3, 0.2]}}),
        device="cpu")
    img_d, rays_d = mt.render_with_stats(diffuse, seed=2, spp=8)
    np.testing.assert_array_equal(img_d.numpy(), img_t)
    assert rays_d == rays_t


# ---------------------------------------------------------------------------
# Plumbing: traverse and update(), XML
# ---------------------------------------------------------------------------

def test_traverse_update_of_new_rows_matches_jax():
    """traverse of the materials Cornell has JAX's keys and values; an
    edit of the principled, principledthin and measured rows (the
    principled wall's texture id cleared) and of the checkerboard texture
    through update() gives JAX's rows and textures, and the port's
    re-derived dispatch tables name no texture for principled."""
    _register()
    sj = mj.load_dict(_materials(mj, 8, 2))
    st = mt.load_dict(_materials(mt, 8, 2), device="cpu")
    pj, pt = mj.traverse(sj), mt.traverse(st)
    assert sorted(pj.keys()) == sorted(pt.keys())
    for k in pt.keys():
        np.testing.assert_array_equal(pt[k].numpy(), np.asarray(pj[k]),
                                      err_msg=k)
    rows = pt["bsdf_params"].numpy().copy()
    pr = [i for i, t in enumerate(st.bsdf_types) if t == 12]
    rows[pr[0], 4] = 0.9                   # the floor's metallic
    rows[pr[1], 3] = 0.0                   # the wall's texture cleared
    rows[st.bsdf_types.index(18), 4] = 0.2  # the small box's spec_trans
    tex = pt["texture0.data"].numpy() * 0.5
    for p in (pj, pt):
        p["bsdf_params"] = rows
        p["texture0.data"] = tex
    uj, ut = pj.update(), pt.update()
    np.testing.assert_array_equal(ut.bsdf_params.numpy(),
                                  np.asarray(uj.bsdf_params))
    np.testing.assert_array_equal(ut.textures[0].numpy(),
                                  np.asarray(uj.textures[0]))
    assert dict(st.bsdf_textures)["principled"] == (1,)
    assert dict(ut.bsdf_textures)["principled"] == ()
    assert len(ut.measured_tables) == 2


def test_xml_lowers_new_plugins_as_jax(tmp_path):
    """An XML scene with principled (a bitmap base_color), principledthin,
    hair (melanin and sigma_a), measured (a .bsdf file), half_diffuse and
    linearcurve / bsplinecurve shapes parses to JAX's dict; its load_file
    scene's leaves (rows, measured tables, tube meshes) equal JAX's."""
    from mitsuba3_tpu.utils import xml as xml_j
    from mitsuba3_tpu_torch.utils import image_io
    from mitsuba3_tpu_torch.utils import xml as xml_t
    _register()
    image_io.write_image(str(tmp_path / "base.exr"),
                         np.random.default_rng(2).random((8, 8, 3)))
    tensor_io_t.write(str(tmp_path / "iso.bsdf"), **MEASURED_ISO)
    cp = chip_smoke.write_curve_file(
        str(tmp_path / "hair.txt"), chip_smoke.hair_strands(8, 5), 0.01)
    xml = f"""<scene version="3.0.0">
  <integrator type="path"><integer name="max_depth" value="3"/></integrator>
  <sensor type="perspective"><float name="fov" value="45"/>
    <film type="hdrfilm"><integer name="width" value="8"/>
      <integer name="height" value="8"/></film></sensor>
  <bsdf type="principled" id="p">
    <texture type="bitmap" name="base_color">
      <string name="filename" value="base.exr"/></texture>
    <float name="metallic" value="0.4"/><float name="clearcoat" value="0.6"/>
    <float name="anisotropic" value="0.3"/></bsdf>
  <bsdf type="principledthin" id="t"><float name="spec_trans" value="0.6"/>
    <float name="diff_trans" value="0.5"/>
    <rgb name="base_color" value="0.7, 0.8, 0.9"/></bsdf>
  <bsdf type="measured" id="m"><string name="filename" value="iso.bsdf"/>
  </bsdf>
  <bsdf type="half_diffuse" id="h"><rgb name="reflectance" value="0.5"/>
  </bsdf>
  <shape type="rectangle"><ref id="p"/></shape>
  <shape type="cube"><ref id="t"/></shape>
  <shape type="rectangle"><ref id="m"/></shape>
  <shape type="rectangle"><ref name="bsdf" id="h"/></shape>
  <shape type="linearcurve"><string name="filename" value="hair.txt"/>
    <boolean name="tessellate" value="true"/>
    <integer name="n_sides" value="4"/>
    <bsdf type="hair"><float name="eumelanin" value="0.8"/></bsdf></shape>
  <shape type="bsplinecurve"><string name="filename" value="hair.txt"/>
    <boolean name="tessellate" value="true"/>
    <integer name="subdiv" value="2"/>
    <bsdf type="hair"><rgb name="sigma_a" value="0.2, 0.3, 0.4"/>
      <float name="scale_tilt" value="3"/></bsdf></shape>
</scene>"""
    path = str(tmp_path / "scene.xml")
    with open(path, "w") as f:
        f.write(xml)
    assert xml_t.parse_file(path) == xml_j.parse_file(path)
    st = mt.load_file(path, device="cpu")
    sj = mj.load_file(path)
    at, meta_t = arrays_from_scene(st)
    aj, meta_j = arrays_from_scene(sj)
    assert sorted(at) == sorted(aj)
    for k in at:
        np.testing.assert_array_equal(at[k], aj[k], err_msg=k)
    assert meta_t["bsdf_types"][:4] == (12, 18, 15, bsdfs_t.custom_type(
        "half_diffuse")[0])
    assert len(st.measured_tables) == 1 and len(st.textures) == 1
