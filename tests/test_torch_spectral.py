"""Port parity for the spectral variant (hero wavelengths): the RGB ->
spectrum basis and the host SPDs of ``core/spectral.py`` bit-equal to the
JAX package's, its lane functions within a stated rtol; the loader's
rows, SPD tables, emitter slots, specfilm response functions and the
dielectric's dispersion slot bit-equal; ``set_variant`` / ``variant``;
16^2 renders per pixel against JAX (``path`` on a Cornell box with a
blackbody, an RGB and a D65 light, regular, irregular and uniform
reflectances, a bitmap wall, a normal map read raw and an envmap; a
mask over an envmap; a dispersive glass box; a specfilm; ``direct``;
``ptracer``); ``aov``,
``moment`` and a spectral ``.bsdf`` raising in both packages; a JAX
spectral scene carried across by ``convert.py``.

The departure (ROADMAP queue 3): JAX's ``prb``, ``volpath``,
``volpathmis`` and ``prbvolpath`` loops rebuild their rays without the
wavelengths, so their spectral images part from ``path``'s (the witness
test). The port carries them: its ``prb`` image is held per pixel to
JAX's spectral ``path`` image and its gradients to ``jax.grad`` of that
render; its volumetric loops are held to JAX given the wavelengths by
``given_wavelengths`` (no file of the JAX package changes)."""
import contextlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mitsuba3_tpu as mj
from mitsuba3_tpu.core import spectral as j_sp
from mitsuba3_tpu.core.vec import Vec3 as JVec3
from mitsuba3_tpu.render import records as j_records
from mitsuba3_tpu.render import scene as j_scene

import chip_smoke
import mitsuba3_tpu_torch as mt
from mitsuba3_tpu_torch.convert import arrays_from_scene, scene_from_arrays
from mitsuba3_tpu_torch.core import spectral as t_sp
from mitsuba3_tpu_torch.core import spectrum as t_spec
from mitsuba3_tpu_torch.core.vec import Vec3
from test_torch_prb import _assert_grads_close, _grads_port

torch.set_num_threads(1)
SEED, SPP, SIDE, DEPTH = 5, 16, 16, 4
THETA = ("bsdf_params", "em_radiance", "textures", "env_data")


@pytest.fixture(autouse=True)
def rgb_variant():
    """Every test starts and ends in the RGB variant of both packages."""
    mj.set_variant("rgb")
    mt.set_variant("rgb")
    yield
    mj.set_variant("rgb")
    mt.set_variant("rgb")


def _features(mi, integrator: str = "path"):
    """spectral_variant_cornell_dict with the light's RGB radiance back
    (a parameter to differentiate), a D65 lamp, the back wall a bitmap,
    the small box a normal map's bitmap (read raw) and an envmap (the
    box's open side sees it)."""
    rng = np.random.default_rng(7)
    T = mi.ScalarTransform4f
    d = chip_smoke.spectral_variant_cornell_dict(mi, SIDE, SIDE, DEPTH)
    d["light"]["emitter"]["radiance"] = {
        "type": "rgb", "value": chip_smoke.CORNELL_RADIANCE}
    d["lamp"] = {"type": "rectangle", "to_world": T().translate(
        [-0.5, 0.97, -0.3]).rotate([1, 0, 0], 90).scale(0.12),
        "emitter": {"type": "area", "radiance": {"type": "d65",
                                                 "scale": 8.0}}}
    d["back"]["bsdf"] = {"type": "diffuse", "reflectance": {
        "type": "bitmap", "data": rng.uniform(0.2, 0.9, (8, 8, 3)).astype(
            np.float32)}}
    normals = rng.uniform(0.3, 0.7, (4, 4, 3)).astype(np.float32)
    normals[..., 2] = 1.0
    d["small-box"]["bsdf"] = {"type": "normalmap", "normalmap": {
        "type": "bitmap", "data": normals}, "bsdf": {
            "type": "diffuse", "reflectance": {"type": "rgb",
                                               "value": [0.8, 0.75, 0.7]}}}
    d["env"] = {"type": "envmap", "scale": 0.5, "data": rng.uniform(
        0.0, 2.0, (8, 16, 3)).astype(np.float32)}
    d["integrator"] = {"type": integrator, "max_depth": DEPTH}
    return d


def _mask(mi, lift: float = 1e-3):
    """spectral_variant_cornell_dict with the small box a mask (a bitmap
    opacity, read raw) over a diffuse, an envmap, and the box `lift`
    above the floor. On the floor (lift 0) the box's bottom face and the
    floor coincide: a ray that the mask lets into the box hits the one or
    the other as an ulp of the ray decides
    (tests/test_torch_coincident_faces.py)."""
    rng = np.random.default_rng(11)
    d = chip_smoke.spectral_variant_cornell_dict(mi, SIDE, SIDE, DEPTH)
    d["small-box"]["bsdf"] = {"type": "mask", "opacity": {
        "type": "bitmap", "data": rng.uniform(0.3, 0.9, (4, 4, 3)).astype(
            np.float32)}, "bsdf": {"type": "diffuse", "reflectance": {
                "type": "rgb", "value": [0.8, 0.75, 0.7]}}}
    d["env"] = {"type": "envmap", "scale": 0.5, "data": rng.uniform(
        0.0, 2.0, (8, 16, 3)).astype(np.float32)}
    d["small-box"]["to_world"] = mi.ScalarTransform4f().translate(
        [0.0, lift, 0.0]) @ d["small-box"]["to_world"]
    return d


def _plain(mi, integrator: str):
    """spectral_variant_cornell_dict under `integrator`."""
    d = chip_smoke.spectral_variant_cornell_dict(mi, SIDE, SIDE, DEPTH)
    d["integrator"] = {"type": integrator, "max_depth": DEPTH}
    return d


SCENES = {
    "features": _features,
    "mask": _mask,
    "glass": lambda mi: chip_smoke.spectral_variant_cornell_dict(
        mi, SIDE, SIDE, DEPTH, "glass"),
    "specfilm": lambda mi: chip_smoke.spectral_variant_cornell_dict(
        mi, SIDE, SIDE, DEPTH, "specfilm"),
    "direct": lambda mi: _plain(mi, "direct"),
    "ptracer": lambda mi: _plain(mi, "ptracer"),
}


@pytest.fixture(scope="module")
def jax_path():
    """(JAX scene, JAX image) of the features scene under ``path``."""
    scene = mj.load_dict(_features(mj), spectral=True)
    return scene, np.asarray(mj.render(scene, seed=SEED, spp=SPP))


def _hold(img_t, img_j, what):
    """Per pixel: isclose(rtol 1e-3, atol 1e-3) on > 99.5 % of values,
    the means at rtol 1e-3, and a lit, finite image."""
    assert img_t.shape == img_j.shape, what
    assert np.isfinite(img_t).all() and img_t.mean() > 0.01, what
    ok = np.isclose(img_t, img_j, rtol=1e-3, atol=1e-3)
    assert ok.mean() > 0.995, (what, ok.mean())
    assert np.allclose(img_t.mean(), img_j.mean(), rtol=1e-3), what


# --------------------------------------------------------------------------
# core/spectral.py
# --------------------------------------------------------------------------

@pytest.mark.parametrize("what", ["basis", "resample_spd", "blackbody_spd",
                                  "d65_spd"])
def test_basis_and_host_spds_bit_equal(np_rng, what):
    if what == "basis":
        for name in ("_LAM_GRID", "_BASIS"):
            np.testing.assert_array_equal(getattr(t_sp, name),
                                          getattr(j_sp, name))
        assert t_sp._Y_NORM == j_sp._Y_NORM
        return
    cases = {"resample_spd": [(np.sort(np_rng.uniform(300, 900, n)),
                               np_rng.uniform(0, 2, n)) for n in (2, 9, 70)],
             "blackbody_spd": [(t,) for t in (1500.0, 3000.0, 6500.0)],
             "d65_spd": [()]}[what]
    for args in cases:
        got, want = getattr(t_sp, what)(*args), getattr(j_sp, what)(*args)
        assert got.dtype == want.dtype == np.float32
        np.testing.assert_array_equal(got, want)


def _lanes(np_rng, n=4096):
    u = np_rng.uniform(0, 1, n).astype(np.float32)
    rgb = np_rng.uniform(-0.1, 1.2, (3, n)).astype(np.float32)
    return u, rgb


@pytest.mark.parametrize("fn", ["sample_wavelengths", "rgb_to_spectrum",
                                "emission_to_spectrum", "spectral_to_xyz",
                                "eval_spd", "xyz_to_srgb"])
def test_lane_functions_match_jax(np_rng, fn):
    """Wavelengths bit-equal; the upsampling and SPD lookups at rtol 1e-6;
    the CIE weights (exp: the two packages' ulps) at rtol 1e-5."""
    u, rgb = _lanes(np_rng)
    wl_j, pdf_j = j_sp.sample_wavelengths(jnp.asarray(u))
    wl_t, pdf_t = t_sp.sample_wavelengths(torch.as_tensor(u))
    if fn == "sample_wavelengths":
        for a, b in ((wl_t.x, wl_j.x), (wl_t.y, wl_j.y), (wl_t.z, wl_j.z)):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))
        assert pdf_t == pdf_j
        return
    c_j, c_t = JVec3(*map(jnp.asarray, rgb)), Vec3(*map(torch.as_tensor, rgb))
    rtol = 1e-6
    if fn in ("rgb_to_spectrum", "emission_to_spectrum"):
        refl = fn == "rgb_to_spectrum"
        got = t_sp.rgb_to_spectrum(c_t, wl_t, reflectance=refl)
        want = j_sp.rgb_to_spectrum(c_j, wl_j, reflectance=refl)
    elif fn == "spectral_to_xyz":
        got, want = t_sp.spectral_to_xyz(c_t, wl_t), j_sp.spectral_to_xyz(
            c_j, wl_j)
        rtol = 1e-5
    elif fn == "eval_spd":
        table = j_sp.blackbody_spd(4000.0)
        got = t_sp.eval_spd(torch.as_tensor(table), wl_t)
        want = j_sp.eval_spd(jnp.asarray(table), wl_j)
    else:
        img = rgb.T.reshape(64, 64, 3)
        np.testing.assert_allclose(
            t_spec.xyz_to_srgb(torch.as_tensor(img)).numpy(),
            np.asarray(j_sp.xyz_to_srgb(jnp.asarray(img))), rtol=1e-5,
            atol=1e-6)
        return
    for a, b in ((got.x, want.x), (got.y, want.y), (got.z, want.z)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=rtol,
                                   atol=1e-7)


# --------------------------------------------------------------------------
# the loader and set_variant
# --------------------------------------------------------------------------

SPD_FORMS = {
    "regular": {"type": "regular", "lambda_min": 400.0, "lambda_max": 720.0,
                "values": [0.1, 0.3, 0.8, 0.6, 0.2], "scale": 2.0},
    "regular_value_list": {"type": "regular", "value": [0.2, 0.9, 0.4]},
    "irregular_pairs": {"type": "irregular", "value": [
        (420.0, 0.2), (530.0, 0.9), (610.0, 0.4)], "scale": 0.5},
    "irregular_string": {"type": "irregular",
                         "value": chip_smoke.SPECTRAL_GREEN},
    "irregular_arrays": {"type": "irregular",
                         "wavelengths": np.array([350.0, 450.0, 800.0]),
                         "values": np.array([0.3, 0.1, 0.6])},
    "blackbody": {"type": "blackbody", "temperature": 3200.0, "scale": 3.0},
    "d65": {"type": "d65", "scale": 0.25},
    "rgb": {"type": "rgb", "value": [0.1, 0.2, 0.3]},
}


@pytest.mark.parametrize("form", sorted(SPD_FORMS))
def test_spd_rows_equal_jax(form):
    """The loader's SPD of each spectrum form (None for an RGB color)."""
    from mitsuba3_tpu import loader as j_loader
    from mitsuba3_tpu_torch import loader as t_loader
    got, want = (pkg._spd_row(SPD_FORMS[form]) for pkg in (t_loader,
                                                           j_loader))
    if want is None:
        assert got is None
        return
    assert got.dtype == want.dtype == np.float32
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("name", ["features", "glass", "specfilm"])
def test_loader_spectral_tables_equal_jax(name):
    """bsdf_params (texture slots -(k + 2), the dispersion slot [8]),
    bsdf_spd, em_radiance, em_spd and its slots, the film's srfs and the
    flag: bit-equal to the JAX loader's."""
    sj = mj.load_dict(SCENES[name](mj), spectral=True)
    st = mt.load_dict(SCENES[name](mt), device="cpu", spectral=True)
    assert st.spectral and sj.spectral
    for field in ("bsdf_params", "bsdf_spd", "em_radiance", "em_spd"):
        np.testing.assert_array_equal(getattr(st, field).numpy(),
                                      np.asarray(getattr(sj, field)), field)
    assert st.em_spd_slots == sj.em_spd_slots
    assert st.film.srfs == sj.film.srfs
    if name == "glass":
        assert float(st.bsdf_params[-1, 8]) == np.float32(
            chip_smoke.DISPERSIVE_GLASS["dispersion"])
    if name == "specfilm":
        assert len(st.film.srfs) == 4
    # in the RGB variant the same dict keeps no SPD
    rgb = mt.load_dict(SCENES[name](mt), device="cpu")
    assert not rgb.spectral and rgb.bsdf_spd is None and rgb.em_spd is None


@pytest.mark.parametrize("name", ["rgb", "spectral", "scalar_rgb",
                                  "cuda_ad_spectral", "llvm_ad_rgb",
                                  "cuda_mono"])
def test_set_variant_matches_jax(name):
    """The same names select the same variant; others raise."""
    for pkg in (mj, mt):
        if name == "cuda_mono":
            with pytest.raises(ValueError):
                pkg.set_variant(name)
        else:
            pkg.set_variant(name)
    assert mt.variant() == mj.variant()
    assert mt.variants() == mj.variants()


def test_variant_selects_load_dict_and_load_string():
    d = SCENES["glass"](mt)
    xml = chip_smoke.spectral_cornell_xml(8, 8, 2, 4)
    assert not mt.load_dict(d, device="cpu").spectral
    mt.set_variant("cuda_ad_spectral")
    assert mt.load_dict(d, device="cpu").spectral
    assert mt.load_string(xml, device="cpu").spectral
    assert not mt.load_dict(d, device="cpu", spectral=False).spectral
    mt.set_variant("cuda_ad_rgb")
    assert not mt.load_string(xml, device="cpu").spectral


# --------------------------------------------------------------------------
# renders against JAX
# --------------------------------------------------------------------------

@pytest.mark.parametrize("name", ["features", "mask", "glass", "specfilm",
                                  "direct", "ptracer"])
def test_spectral_render_matches_jax(name, jax_path):
    """The 16^2 render at 16 spp per pixel (_hold). ptracer ignores the
    variant in both packages (an RGB image)."""
    st = mt.load_dict(SCENES[name](mt), device="cpu", spectral=True)
    if name == "features":
        img_j = jax_path[1]
    else:
        img_j = np.asarray(mj.render(mj.load_dict(SCENES[name](mj),
                                                  spectral=True),
                                     seed=SEED, spp=SPP))
    img_t = mt.render(st, seed=SEED, spp=SPP).numpy()
    if name == "ptracer":
        # its absolute radiance: hold it relative to the image's scale
        img_t, img_j = img_t / img_j.max(), img_j / img_j.max()
    _hold(img_t, img_j, name)
    assert img_t.shape[-1] == (4 if name == "specfilm" else 3)


@pytest.mark.parametrize("integrator", [{"type": "aov", "aovs":
                                         "dd:depth,nn:sh_normal"},
                                        {"type": "moment"}])
def test_aov_and_moment_raise_in_both(integrator):
    """Their film's channels are not XYZ: both packages raise ValueError
    at develop."""
    d = chip_smoke.spectral_variant_cornell_dict(mj, 4, 4, 1)
    d["integrator"] = integrator
    with pytest.raises(ValueError):
        mj.render(mj.load_dict(d, spectral=True), seed=0, spp=1)
    d = chip_smoke.spectral_variant_cornell_dict(mt, 4, 4, 1)
    d["integrator"] = integrator
    with pytest.raises(ValueError, match="spectral variant"):
        mt.render(mt.load_dict(d, device="cpu", spectral=True), seed=0,
                  spp=1)


def test_spectral_bsdf_file_raises_in_both(tmp_path):
    """A measured BSDF whose .bsdf file has wavelengths (a spectral one,
    written by the port's tensor_io)."""
    from mitsuba3_tpu_torch.utils import tensor_io
    path = str(tmp_path / "spectral.bsdf")
    tensor_io.write(path, wavelengths=np.linspace(400, 700, 3).astype(
        np.float32), **chip_smoke.measured_fields(1, 4, 8))
    spec = {"type": "measured", "filename": path}
    d = chip_smoke.spectral_variant_cornell_dict(mj, 4, 4, 1)
    d["white"] = spec
    with pytest.raises(ValueError, match="spectral"):
        mj.load_dict(d, spectral=True)
    d = chip_smoke.spectral_variant_cornell_dict(mt, 4, 4, 1)
    d["white"] = spec
    with pytest.raises(NotImplementedError, match="spectral measured"):
        mt.load_dict(d, device="cpu", spectral=True)


def test_jax_spectral_scene_carried_across(jax_path):
    """convert.py carries the flag, SPDs, slots and srfs: the carried
    scene renders as JAX's (_hold)."""
    sj, img_j = jax_path
    arrays, meta = arrays_from_scene(sj)
    assert meta["spectral"] and meta["em_spd_slots"] == sj.em_spd_slots
    st = scene_from_arrays(arrays, meta, device="cpu")
    _hold(mt.render(st, seed=SEED, spp=SPP).numpy(), img_j, "carried")
    film = scene_from_arrays(*arrays_from_scene(mj.load_dict(
        SCENES["specfilm"](mj), spectral=True)), device="cpu").film
    assert film.srfs == mj.load_dict(SCENES["specfilm"](mj),
                                     spectral=True).film.srfs


# --------------------------------------------------------------------------
# the departure: prb, volpath, volpathmis and prbvolpath carry wl
# --------------------------------------------------------------------------

def test_jax_prb_parts_from_its_path(jax_path):
    """The witness: JAX's spectral prb image is not its spectral path
    image (its loop drops the wavelengths after the camera ray), though
    the two are equal in RGB."""
    img_prb = np.asarray(mj.render(mj.load_dict(_features(mj, "prb"),
                                                spectral=True),
                                   seed=SEED, spp=SPP))
    assert abs(img_prb.mean() / jax_path[1].mean() - 1.0) > 0.02


def test_prb_primal_and_grads_match_jax_path(jax_path):
    """The port's prb image per pixel equals JAX's spectral path image
    (_hold); its gradients of mean(render) at 4 spp are within 1e-4 of
    each table's largest ``jax.grad`` entry through that path render,
    finite, and nonzero for the BSDF rows, the light and the textures."""
    st = mt.load_dict(_features(mt, "prb"), device="cpu", spectral=True)
    _hold(mt.render(st, seed=SEED, spp=SPP).detach().numpy(), jax_path[1],
          "prb primal")
    sj = jax_path[0]

    def loss(theta):
        return mj.render(sj.replace(**theta), spp=4, seed=0).mean()
    gj = jax.grad(loss)({k: getattr(sj, k) for k in THETA})
    gt = _grads_port(st, THETA, 4, 0)
    for k in ("bsdf_params", "em_radiance", "env_data"):
        assert np.isfinite(np.asarray(gj[k])).all(), k
        assert float(gt[k].abs().max()) > 0, k
    _assert_grads_close(gj, gt, ("bsdf_params", "em_radiance", "env_data"),
                        1e-4)
    # the back wall's reflectance bitmap (the normal map's gradient is
    # another estimator's: prb's attached frame against path's detached
    # sampling)
    k = max(st.texture_ids("diffuse"))
    a, b = np.asarray(gj["textures"][k - 1]), gt["textures"][k - 1]
    assert np.isfinite(a).all() and float(b.abs().max()) > 0
    np.testing.assert_allclose(b.numpy(), a, rtol=0,
                               atol=1e-4 * np.abs(a).max())


@contextlib.contextmanager
def given_wavelengths():
    """JAX's volumetric loops with the wavelengths given back: its
    ``sample_wavelengths`` keeps the lanes' draw, and ``Ray.make`` and the
    NEE reference point attach it to every full-width ray and point that
    lacks one. It holds inside one trace (XLA's caches are cleared around
    it) and where no dispersive dielectric collapses the wavelengths."""
    held = {}
    real = (j_sp.sample_wavelengths, j_records.Ray.make, j_scene._RefPoint)

    def attach(like, wl):
        w = held.get("wl")
        if wl is None and w is not None and w.x.shape == like.x.shape:
            return w
        return wl

    def sample(u):
        held["wl"], pdf = real[0](u)
        return held["wl"], pdf

    def make(o, d, maxt=None, wl=None):
        return real[1](o, d, maxt, attach(o, wl))

    def ref_point(p, t, wavelengths=None):
        return real[2](p=p, t=t, wavelengths=attach(p, wavelengths))

    jax.clear_caches()
    j_sp.sample_wavelengths = sample
    j_records.Ray.make = staticmethod(make)
    j_scene._RefPoint = ref_point
    try:
        yield
    finally:
        j_sp.sample_wavelengths = real[0]
        j_records.Ray.make = staticmethod(real[1])
        j_scene._RefPoint = real[2]
        jax.clear_caches()


def _fog(mi, integrator):
    """The fog Cornell (chip_smoke.fog_cornell_dict) in the spectral
    variant's colors: the blackbody light, regular and irregular walls, a
    uniform floor; no environment."""
    d = chip_smoke.fog_cornell_dict(mi, 12, 12, DEPTH, integrator)
    base = chip_smoke.spectral_variant_cornell_dict(mi, 12, 12, DEPTH)
    for key in ("light", "red", "green", "floor"):
        d[key] = base[key]
    return d


@pytest.mark.parametrize("integrator", ["volpath", "volpathmis",
                                        "prbvolpath"])
def test_volumetric_loops_match_jax_given_wavelengths(integrator):
    """Per pixel (_hold) against JAX's render given the wavelengths, at
    12^2 and 8 spp; JAX's own render parts from it."""
    st = mt.load_dict(_fog(mt, integrator), device="cpu", spectral=True)
    sj = mj.load_dict(_fog(mj, integrator), spectral=True)
    with given_wavelengths():
        img_j = np.asarray(mj.render(sj, seed=SEED, spp=8))
    _hold(mt.render(st, seed=SEED, spp=8).detach().numpy(), img_j,
          integrator)
