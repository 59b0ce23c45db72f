"""Port parity for the other integrators: ``direct``, ``aov`` (each AOV,
with and without a nested ``path``), ``depth``, ``moment`` and the light
tracer ``ptracer`` against the JAX package's renders per pixel at the
same seed (ray counts equal), the registry and its configs (a moment's
nested integrator, an aov's ``aovs`` string, the integrators that stay
refused), the film's channel count, ``convert.py`` both ways with nested
configs, and XML lowering. JAX's renders run eagerly
(``jax.disable_jit``), faster than compiling them at these sizes
(``tests/jax_side_times.py``). Every tolerance is stated at its assert."""
import dataclasses

import jax
import numpy as np
import pytest
import torch

import mitsuba3_tpu as mj
from mitsuba3_tpu import integrators as integrators_j
from mitsuba3_tpu.integrators.ptracer import render_ptracer as ptracer_j
from mitsuba3_tpu.utils import xml as xml_j

import chip_smoke
import mitsuba3_tpu_torch as mt
from mitsuba3_tpu_torch import integrators as integrators_t
from mitsuba3_tpu_torch.convert import arrays_from_scene, scene_from_arrays
from mitsuba3_tpu_torch.integrators.ptracer import render_ptracer as ptracer_t
from mitsuba3_tpu_torch.render import integrator as ri
from mitsuba3_tpu_torch.utils import xml as xml_t

torch.set_num_threads(1)

PATH = {"type": "path", "max_depth": 4}
AOVS = ("depth", "position", "uv", "geo_normal", "sh_normal", "albedo",
        "prim_index", "shape_index")


def cornell(mi, integrator, side=16, extra=False):
    """bench.py's Cornell box at side^2 under `integrator`; with `extra`,
    also a constant environment and a point light (NEE's delta and
    environment branches)."""
    d = dict(mi.cornell_box(side, side, max_depth=4), integrator=integrator)
    if extra:
        d["env"] = {"type": "constant", "radiance": {"type": "rgb",
                                                     "value": 0.2}}
        d["lamp"] = {"type": "point", "position": [0.3, 0.6, 0.5],
                     "intensity": {"type": "rgb", "value": [2, 1.5, 1]}}
    return d


def _render_pair(dj, dt, spp=4, seed=5):
    """(JAX image, rays, port image, rays) at the same seed."""
    sj = mj.load_dict(dj)
    st = mt.load_dict(dt, device="cpu")
    with jax.disable_jit():
        img_j, rays_j = mj.render_with_stats(sj, seed=seed, spp=spp)
    img_t, rays_t = mt.render_with_stats(st, seed=seed, spp=spp)
    return np.asarray(img_j), float(rays_j), img_t.numpy(), rays_t


def _assert_same(img_j, rays_j, img_t, rays_t, channels):
    """Per pixel: allclose rtol 1e-5, atol 1e-5 (the 16^2 renders here
    agree to 4e-6), finite, the channel count as given, ray counts
    equal."""
    assert img_t.shape == img_j.shape == (16, 16, channels)
    assert np.isfinite(img_t).all()
    np.testing.assert_allclose(img_t, img_j, rtol=1e-5, atol=1e-5)
    assert rays_t == rays_j


@pytest.mark.parametrize("spec", [
    {"type": "direct"},
    {"type": "direct", "emitter_samples": 2, "bsdf_samples": 1},
    {"type": "direct", "shading_samples": 2, "hide_emitters": True},
    {"type": "depth"},
    {"type": "aov", "aovs": "dd:depth,nn:sh_normal"},
    {"type": "aov", "aovs": ["albedo", "uv"], "integrator": PATH},
    {"type": "moment", "nested": PATH},
    {"type": "moment", "nested": {"type": "direct"}},
    {"type": "moment"},
    {"type": "ptracer", "max_depth": 6, "rr_depth": 3}])
def test_config_from_dict_matches_jax(spec):
    """The port's config equals JAX's field by field (nested configs
    too), and ``config_to_dict`` gives it back."""
    cj = integrators_j.config_from_dict(spec)
    ct = integrators_t.config_from_dict(spec)

    def fields(c):
        if not dataclasses.is_dataclass(c):
            return c
        return {f.name: fields(getattr(c, f.name))
                for f in dataclasses.fields(c)}
    assert fields(ct) == fields(cj)
    assert integrators_t.config_from_dict(
        integrators_t.config_to_dict(ct)) == ct
    assert (integrators_t.n_channels(ct)
            == getattr(integrators_j.get_integrator(cj), "n_channels",
                       lambda c: 3)(cj))


@pytest.mark.parametrize("itype", ["stokes", "volprim_rf_basic",
                                   "prb_projective", "direct_projective"])
def test_unported_integrators_refused(itype):
    with pytest.raises(NotImplementedError, match=itype):
        mt.load_dict(cornell(mt, {"type": itype}), device="cpu")


@pytest.mark.parametrize("spec,extra", [
    ({"type": "direct"}, False),
    ({"type": "direct", "emitter_samples": 2, "bsdf_samples": 1,
      "hide_emitters": True}, True)])
def test_direct_matches_jax(spec, extra):
    _assert_same(*_render_pair(cornell(mj, spec, extra=extra),
                               cornell(mt, spec, extra=extra)), 3)


def test_depth_matches_jax():
    _assert_same(*_render_pair(cornell(mj, {"type": "depth"}, extra=True),
                               cornell(mt, {"type": "depth"}, extra=True)),
                 3)


@pytest.mark.parametrize("aov", AOVS)
def test_each_aov_matches_jax(aov):
    spec = {"type": "aov", "aovs": f"x:{aov}"}
    size = integrators_t.aov_mod.AOV_SIZES[aov]
    _assert_same(*_render_pair(cornell(mj, spec), cornell(mt, spec)), size)


def test_every_aov_with_nested_path_matches_jax():
    """All eight AOVs (17 channels) then the nested path's RGB; the RGB
    equals the port's plain path render of the same seed (the aov draws
    no random number)."""
    spec = {"type": "aov", "aovs": ",".join(f"a{k}:{a}" for k, a in
                                            enumerate(AOVS)),
            "integrator": PATH}
    img_j, rays_j, img_t, rays_t = _render_pair(cornell(mj, spec),
                                                cornell(mt, spec))
    _assert_same(img_j, rays_j, img_t, rays_t, 20)
    path = mt.render(mt.load_dict(cornell(mt, PATH), device="cpu"), seed=5,
                     spp=4)
    np.testing.assert_array_equal(img_t[..., 17:], path.numpy())


def test_moment_matches_jax():
    """[R, G, B, X, Y, Z, m2X, m2Y, m2Z] per pixel; its RGB equals the
    nested path's render."""
    spec = {"type": "moment", "nested": PATH}
    img_j, rays_j, img_t, rays_t = _render_pair(cornell(mj, spec, extra=True),
                                                cornell(mt, spec, extra=True))
    _assert_same(img_j, rays_j, img_t, rays_t, 9)
    path = mt.render(mt.load_dict(cornell(mt, PATH, extra=True),
                                  device="cpu"), seed=5, spp=4)
    np.testing.assert_array_equal(img_t[..., :3], path.numpy())


@pytest.mark.parametrize("make,max_wavefront", [
    (lambda mi: cornell(mi, {"type": "ptracer", "max_depth": 6}), 1 << 19),
    (lambda mi: chip_smoke.directionalarea_cornell_dict(mi, 16, 16, 4,
                                                        "ptracer"), 512)])
def test_ptracer_matches_jax(make, max_wavefront):
    """The light tracer at 4 light paths a pixel: the Cornell box in one
    pass, and the directionalarea Cornell (its ceiling light emitting
    along its normal, a disk light) in two passes of 512 paths: allclose
    rtol 1e-4, atol 1e-6 per pixel (the splat adds in another order here
    than XLA's scatter; 2.4e-7 apart at most in practice)."""
    sj = mj.load_dict(make(mj))
    st = mt.load_dict(make(mt), device="cpu")
    with jax.disable_jit():
        img_j = np.asarray(ptracer_j(sj, seed=3, spp=4,
                                     max_wavefront=max_wavefront))
    img_t = ptracer_t(st, seed=3, spp=4, max_wavefront=max_wavefront).numpy()
    assert img_t.shape == (16, 16, 3) and np.isfinite(img_t).all()
    assert img_t.mean() > 0
    np.testing.assert_allclose(img_t, img_j, rtol=1e-4, atol=1e-6)


def test_ptracer_third_pass_seed_wraps_where_jax_overflows():
    """JAX seeds pass i with ``jnp.uint32(seed ^ (i * 0x9E3779B9))``,
    unmasked: from pass 2 on the product passes 2^32 and JAX raises
    OverflowError. The port wraps the seed to 32 bits, which equals JAX's
    for passes 0 and 1 (held per pixel by ``test_ptracer_matches_jax``
    at two passes) and renders three."""
    assert [ri.pass_seed(7, i) for i in range(2)] == [
        int(jax.numpy.uint32(7 ^ (i * 0x9E3779B9))) for i in range(2)]
    # JAX's expression for pass 2 (integrators/ptracer.py:224)
    with pytest.raises(OverflowError):
        jax.numpy.uint32(7 ^ (2 * 0x9E3779B9))
    st = mt.load_dict(cornell(mt, {"type": "ptracer", "max_depth": 2}, 8),
                      device="cpu")
    img = ptracer_t(st, seed=7, spp=3, max_wavefront=64)
    assert bool(torch.isfinite(img).all()) and float(img.mean()) > 0


def test_render_sends_ptracer_and_sizes_the_film():
    """``render`` sends a ptracer scene to ``render_ptracer`` (spp or 16);
    ``render_with_stats`` of a ptracer scene raises as JAX's does."""
    st = mt.load_dict(cornell(mt, {"type": "ptracer", "max_depth": 3}, 8),
                      device="cpu")
    np.testing.assert_array_equal(mt.render(st, seed=2).numpy(),
                                  ptracer_t(st, seed=2, spp=16).numpy())
    with pytest.raises(NotImplementedError, match="render_ptracer"):
        mt.render_with_stats(st, seed=2, spp=4)


@pytest.mark.parametrize("spec", [
    {"type": "moment", "nested": {"type": "aov", "aovs": "d:depth",
                                  "integrator": PATH}},
    {"type": "aov", "aovs": "a:albedo,s:shape_index",
     "integrator": {"type": "direct"}},
    {"type": "ptracer", "max_depth": 5}])
def test_convert_carries_nested_configs(spec):
    """JAX's scene leaves and nested configs carried into the port
    (``scene_from_arrays``) give the port's own scene's config, and its
    arrays round-trip."""
    sj = mj.load_dict(cornell(mj, spec, 8))
    st = mt.load_dict(cornell(mt, spec, 8), device="cpu")
    carried = scene_from_arrays(*arrays_from_scene(sj), device="cpu")
    assert carried.integrator == st.integrator
    arrays, meta = arrays_from_scene(st)
    again = scene_from_arrays(arrays, meta, device="cpu")
    assert again.integrator == st.integrator
    if spec["type"] != "ptracer":
        np.testing.assert_array_equal(
            mt.render(carried, seed=1, spp=2).numpy(),
            mt.render(st, seed=1, spp=2).numpy())


INTEGRATOR_XML = {
    "direct": '<integrator type="direct"><integer name="emitter_samples" '
              'value="2"/></integrator>',
    "depth": '<integrator type="depth"/>',
    "aov": '<integrator type="aov"><string name="aovs" '
           'value="dd:depth,nn:sh_normal,a:albedo"/><integrator '
           'type="path"><integer name="max_depth" value="3"/></integrator>'
           '</integrator>',
    "moment": '<integrator type="moment"><integrator type="volpath">'
              '<integer name="max_depth" value="5"/></integrator>'
              '</integrator>',
    "ptracer": '<integrator type="ptracer"><integer name="max_depth" '
               'value="5"/></integrator>',
}


@pytest.mark.parametrize("name", sorted(INTEGRATOR_XML))
def test_xml_integrators_lower_as_jax(name):
    """An XML scene with each integrator lowers to JAX's dict and loads to
    JAX's config."""
    xml = ('<scene version="3.0.0">' + INTEGRATOR_XML[name]
           + '<shape type="rectangle"><emitter type="area"/></shape>'
           '<sensor type="perspective"><film type="hdrfilm"><integer '
           'name="width" value="8"/><integer name="height" value="8"/>'
           '</film></sensor></scene>')
    dj = xml_j.parse_string(xml)
    dt = xml_t.parse_string(xml)
    assert dt == dj
    cj = mj.load_dict(dj).integrator
    ct = mt.load_string(xml, device="cpu").integrator
    assert integrators_t.config_to_dict(cj) == integrators_t.config_to_dict(
        ct)
