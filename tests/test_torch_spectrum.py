"""Port parity for spectra in an RGB scene: ``core/spectrum.py``'s CIE
fits, SPD projection, blackbody and D65 are bit-equal to the JAX
package's, its RGB conversions agree on tensors; every spectrum form the
JAX loader's ``_rgb`` reads lowers to JAX's color bit for bit, keys it
ignores are refused; and the Cornell box with a blackbody light and sampled reflectances renders as
JAX renders it, from a dict and from XML source."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mitsuba3_tpu as mj
from mitsuba3_tpu import loader as j_loader
from mitsuba3_tpu.core import spectrum as j_spec

import chip_smoke
import mitsuba3_tpu_torch as mt
from mitsuba3_tpu_torch import loader as t_loader
from mitsuba3_tpu_torch.core import spectrum as t_spec

torch.set_num_threads(1)
SEED, SPP = 5, 4

SPECS = {
    "blackbody": {"type": "blackbody", "temperature": 3200.0,
                  "scale": 0.5},
    "blackbody_default": {"type": "blackbody"},
    "regular_values": {"type": "regular", "lambda_min": 400.0,
                       "lambda_max": 720.0,
                       "values": [0.1, 0.3, 0.8, 0.6, 0.2]},
    "regular_value_list": {"type": "regular", "value": [0.2, 0.9, 0.4]},
    "regular_string": {"type": "regular",
                       "value": "380:0.1, 500:0.7, 780:0.3"},
    "irregular_pairs": {"type": "irregular",
                        "value": [(420.0, 0.2), (530.0, 0.9),
                                  (610.0, 0.4), (690.0, 0.1)]},
    "irregular_string": {"type": "irregular",
                         "value": chip_smoke.SPECTRAL_GREEN},
    "irregular_arrays": {"type": "irregular",
                         "wavelengths": np.array([350.0, 450.0, 800.0]),
                         "values": np.array([0.3, 0.1, 0.6])},
}


@pytest.mark.parametrize("fn", ["cie1931_xyz_bar", "spd_to_rgb",
                                "blackbody_rgb", "d65_rgb"])
def test_host_projection_bit_equal(np_rng, fn):
    if fn == "cie1931_xyz_bar":
        wl = np.linspace(300.0, 850.0, 1001)
        for got, want in zip(t_spec.cie1931_xyz_bar(wl),
                             j_spec.cie1931_xyz_bar(wl)):
            np.testing.assert_array_equal(got, want)
        return
    cases = {"spd_to_rgb": [(np.sort(np_rng.uniform(300, 900, n)),
                             np_rng.uniform(0, 2, n)) for n in (2, 17, 90)],
             "blackbody_rgb": [(t,) for t in (0.5, 1000.0, 2700.0, 6500.0,
                                              25000.0)],
             "d65_rgb": [(), (0.25,)]}[fn]
    for args in cases:
        got = getattr(t_spec, fn)(*args)
        want = getattr(j_spec, fn)(*args)
        assert got.dtype == want.dtype == np.float32
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("fn", ["luminance", "srgb_to_xyz", "xyz_to_srgb"])
def test_tensor_conversions_match_jax(np_rng, fn):
    x = np_rng.uniform(0, 4, (257, 3)).astype(np.float32)
    got = getattr(t_spec, fn)(torch.as_tensor(x)).numpy()
    want = np.asarray(getattr(j_spec, fn)(jnp.asarray(x)))
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("form", list(SPECS))
def test_every_spectrum_form_equals_jax(form):
    got = t_loader._rgb(SPECS[form])
    want = j_loader._rgb(SPECS[form])
    assert got.dtype == want.dtype == np.float32
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("spec,match", [
    ({"type": "regular", "wavelength_min": 400.0, "values": [0.5, 0.5]},
     r"regular spectrum properties \['wavelength_min'\]"),
    ({"type": "irregular", "lambda_min": 400.0, "value": "400:1, 700:1"},
     r"irregular spectrum properties \['lambda_min'\]"),
    ({"type": "blackbody", "temperature": 5000.0, "unit": "W"},
     r"blackbody spectrum properties \['unit'\]"),
])
def test_keys_jax_ignores_are_refused(spec, match):
    with pytest.raises(NotImplementedError, match=match):
        t_loader._rgb(spec)


def test_sampled_spectrum_as_a_scalar_is_refused():
    d = mt.cornell_box(8, 8, max_depth=2)
    d["white"] = {"type": "principled",
                  "roughness": {"type": "blackbody", "temperature": 3000.0}}
    with pytest.raises(NotImplementedError,
                       match="principled's roughness given as a spectrum "
                             "type 'blackbody'"):
        mt.load_dict(d, device="cpu")


@pytest.mark.parametrize("source", ["load_dict", "load_string"])
def test_spectral_cornell_matches_jax(source):
    """The light's RGB is JAX's blackbody_rgb times its scale, bit for
    bit, and the 16^2 render agrees per pixel."""
    if source == "load_dict":
        j_scene = mj.load_dict(chip_smoke.spectral_cornell_dict(mj, 16, 16,
                                                                4))
        t_scene = mt.load_dict(chip_smoke.spectral_cornell_dict(mt, 16, 16,
                                                                4),
                               device="cpu")
        light = j_spec.blackbody_rgb(6500.0) * 4e-4
        np.testing.assert_array_equal(t_scene.em_radiance[0].numpy(), light)
    else:
        xml = chip_smoke.spectral_cornell_xml(16, 16, 4, SPP)
        j_scene, t_scene = mj.load_string(xml), mt.load_string(xml,
                                                               device="cpu")
    np.testing.assert_array_equal(t_scene.bsdf_params.numpy(),
                                  np.asarray(j_scene.bsdf_params))
    np.testing.assert_array_equal(t_scene.em_radiance.numpy(),
                                  np.asarray(j_scene.em_radiance))
    img_j = np.asarray(mj.render(j_scene, seed=SEED, spp=SPP))
    img_t = mt.render(t_scene, seed=SEED, spp=SPP).numpy()
    assert np.isfinite(img_t).all() and img_t.mean() > 0.01
    assert np.isclose(img_t, img_j, rtol=1e-3, atol=1e-3).mean() > 0.995
    assert np.allclose(img_t.mean(), img_j.mean(), rtol=1e-3)
