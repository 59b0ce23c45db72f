"""Scene-dict loader — counterpart of ``load_dict`` in ``mitsuba3_tpu/loader.py``,
for the plugins the port carries:

- ``mesh`` shapes given as ``vertices``/``faces`` arrays (with optional
  per-vertex ``uvs`` and shading ``normals``), ``rectangle``, ``cube``,
  the mesh files ``obj``, ``ply`` and ``serialized``, ``sphere``,
  ``disk`` and ``cylinder`` (analytic rows, ``scene.analytic_prims``,
  unless an emitter, ``flip_normals`` or a to_world that is not rigid
  with a uniform scale makes the JAX loader tessellate them),
  ``linearcurve`` and ``bsplinecurve`` (round-cone rows, or tubes where
  JAX tessellates them: ``tessellate``, an emitter, or more than 512
  cones), ``sdfgrid`` (a grid or a ``.vol`` file, ``scene.sdf_grids``
  and ``sdf_rows``), ``ellipsoidsmesh`` (baked shells, by default in a
  vertex-color diffuse), the children of a ``merge``, and ``shapegroup``s
  placed by ``instance``s (each group lowered once into prototype-space
  faces past ``n_query_faces``, its own cellserve above 8192 faces, and
  ``scene.instances``), each with a BSDF (inline, named at the top
  level, or a ``ref`` to a named one) and optionally an ``area`` or
  ``directionalarea`` emitter of constant radiance on a mesh (a
  sphere's also in ``em_sphere``, cone-sampled by NEE);
- the BSDFs ``diffuse``, ``conductor``, ``roughconductor``, ``plastic``,
  ``roughplastic``, ``dielectric``, ``thindielectric``,
  ``roughdielectric``, ``null``, ``mask``, ``blendbsdf``, ``normalmap``
  and ``bumpmap`` (lowered to a normal map, as the JAX loader does),
  ``principled``, ``principledthin``, ``hair`` (``sigma_a``, or the
  melanin concentrations mapped to it), ``measured`` (an RGB ``.bsdf``
  tensor file or its ``tables``, isotropic or anisotropic, lowered to
  ``scene.measured_tables``) and the BSDFs a user registers with
  ``register_bsdf`` (``bsdfs.register_custom``), and ``twosided`` around
  any of them; the rows, slot flags and adapter depth are the JAX
  loader's;
- textures where the JAX loader reads them (``TEXTURED``): a diffuse
  ``reflectance``, a plastic's or roughplastic's ``diffuse_reflectance``
  and a principled's or principledthin's ``base_color`` from a
  ``bitmap`` (an image file or a ``data`` array), a ``checkerboard``, a
  ``volume`` (``constvolume``, a grid or a ``.vol`` file) or a
  ``mesh_attribute`` (vertex colors); a mask's ``opacity`` and a
  blendbsdf's ``weight`` from a bitmap or a checkerboard; a normalmap's
  or bumpmap's texture (read raw); with the textures' metadata and, for
  ``mipmap`` bitmaps, their mip levels;
- ``point``, ``spot``, ``directional`` and ``projector`` emitters (a
  projector's irradiance a color, a ``bitmap`` or a ``checkerboard``) and
  a ``constant``, ``envmap`` (an image file or a ``data`` array),
  ``sunsky`` or ``timed_sunsky`` environment (``emitters/sunsky.py``,
  baked into an envmap at load);
- the sensors ``perspective``, ``thinlens``, ``orthographic``,
  ``radiancemeter``, ``irradiancemeter``, ``distant`` and ``batch`` (of
  perspective, thinlens and orthographic sub-sensors), with an ``hdrfilm``
  and its crop window, the rfilters ``box``, ``tent``, ``gaussian``,
  ``mitchell``, ``catmullrom`` and ``lanczos`` (at their default
  parameters), and the samplers ``independent``, ``stratified``,
  ``multijitter``, ``ldsampler`` and ``orthogonal``;
- constant colors given as a number, an RGB triple, or an ``rgb``,
  ``uniform``, ``d65``, ``srgb`` or ``rawconstant`` spectrum, and colors
  given as a ``blackbody``, ``regular`` or ``irregular`` spectrum,
  projected to linear sRGB at load as the JAX loader's RGB variant does
  (``core/spectrum.py``; a key the JAX loader ignores is refused, and so
  is a sampled spectrum where a scalar is read);
- participating media: ``homogeneous`` and ``heterogeneous`` (a density
  grid given as an array, a ``gridvolume`` with ``data`` or a ``.vol``
  ``filename`` and its ``to_world``) with the phase functions
  ``isotropic``, ``hg``, ``rayleigh``, ``sggx``, ``tabphase`` and
  ``blendphase`` (of two non-blend phases), named at the top level and
  referenced by ``ref``, as a shape's ``interior``/``exterior`` (or
  ``interior_medium``/``exterior_medium``) and as a sensor's ``medium``;
  the rows, grids, phase tables and world->grid affines are the JAX
  loader's;
- the ``path``, ``prb``, ``volpath``, ``volpathmis``, ``prbvolpath``,
  ``direct``, ``aov``, ``depth``, ``moment`` and ``ptracer`` integrators
  (an ``aov``'s and a ``moment``'s nested integrator among them);
- scenes of at most 8192 faces keep the dense all-triangles test
  (``accel`` None, ``ops/intersect.py``); above that, the accel that
  ``MI3T_ACCEL`` names, as the JAX package reads it: ``auto`` (the
  default) gives ``xla`` on a CPU device and ``cells`` on the card;
  ``cells`` gives cellserve (``ops/cellserve.py``), ``serve``
  ``bvh_serve``, ``tiled`` ``bvh_tiled``, ``xla`` the stackless BVH
  (``ops/bvh_xla.py``), ``grid`` the DDA grid (``ops/grid.py``) and
  ``none`` the dense test over every face. A ``HybridAccel`` (the grid's
  closest hits, bvh_tiled's any-hit) is made by hand, as in JAX.

Any other plugin raises ``NotImplementedError`` naming it: among them the
``ellipsoids`` Gaussian primitives, the polarized BSDFs
(``pplastic``, ``polarizer``, ``retarder``, ``circular``,
``measured_polarized``), a spectral ``.bsdf``, the ``stokes``,
``volprim_rf_basic``, ``prb_projective`` and ``direct_projective``
integrators, a batch sensor's ``medium``, an rfilter's parameters
(which the JAX package ignores), a textured parameter outside
``TEXTURED`` and an image format that
``utils/image_io.py`` does not read. XML scene files lower to the same
dicts (``utils/xml.py``). The host-side table building is the JAX
package's, so the scene's arrays equal its leaves. The scene lives on
``device``: the card unless the caller asks for the CPU.
"""
from __future__ import annotations

import os

import numpy as np
import torch

from . import bsdfs as bsdfs_pkg
from . import emitters as em_pkg
from . import media as media_pkg
from . import phase as phase_pkg
from . import shapes as shapes_pkg
from . import sensors as sensors_pkg
from .core import spectral as spectral_mod
from .core import spectrum
from .core.distr2d import SlicedMarginal2D
from .core.transform import as_transform
from .emitters import envmap as env_mod
from .emitters import sunsky
from .integrators import config_from_dict as integrator_from_dict
from .integrators.path import PathConfig
from .ops import bvh_serve, bvh_tiled, bvh_xla, cellserve
from .ops import grid as grid_mod
from .ops import sdf as sdf_mod
from .bsdfs import rough_transmittance as rtrans
from .render import instancing
from .render import sampler as sampler_mod
from .render import texture as tex_mod
from .render.film import RFILTERS, FilmConfig
from .render.fresnel import CONDUCTOR_IOR
from .render.scene import TRI_CHUNK, TRI_PAD, Scene, reached_slots
from .render.texture_io import Texture, load_texture_spec
from .shapes import curves as curves_mod

ACCEL_MIN_FACES = 8192   # scenes above this many faces get an accel
INSTANCE_PAD = 128       # the instance table's row granularity
# the shape types a merge or a shapegroup may hold (ellipsoids: refused)
GROUP_MEMBER_TYPES = tuple(shapes_pkg.SHAPE_KEYS) + ("ellipsoids",)
# an ellipsoidsmesh's BSDF when it names none: its vertex colors
ELLIPSOID_BSDF = {"type": "diffuse", "reflectance": {
    "type": "mesh_attribute", "name": "vertex_color"}}
# MI3T_ACCEL -> the accel's build (None: the dense test over every face);
# "auto" is "xla" on a CPU device and "cells" on the card, as in JAX
ACCELS = {"cells": cellserve.build, "serve": bvh_serve.build,
          "tiled": bvh_tiled.build, "xla": bvh_xla.build,
          "grid": grid_mod.build, "none": None}

_FILM_KEYS = ("type", "width", "height", "rfilter", "pixel_format",
              "crop_width", "crop_height", "crop_offset_x", "crop_offset_y")
_SAMPLER_KEYS = ("type", "sample_count")
_SENSOR_KEYS = ("type", "to_world", "fov", "fov_axis", "near_clip",
                "far_clip", "film", "sampler", "aperture_radius",
                "focus_distance")
# constant spectra: their value (or scale) is the color
_CONSTANT_SPECTRA = ("uniform", "d65", "srgb", "rawconstant")
# sampled spectra, projected to RGB at load (core/spectrum.py), and the
# keys each may have
SAMPLED_SPECTRA = {
    "blackbody": ("type", "temperature", "scale"),
    "regular": ("type", "value", "values", "lambda_min", "lambda_max",
                "wavelengths"),
    "irregular": ("type", "value", "wavelengths", "values")}
# every BSDF name the JAX loader knows; those outside BSDF_KEYS (or a
# spectral parameter, or a textured one outside TEXTURED) raise
# NotImplementedError
BSDF_NAMES = ("diffuse", "conductor", "roughconductor", "dielectric",
              "measured", "thindielectric", "roughdielectric", "plastic",
              "roughplastic", "pplastic", "twosided", "null", "mask",
              "blendbsdf", "normalmap", "bumpmap", "principled",
              "principledthin", "hair", "polarizer", "retarder", "circular",
              "measured_polarized")
_IOR_KEYS = ("int_ior", "ext_ior")
_ROUGH_KEYS = ("alpha", "alpha_u", "alpha_v", "distribution")
BSDF_KEYS = {
    "diffuse": ("reflectance",),
    "conductor": ("material", "eta", "k", "specular_reflectance"),
    "roughconductor": ("material", "eta", "k", "specular_reflectance")
    + _ROUGH_KEYS,
    "plastic": _IOR_KEYS + ("diffuse_reflectance", "nonlinear",
                            "specular_reflectance"),
    "roughplastic": _IOR_KEYS + ("diffuse_reflectance", "nonlinear",
                                 "specular_reflectance", "alpha",
                                 "distribution"),
    "dielectric": _IOR_KEYS + ("specular_reflectance",
                               "specular_transmittance", "dispersion"),
    "thindielectric": _IOR_KEYS + ("specular_reflectance",
                                   "specular_transmittance", "dispersion"),
    "roughdielectric": _IOR_KEYS + ("specular_reflectance",
                                    "specular_transmittance") + _ROUGH_KEYS,
    "null": ("transmittance",),
    "mask": ("opacity",),
    "blendbsdf": ("weight",),
    "normalmap": ("normalmap", "bumpmap"),
    "bumpmap": ("normalmap", "bumpmap"),
    "twosided": (),
    "principled": ("base_color", "metallic", "roughness", "anisotropic",
                   "spec_tint", "sheen", "sheen_tint", "clearcoat",
                   "clearcoat_gloss", "specular", "flatness"),
    "principledthin": ("base_color", "spec_trans", "roughness",
                       "anisotropic", "eta", "spec_tint", "sheen",
                       "sheen_tint", "diff_trans", "flatness"),
    "hair": ("longitudinal_roughness", "azimuthal_roughness", "scale_tilt",
             "sigma_a", "eumelanin", "pheomelanin") + _IOR_KEYS,
    "measured": ("filename", "tables"),
}
# principled's and principledthin's scalars: row column -> (parameter,
# default)
PRINCIPLED_SCALARS = {
    "principled": {4: ("metallic", 0.0), 5: ("roughness", 0.5),
                   6: ("anisotropic", 0.0), 8: ("spec_tint", 0.0),
                   9: ("sheen", 0.0), 10: ("sheen_tint", 0.0),
                   11: ("clearcoat", 0.0), 12: ("clearcoat_gloss", 0.0),
                   13: ("specular", 0.5), 14: ("flatness", 0.0)},
    "principledthin": {4: ("spec_trans", 0.0), 5: ("roughness", 0.5),
                       6: ("anisotropic", 0.0), 7: ("eta", 1.5),
                       8: ("spec_tint", 0.0), 9: ("sheen", 0.0),
                       10: ("sheen_tint", 0.0), 11: ("diff_trans", 0.0),
                       12: ("flatness", 0.0)},
}
# melanin absorption per unit concentration (hair.cpp pigmentation)
EUMELANIN_SIGMA_A = (0.419, 0.697, 1.37)
PHEOMELANIN_SIGMA_A = (0.187, 0.4, 1.05)
# (BSDF type, parameter) -> the texture types the JAX loader reads there
_IMAGE_TEXTURES = ("bitmap", "checkerboard")
_COLOR_TEXTURES = _IMAGE_TEXTURES + ("volume", "mesh_attribute")
TEXTURED = {
    ("diffuse", "reflectance"): _COLOR_TEXTURES,
    ("plastic", "diffuse_reflectance"): _COLOR_TEXTURES,
    ("roughplastic", "diffuse_reflectance"): _COLOR_TEXTURES,
    ("principled", "base_color"): _COLOR_TEXTURES,
    ("principledthin", "base_color"): _COLOR_TEXTURES,
    ("mask", "opacity"): _IMAGE_TEXTURES,
    ("blendbsdf", "weight"): _IMAGE_TEXTURES,
}
_TEXTURE_TYPES = _COLOR_TEXTURES + ("gridvolume", "constvolume")
_VOLUME_KEYS = {"gridvolume": ("type", "filename", "grid", "data",
                               "to_world"),
                "constvolume": ("type", "value", "to_world")}
MEDIUM_KEYS = {
    "homogeneous": ("type", "sigma_t", "albedo", "scale", "phase",
                    "sample_emitters"),
    "heterogeneous": ("type", "sigma_t", "albedo", "scale", "phase",
                      "sample_emitters", "density", "color"),
}
PHASE_KEYS = {"isotropic": ("type",), "hg": ("type", "g"),
              "rayleigh": ("type",), "sggx": ("type", "S", "s"),
              "tabphase": ("type", "values"),
              "blendphase": ("type", "weight")}
INTEGRATORS = ("path", "prb", "volpath", "volpathmis", "prbvolpath",
               "direct", "aov", "depth", "moment", "ptracer")
_SUNSKY_KEYS = ("type", "turbidity", "sun_scale", "sky_scale", "scale")
ENV_KEYS = {"constant": ("type", "radiance", "scale"),
            "envmap": ("type", "filename", "data", "raw", "scale"),
            "sunsky": _SUNSKY_KEYS + ("sun_direction",),
            "timed_sunsky": _SUNSKY_KEYS + ("year", "month", "day", "hour",
                                            "minute", "second", "latitude",
                                            "longitude", "timezone")}
DELTA_KEYS = {
    "point": ("type", "position", "intensity", "to_world"),
    "spot": ("type", "position", "direction", "intensity", "to_world",
             "cutoff_angle", "beam_width"),
    "directional": ("type", "direction", "irradiance", "to_world"),
    "projector": ("type", "irradiance", "scale", "fov", "to_world"),
}


def resolve_device(device=None) -> torch.device:
    """The scene's device: ``"cuda"`` unless the caller passes another.
    Never falls back to the CPU on its own."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "mitsuba3_tpu_torch renders on a CUDA device and none is "
            "available; pass device='cpu' to render on the CPU")
    return dev


def _not_ported(what: str):
    return NotImplementedError(f"{what} is not ported to mitsuba3_tpu_torch")


def _check_keys(spec: dict, allowed, what: str):
    extra = sorted(set(spec) - set(allowed))
    if extra:
        raise _not_ported(f"{what} properties {extra}")


def _spectrum_value(spec: dict, what: str):
    """The value of an ``rgb`` or constant spectrum dict."""
    if spec.get("type") == "rgb":
        return spec["value"]
    if spec.get("type") in _CONSTANT_SPECTRA:
        return spec.get("value", spec.get("scale", 1.0))
    raise _not_ported(f"{what} type {spec.get('type')!r}")


def _sampled_rgb(spec: dict) -> np.ndarray:
    """A ``blackbody``, ``regular`` or ``irregular`` spectrum projected to
    linear sRGB on the host, in every form the JAX loader reads: a
    blackbody's ``temperature`` and ``scale``; a regular spectrum's
    ``values`` (or a list ``value``) spread over ``lambda_min`` ..
    ``lambda_max``; ``value`` pairs, a ``"wavelength:value, ..."`` string
    or ``wavelengths`` with ``values``. Keys the JAX loader ignores are
    refused."""
    stype = spec["type"]
    _check_keys(spec, SAMPLED_SPECTRA[stype], f"{stype} spectrum")
    if stype == "blackbody":
        return spectrum.blackbody_rgb(float(spec.get(
            "temperature", 5000.0))) * float(spec.get("scale", 1.0))
    return spectrum.spd_to_rgb(*_sampled_points(spec))


def _sampled_points(spec: dict):
    """(wavelengths, values) of a ``regular`` or ``irregular`` spectrum."""
    val = spec.get("value")
    if val is None and "wavelengths" in spec:
        val = list(zip(np.asarray(spec["wavelengths"], np.float64).tolist(),
                       np.asarray(spec["values"], np.float64).tolist()))
    if isinstance(val, str):
        pairs = [p.split(":") for p in val.split(",")]
        wl = [float(a) for a, _ in pairs]
        sp = [float(b) for _, b in pairs]
    elif spec["type"] == "regular":
        sp = np.asarray(spec["values"] if "values" in spec else val,
                        np.float64)
        wl = np.linspace(float(spec.get("lambda_min", 360.0)),
                         float(spec.get("lambda_max", 830.0)), sp.shape[0])
    else:
        wl, sp = zip(*val)
    return wl, sp


# the spectra that keep their SPD in the spectral variant (a reflectance,
# a specfilm's response function; an emitter's but uniform)
SPD_SPECTRA = ("regular", "irregular", "blackbody", "d65", "uniform")


def _spd_row(spec):
    """A sampled spectrum's [SPD_N] SPD on the spectral grid, as the JAX
    loader's ``_spd_row`` makes it (a regular or irregular spectrum's
    ``scale`` applies here, not to its RGB projection), or None for a
    color that is not one."""
    if not isinstance(spec, dict):
        return None
    stype = spec.get("type")
    scale = float(spec.get("scale", 1.0))
    if stype in ("regular", "irregular"):
        _check_keys(spec, SAMPLED_SPECTRA[stype] + ("scale",),
                    f"{stype} spectrum")
        wl, vals = _sampled_points(spec)
        return spectral_mod.resample_spd(np.asarray(wl),
                                         np.asarray(vals, np.float64) * scale)
    if stype == "blackbody":
        return spectral_mod.blackbody_spd(
            float(spec.get("temperature", 5000.0))) * np.float32(scale)
    if stype == "d65":
        return spectral_mod.d65_spd() * np.float32(scale)
    return None


def _spd_or_uniform(spec) -> np.ndarray:
    """_spd_row, or a ``uniform`` spectrum's value on every grid point."""
    if spec.get("type") == "uniform":
        return np.full(spectral_mod.SPD_N, float(spec.get("value", 1.0)),
                       np.float32)
    return np.asarray(_spd_row(spec), np.float32)


def _projected(spec):
    """A spectrum as its RGB projection reads it in the spectral variant:
    a regular or irregular spectrum's ``scale`` belongs to its SPD."""
    if isinstance(spec, dict) and spec.get("type") in ("regular",
                                                       "irregular"):
        return {k: v for k, v in spec.items() if k != "scale"}
    return spec


def _rgb(spec, default=(0.5, 0.5, 0.5), what: str = "spectrum"):
    """A constant color: number | [r, g, b] | an ``rgb`` or constant
    spectrum dict ({'type': 'uniform', 'value': ...} and the like) | a
    sampled spectrum projected to RGB (``_sampled_rgb``)."""
    if spec is None:
        return np.asarray(default, np.float32)
    if isinstance(spec, dict):
        spec = (_sampled_rgb(spec) if spec.get("type") in SAMPLED_SPECTRA
                else _spectrum_value(spec, what))
    v = np.asarray(spec, np.float32).reshape(-1)
    if v.size == 1:
        v = np.repeat(v, 3)
    return v


def _is_bsdf(v) -> bool:
    return isinstance(v, dict) and (
        v.get("type") in BSDF_NAMES
        or bsdfs_pkg.custom_type(v.get("type")) is not None)


def _scalar(spec, default: float, what: str) -> float:
    """A constant scalar: number | an ``rgb`` or constant spectrum dict of
    one value."""
    if spec is None:
        return float(default)
    if isinstance(spec, dict):
        spec = _spectrum_value(spec, f"{what} given as a spectrum")
    return float(spec)


def _volume_texture(cspec: dict) -> Texture:
    """The ``volume`` texture adapter (src/textures/volume.cpp): a nested
    gridvolume or constvolume, sampled at the world hit point through its
    world->local transform (the metadata's 3x4 matrix)."""
    _check_keys({k: v for k, v in cspec.items() if k != "volume"
                 and not (isinstance(v, dict)
                          and v.get("type") in _VOLUME_KEYS)},
                ("type",), "volume texture")
    vol = cspec.get("volume") or next(
        (v for v in cspec.values()
         if isinstance(v, dict) and v.get("type") in _VOLUME_KEYS), None)
    if vol is None or vol.get("type") not in _VOLUME_KEYS:
        raise _not_ported(f"volume texture of "
                          f"{None if vol is None else vol.get('type')!r}")
    _check_keys(vol, _VOLUME_KEYS[vol["type"]], vol["type"])
    if vol["type"] == "constvolume":
        g = np.tile(_rgb(vol.get("value"), (0.75,) * 3),
                    (2, 2, 2, 1)).astype(np.float32)
    elif "filename" in vol:
        from .utils.vol_io import read_vol
        g = np.asarray(read_vol(vol["filename"])[0], np.float32)
    else:
        g = np.asarray(vol.get("grid", vol.get("data")), np.float32)
    if g.ndim == 3:
        g = np.repeat(g[..., None], 3, axis=-1)
    tw = vol.get("to_world")
    mtx = np.eye(4) if tw is None else as_transform(tw).matrix
    w2l = tuple(float(v) for v in np.linalg.inv(mtx)[:3, :4].reshape(-1))
    return Texture(np.ascontiguousarray(g, np.float32),
                   ("3d", "trilinear", False, w2l))


def _custom_row(spec: dict, tid: int, lower):
    """The row of a user's registered BSDF: `lower(spec)`'s values, or the
    spec's ``reflectance`` in [0:3]."""
    params = np.zeros(bsdfs_pkg.N_PARAMS, np.float32)
    if lower is None:
        params[0:3] = _rgb(spec.get("reflectance",
                                    {"type": "rgb", "value": 0.5}),
                           what=f"{spec['type']}'s reflectance")
        return tid, params
    row = np.asarray(lower(spec), np.float32).ravel()
    if row.size > bsdfs_pkg.N_PARAMS:
        raise ValueError(f"custom BSDF {spec['type']!r}: row has {row.size} "
                         f"params (max {bsdfs_pkg.N_PARAMS})")
    params[:row.size] = row
    return tid, params


def measured_tables(spec: dict, dev) -> dict:
    """A measured BSDF's tables on `dev` (measured.cpp:86-238), as the JAX
    loader's ``_measured_tables`` makes them: from an RGB ``.bsdf`` file
    (``filename``) or a dict of its fields (``tables``). The conditioned
    warps' slice index is p * T + j (the file's [phi_i, theta_i, H, W]
    layout); ndf and sigma are one unconditioned [1, H, W] grid each."""
    if "filename" in spec:
        from .utils import tensor_io
        fields = tensor_io.read(spec["filename"])
    else:
        fields = spec["tables"]
    if "wavelengths" in fields:
        raise _not_ported("a spectral measured BSDF (a .bsdf file with "
                          "wavelengths)")
    phi_i = np.asarray(fields["phi_i"], np.float32).reshape(-1)
    theta_i = np.asarray(fields["theta_i"], np.float32).reshape(-1)
    t, pp = theta_i.shape[0], phi_i.shape[0]
    # anisotropic tables may cover only 2 pi / reduction of phi_i
    # (measured.cpp:165-172)
    red = 1 if pp <= 2 else int(round(
        (2.0 * np.pi) / max(float(phi_i[-1] - phi_i[0]), 1e-6)))
    vndf = np.asarray(fields["vndf"], np.float32)
    lum = np.asarray(fields["luminance"], np.float32)
    spectra = np.asarray(fields["rgb" if "rgb" in fields else "spectra"],
                         np.float32)
    ndf = np.asarray(fields["ndf"], np.float32)
    sigma = np.asarray(fields["sigma"], np.float32)

    def t_(a):
        return torch.as_tensor(np.ascontiguousarray(a), device=dev)

    return {
        "theta_i": t_(theta_i), "phi_i": t_(phi_i),
        "reduction": torch.tensor(float(red), dtype=torch.float32,
                                  device=dev),
        "lum": SlicedMarginal2D.from_data(
            lum.reshape(pp * t, *lum.shape[-2:]), dev),
        "vndf": SlicedMarginal2D.from_data(
            vndf.reshape(pp * t, *vndf.shape[-2:]), dev),
        "spectra": t_(spectra.reshape(pp * t * 3, *spectra.shape[-2:])),
        "ndf": t_(ndf[None] if ndf.ndim == 2 else ndf),
        "sigma": t_(sigma[None] if sigma.ndim == 2 else sigma)}


def _bsdf_row(spec: dict, add_bsdf, textures: list, measured: list,
              spds=None):
    """Lower a BSDF spec -> (type id, params row [N_PARAMS]), as the JAX
    loader does. `add_bsdf` registers a nested BSDF (mask, blendbsdf,
    normalmap) and returns its slot; nested slots come before their
    adapter's. A texture a parameter names is appended to `textures` and
    its row slot holds its index + 1 (-1 for vertex colors); a measured
    BSDF's spec is appended to `measured` and its row holds its index. In
    the spectral variant (`spds` a list) a reflectance given as a sampled
    spectrum keeps its SPD: appended to `spds`, its texture slot -(k + 2)
    names row k, and its RGB slots hold the projection."""
    btype = spec.get("type")
    custom = bsdfs_pkg.custom_type(btype)
    if custom is not None:
        return _custom_row(spec, *custom)
    if btype not in BSDF_KEYS:
        raise _not_ported(f"BSDF type {btype!r}")
    nests = [v for v in spec.values() if _is_bsdf(v)]
    _check_keys({k: v for k, v in spec.items() if not _is_bsdf(v)},
                ("type",) + BSDF_KEYS[btype], btype)
    for key, v in spec.items():
        if (isinstance(v, dict) and v.get("type") in _TEXTURE_TYPES
                and btype not in ("normalmap", "bumpmap")
                and v["type"] not in TEXTURED.get((btype, key), ())):
            raise _not_ported(f"a {v['type']} texture as {btype}'s {key}")
    params = np.zeros(bsdfs_pkg.N_PARAMS, np.float32)

    def color(key, default):
        return _rgb(spec.get(key), default, f"{btype}'s {key}")

    def texture(cspec, tex_slot):
        """Register the texture `cspec` in the row's slot `tex_slot`."""
        if cspec["type"] == "mesh_attribute":
            # the interpolated vertex color (mesh_attribute.cpp): si.vcolor,
            # selected by texture id -1
            _check_keys(cspec, ("type", "name"), "mesh_attribute")
            if cspec.get("name", "vertex_color") != "vertex_color":
                raise _not_ported(f"mesh_attribute {cspec['name']!r} (the "
                                  f"port carries vertex_color only)")
            params[tex_slot] = -1
            return
        textures.append(_volume_texture(cspec) if cspec["type"] == "volume"
                        else load_texture_spec(cspec))
        params[tex_slot] = len(textures)

    def color_or_texture(key, default, rgb_slot, tex_slot):
        cspec = spec.get(key)
        if isinstance(cspec, dict) and cspec.get("type") in _TEXTURE_TYPES:
            texture(cspec, tex_slot)
            params[rgb_slot:rgb_slot + 3] = 0.5
        elif (spds is not None and isinstance(cspec, dict)
              and cspec.get("type") in SPD_SPECTRA):
            spds.append(_spd_or_uniform(cspec))
            params[tex_slot] = -(len(spds) + 1)
            params[rgb_slot:rgb_slot + 3] = _rgb(_projected(cspec), default,
                                                 f"{btype}'s {key}")
        else:
            params[rgb_slot:rgb_slot + 3] = color(key, default)

    def scalar_or_texture(key, what):
        v = spec.get(key)
        if isinstance(v, dict) and v.get("type") in _TEXTURE_TYPES:
            texture(v, 1)
            params[0] = 0.5
        else:
            params[0] = _scalar(v, 0.5, what)

    if btype == "twosided":
        if len(nests) != 1:
            raise ValueError("twosided needs exactly one nested BSDF")
        tid, params = _bsdf_row(nests[0], add_bsdf, textures, measured,
                                spds)
        params[16] = 1.0
        return tid, params
    if btype == "mask":
        if len(nests) != 1:
            raise ValueError("mask needs exactly one nested BSDF")
        scalar_or_texture("opacity", "mask opacity")
        params[15] = add_bsdf(nests[0])
        return bsdfs_pkg.MASK, params
    if btype == "blendbsdf":
        if len(nests) != 2:
            raise ValueError("blendbsdf needs exactly two nested BSDFs")
        scalar_or_texture("weight", "blendbsdf weight")
        params[14] = add_bsdf(nests[0])
        params[15] = add_bsdf(nests[1])
        return bsdfs_pkg.BLEND, params
    if btype in ("normalmap", "bumpmap"):
        # a bumpmap is lowered to a normal map: its texture, if any, is
        # read as tangent-space normals; without one the normal is flat
        nm = spec.get("normalmap") or spec.get("bumpmap")
        if isinstance(nm, dict):
            textures.append(load_texture_spec({**nm, "raw": True}))
            params[1] = len(textures)
        elif nm is not None:
            raise _not_ported(f"a {btype} given as {nm!r}")
        if len(nests) > 1:
            raise ValueError(f"{btype} takes one nested BSDF")
        params[15] = add_bsdf(nests[0] if nests else {"type": "diffuse"})
        return bsdfs_pkg.NORMALMAP, params
    if nests:
        raise _not_ported(f"{btype} with a nested BSDF")
    if btype == "diffuse":
        color_or_texture("reflectance", (0.5, 0.5, 0.5), 0, 3)
        return bsdfs_pkg.DIFFUSE, params
    if btype in PRINCIPLED_SCALARS:
        color_or_texture("base_color", (0.5, 0.5, 0.5), 0, 3)
        for col, (key, default) in PRINCIPLED_SCALARS[btype].items():
            params[col] = _scalar(spec.get(key), default, f"{btype}'s {key}")
        return (bsdfs_pkg.PRINCIPLED if btype == "principled"
                else bsdfs_pkg.PRINCIPLED_THIN), params
    if btype == "hair":
        for col, key, default in ((0, "longitudinal_roughness", 0.3),
                                  (1, "azimuthal_roughness", 0.3),
                                  (2, "scale_tilt", 2.0)):
            params[col] = _scalar(spec.get(key), default, f"hair's {key}")
        params[3] = (float(spec.get("int_ior", 1.55))        # amber
                     / float(spec.get("ext_ior", 1.000277)))
        if "sigma_a" in spec:
            params[4:7] = color("sigma_a", (0.2, 0.3, 0.5))
        else:
            # melanin concentrations -> absorption (hair.cpp)
            params[4:7] = (float(spec.get("eumelanin", 1.3))
                           * np.array(EUMELANIN_SIGMA_A)
                           + float(spec.get("pheomelanin", 0.2))
                           * np.array(PHEOMELANIN_SIGMA_A))
        return bsdfs_pkg.HAIR, params
    if btype == "measured":
        params[0] = len(measured)
        measured.append(spec)
        return bsdfs_pkg.MEASURED, params
    if btype in ("conductor", "roughconductor"):
        eta_d, k_d = CONDUCTOR_IOR.get(spec.get("material", "none"),
                                       CONDUCTOR_IOR["none"])
        params[0:3] = color("eta", eta_d)
        params[3:6] = color("k", k_d)
        params[8:11] = color("specular_reflectance", (1, 1, 1))
        if btype == "conductor":
            return bsdfs_pkg.CONDUCTOR, params
        alpha = float(spec.get("alpha", 0.1))
        params[6] = float(spec.get("alpha_u", alpha))
        params[7] = float(spec.get("alpha_v", alpha))
        params[11] = 0.0 if spec.get("distribution", "ggx") == "ggx" else 1.0
        return bsdfs_pkg.ROUGH_CONDUCTOR, params
    if btype == "null":
        params[0:3] = color("transmittance", (1.0, 1.0, 1.0))
        return bsdfs_pkg.NULL, params
    if btype in ("dielectric", "thindielectric"):
        int_ior = float(spec.get("int_ior", 1.5046))  # bk7 (ior.h)
        ext_ior = float(spec.get("ext_ior", 1.000277))  # air
        params[0] = int_ior / ext_ior
        params[1:4] = color("specular_reflectance", (1, 1, 1))
        params[4:7] = color("specular_transmittance", (1, 1, 1))
        # the Cauchy dispersion coefficient [um^2] (spectral variant)
        params[8] = float(spec.get("dispersion", 0.0))
        return (bsdfs_pkg.DIELECTRIC if btype == "dielectric"
                else bsdfs_pkg.THIN_DIELECTRIC), params
    if btype == "roughdielectric":
        int_ior = float(spec.get("int_ior", 1.5046))
        ext_ior = float(spec.get("ext_ior", 1.000277))
        params[0] = int_ior / ext_ior
        alpha = float(spec.get("alpha", 0.1))
        params[1] = float(spec.get("alpha_u", alpha))
        params[2] = float(spec.get("alpha_v", alpha))
        params[3] = (0.0 if spec.get("distribution", "beckmann") == "ggx"
                     else 1.0)
        params[4:7] = color("specular_reflectance", (1, 1, 1))
        params[7:10] = color("specular_transmittance", (1, 1, 1))
        return bsdfs_pkg.ROUGH_DIELECTRIC, params
    # plastic, roughplastic
    int_ior = float(spec.get("int_ior", 1.49))  # polypropylene (ior.h)
    ext_ior = float(spec.get("ext_ior", 1.000277))
    color_or_texture("diffuse_reflectance", (0.5, 0.5, 0.5), 0, 3)
    params[4] = int_ior / ext_ior
    params[5] = 1.0 if spec.get("nonlinear", False) else 0.0
    params[8:11] = color("specular_reflectance", (1, 1, 1))
    # specular sampling weight = s_mean / (d_mean + s_mean)
    d_mean = float(params[0:3].mean()) if params[3] == 0 else 0.5
    s_mean = float(params[8:11].mean())
    params[6] = s_mean / max(d_mean + s_mean, 1e-6)
    if btype == "plastic":
        return bsdfs_pkg.PLASTIC, params
    params[11] = float(spec.get("alpha", 0.1))
    params[12] = 0.0 if spec.get("distribution", "beckmann") == "ggx" else 1.0
    # the coat's rough transmittance, fitted at load into the row
    coeffs, fdr = rtrans.fit(float(params[4]), float(params[11]),
                             beckmann=params[12] > 0.5)
    params[17:17 + rtrans.N_COEF] = coeffs
    params[25] = fdr
    return bsdfs_pkg.ROUGH_PLASTIC, params


def _fill_phase(phase_spec: dict, row: np.ndarray, tables: list) -> int:
    """Fill the phase slots of a medium row (media/__init__.py's layout) as
    the JAX loader does; returns the phase type id."""
    pname = phase_spec.get("type", "isotropic")
    if pname not in PHASE_KEYS:
        raise _not_ported(f"phase function {pname!r}")
    nested = [v for v in phase_spec.values()
              if isinstance(v, dict) and v.get("type") in PHASE_KEYS]
    _check_keys({k: v for k, v in phase_spec.items()
                 if not any(v is x for x in nested)}, PHASE_KEYS[pname],
                f"{pname} phase")
    ptype = phase_pkg.NAMES[pname]
    row[7] = float(phase_spec.get("g", 0.0))
    if pname == "sggx":
        s = phase_spec.get("S", phase_spec.get("s"))
        if isinstance(s, dict):  # constvolume-style {'value': [6 floats]}
            s = s.get("value")
        s = np.asarray(s if s is not None else [1, 1, 1, 0, 0, 0],
                       np.float32).reshape(-1)
        row[12:18] = s[:6]
    elif pname == "tabphase":
        vals = phase_spec.get("values")
        if isinstance(vals, str):
            vals = [float(v) for v in vals.replace(",", " ").split()]
        tables.append(np.asarray(vals, np.float32))
        row[18] = len(tables)
    elif pname == "blendphase":
        row[19] = float(phase_spec.get("weight", 0.5))
        if len(nested) != 2:
            raise ValueError("blendphase needs exactly two nested phases")
        if any(nv["type"] == "blendphase" for nv in nested):
            raise ValueError("nested blendphase unsupported")
        # the nested phases share the row: copy the slots they use
        for col, nv in ((20, nested[0]), (21, nested[1])):
            sub = np.zeros_like(row)
            row[col] = _fill_phase(nv, sub, tables)
            row[7] = sub[7] if sub[7] else row[7]
            row[12:19] = np.where(sub[12:19] != 0, sub[12:19], row[12:19])
    return ptype


def _medium_row(spec: dict, grids: list, tables: list):
    """Lower a medium spec -> (medium type, phase type, row [N_MPARAMS],
    world->grid [3, 4]), as the JAX loader does (homogeneous.cpp's
    sigma_t, albedo and scale; heterogeneous.cpp's density grid with the
    majorant scale * max density * max sigma_t). A grid is appended to
    `grids`, a tabulated phase's values to `tables`."""
    mtype = spec["type"]
    _check_keys(spec, MEDIUM_KEYS[mtype], f"{mtype} medium")
    row = np.zeros(media_pkg.N_MPARAMS, np.float32)
    row[10] = 1.0 if spec.get("sample_emitters", True) else 0.0
    row[6] = float(spec.get("scale", 1.0))
    ptype = _fill_phase(spec.get("phase", {"type": "isotropic"}), row, tables)
    row[3:6] = _rgb(spec.get("albedo"), (0.75, 0.75, 0.75))
    to_grid = np.concatenate([np.eye(3, dtype=np.float32),
                              np.zeros((3, 1), np.float32)], axis=1)
    if mtype == "homogeneous":
        row[0:3] = _rgb(spec.get("sigma_t"), (1.0, 1.0, 1.0))
        return media_pkg.HOMOGENEOUS, ptype, row, to_grid
    # heterogeneous: a [D, H, W] density grid (an array, or a gridvolume
    # with data or a .vol file and its to_world) modulating the RGB
    # extinction color (color, or sigma_t beside a density)
    vol = spec.get("density", spec.get("sigma_t"))
    grid = None
    if isinstance(vol, dict) and vol.get("type") == "gridvolume":
        _check_keys(vol, ("type", "filename", "data", "to_world"),
                    "medium gridvolume")
        mtx = np.eye(4)
        if "filename" in vol:
            from .utils.vol_io import read_vol
            grid, bb_lo, bb_hi = read_vol(vol["filename"])
            if grid.ndim == 4:
                grid = grid.mean(axis=-1)
            ext = np.maximum(bb_hi - bb_lo, 1e-9)
            mtx = np.diag([ext[0], ext[1], ext[2], 1.0])
            mtx[:3, 3] = bb_lo
        else:
            grid = np.asarray(vol.get("data"), np.float32)
        tw = vol.get("to_world")
        if tw is not None:
            mtx = np.asarray(as_transform(tw).matrix, np.float64) @ mtx
        to_grid = np.linalg.inv(mtx).astype(np.float32)[:3, :4]
    elif isinstance(vol, dict) and vol.get("type") not in ("rgb",) + \
            _CONSTANT_SPECTRA:
        raise _not_ported(f"a {vol.get('type')!r} medium density")
    elif vol is not None and not isinstance(vol, dict):
        grid = np.asarray(vol, np.float32)
    cspec = spec.get("color")
    if cspec is None and "density" in spec and \
            isinstance(spec.get("sigma_t"), dict):
        cspec = spec.get("sigma_t")
    color = _rgb(cspec, (1.0, 1.0, 1.0))
    row[0:3] = color
    if grid is not None:
        if grid.ndim != 3:
            raise ValueError("density grid must be [D, H, W]")
        grids.append(grid)
        row[9] = len(grids)
        row[8] = row[6] * float(grid.max()) * float(color.max())
    else:
        row[8] = row[6] * float(color.max())
    return media_pkg.HETEROGENEOUS, ptype, row, to_grid


def _slot_flags(bsdf_types, bsdf_rows):
    """Resolved BSDFFlags per slot: an adapter takes the union of its
    nested chains (a mask adds Null), and the two-sided flag ([16]) adds
    both sides."""
    def fl(slot, seen):
        t = bsdf_types[slot]
        base = bsdfs_pkg.type_flags(t)
        if t in bsdfs_pkg.ADAPTER_TYPES and slot not in seen:
            seen = seen | {slot}
            nested = 0
            for k in bsdfs_pkg.nested_slots(t, bsdf_rows[slot]):
                if 0 <= k < len(bsdf_types):
                    nested |= fl(k, seen)
            base = nested | (bsdfs_pkg.NULL_FLAG
                             if t == bsdfs_pkg.MASK else 0)
        if float(bsdf_rows[slot][16]) > 0.5:
            base |= bsdfs_pkg.FRONT_SIDE | bsdfs_pkg.BACK_SIDE
        return base
    return tuple(fl(i, frozenset()) for i in range(len(bsdf_types)))


def _adapter_chain_depth(bsdf_types, bsdf_rows) -> int:
    """The longest adapter chain in the scene (at least 1): the static
    unroll bound of ``bsdfs.dispatch_nested``."""
    def depth(slot, seen):
        t = bsdf_types[slot]
        if t not in bsdfs_pkg.ADAPTER_TYPES or slot in seen:
            return 0
        seen = seen | {slot}
        return 1 + max(depth(k, seen) for k in bsdfs_pkg.nested_slots(
            t, bsdf_rows[slot]) if 0 <= k < len(bsdf_types))
    return max([depth(i, frozenset()) for i in range(len(bsdf_types))],
               default=1) or 1


def _film_crop_fields(film_spec: dict) -> dict:
    """hdrfilm's crop window (film.h set_crop_window): the rendered raster
    is the crop; the sensor maps the full film plane. FilmConfig kwargs
    for width/height (the crop's size), the full size and the offset."""
    fw = int(film_spec.get("width", 256))
    fh = int(film_spec.get("height", 256))
    cw = int(film_spec.get("crop_width", fw))
    ch = int(film_spec.get("crop_height", fh))
    ox = int(film_spec.get("crop_offset_x", 0))
    oy = int(film_spec.get("crop_offset_y", 0))
    if not (0 < cw <= fw and 0 < ch <= fh
            and 0 <= ox <= fw - cw and 0 <= oy <= fh - ch):
        raise ValueError(
            f"invalid crop window {cw}x{ch}+{ox}+{oy} on {fw}x{fh} film")
    return dict(width=cw, height=ch, full_width=fw, full_height=fh,
                crop_ox=ox, crop_oy=oy)


def _film_config(film_spec: dict, batch: bool = False) -> FilmConfig:
    """The film of a sensor: an hdrfilm, or a specfilm whose nested
    spectra are its channels' response functions (``srfs``, read by the
    spectral variant; a batch sensor's film has none, as in JAX)."""
    ftype = film_spec.get("type", "hdrfilm")
    if ftype not in ("hdrfilm", "specfilm"):
        raise _not_ported(f"film type {ftype!r}")
    srf_specs = [v for v in film_spec.values() if ftype == "specfilm"
                 and isinstance(v, dict) and v.get("type") in SPD_SPECTRA]
    _check_keys({k: v for k, v in film_spec.items()
                 if not any(v is x for x in srf_specs)}, _FILM_KEYS, "film")
    if film_spec.get("pixel_format", "rgb") != "rgb":
        raise _not_ported(f"pixel_format {film_spec['pixel_format']!r}")
    rf = film_spec.get("rfilter") or {}
    rtype = rf.get("type", "gaussian")
    if rtype not in RFILTERS:
        raise _not_ported(f"rfilter {rtype!r}")
    if set(rf) - {"type"}:
        raise _not_ported(f"rfilter parameters {sorted(set(rf) - {'type'})}")
    srfs = () if batch else tuple(
        tuple(float(x) for x in _spd_or_uniform(v)) for v in srf_specs)
    return FilmConfig(rfilter=rtype, srfs=srfs, **_film_crop_fields(film_spec))


def _sampler_config(sampler_spec: dict):
    """(spp, sampler type) of a sampler spec."""
    _check_keys(sampler_spec, _SAMPLER_KEYS, "sampler")
    stype = sampler_spec.get("type", "independent")
    if stype not in sampler_mod.TYPES:
        raise _not_ported(f"sampler type {stype!r}")
    return int(sampler_spec.get("sample_count", 64)), stype


def _sensor(spec: dict, dev):
    """(film, spp, sampler type, (SensorData or a batch's tuple of them,
    SensorConfig)) of a sensor spec."""
    stype = spec["type"]
    if stype == "batch":
        subs = sensors_pkg.batch_subs(spec)
        _check_keys({k: v for k, v in spec.items()
                     if not any(v is s for s in subs)},
                    ("type", "film", "sampler"), "batch sensor")
        for sub in subs:
            _check_keys(sub, _SENSOR_KEYS, f"{sub['type']} sensor in a batch")
    else:
        _check_keys(spec, _SENSOR_KEYS + ("medium",), f"{stype} sensor")
    film = _film_config(spec.get("film", {}) or {}, batch=stype == "batch")
    spp, sampler_type = _sampler_config(spec.get("sampler", {}) or {})
    build = (sensors_pkg.build_batch if stype == "batch"
             else sensors_pkg.build_perspective)
    return (film, spp, sampler_type,
            build(spec, film.full_width, film.full_height, dev))


def _projector_row(espec: dict, textures: list):
    """Lower a projector (projector.cpp) -> its de_params row, as the JAX
    loader does: the position and the unit x, y, z axes of its to_world,
    the irradiance (a color times ``scale``, or ``scale`` and a bitmap or
    checkerboard appended to `textures`, its index + 1 in [12]) and
    tan(fov / 2)."""
    row = np.zeros(em_pkg.DE_ROW, np.float32)
    tw = espec.get("to_world")
    if tw is not None:
        mtx = as_transform(tw).matrix
        row[0:3] = mtx[:3, 3]
        row[13:16] = mtx[:3, 0] / max(np.linalg.norm(mtx[:3, 0]), 1e-12)
        row[16:19] = mtx[:3, 1] / max(np.linalg.norm(mtx[:3, 1]), 1e-12)
        row[6:9] = mtx[:3, 2] / max(np.linalg.norm(mtx[:3, 2]), 1e-12)
    else:
        row[13:16] = [1, 0, 0]
        row[16:19] = [0, 1, 0]
        row[6:9] = [0, 0, 1]
    row[3:6] = float(espec.get("scale", 1.0))
    irr = espec.get("irradiance")
    if isinstance(irr, dict) and irr.get("type") in _IMAGE_TEXTURES:
        textures.append(load_texture_spec(irr))
        row[12] = len(textures)
    elif isinstance(irr, dict) and irr.get("type") in _TEXTURE_TYPES:
        raise _not_ported(f"a {irr['type']} texture as a projector's "
                          f"irradiance")
    elif irr is not None:
        row[3:6] = _rgb(irr, (1, 1, 1)) * float(espec.get("scale", 1.0))
    row[19] = np.tan(np.deg2rad(float(espec.get("fov", 45.0))) / 2)
    return row


def _delta_row(espec: dict, textures: list):
    """Lower a point, spot, directional or projector emitter -> (type id,
    de_params row), as the JAX loader does. A ``to_world`` places a point
    or spot light at its image of the origin (``position`` is then
    ignored) and gives a spot or directional emitter its +z axis."""
    etype = espec["type"]
    _check_keys(espec, DELTA_KEYS[etype], f"{etype} emitter")
    if etype == "projector":
        return em_pkg.PROJECTOR, _projector_row(espec, textures)
    row = np.zeros(em_pkg.DE_ROW, np.float32)
    tw = espec.get("to_world")
    tw = as_transform(tw) if tw is not None else None
    if etype == "point":
        pos = np.asarray(espec.get("position", (0, 0, 0)), np.float32)
        if tw is not None:
            pos = np.asarray(tw.transform_point(np.zeros(3, np.float32)),
                             np.float32)
        row[0:3] = pos
        row[3:6] = _rgb(espec.get("intensity"), (1, 1, 1))
        return em_pkg.POINT, row
    if tw is not None:
        if etype == "spot":
            row[0:3] = np.asarray(tw.transform_point(
                np.zeros(3, np.float32)), np.float32)
        axis = np.asarray(tw.transform_vector(
            np.array([0, 0, 1], np.float32)), np.float32)
    else:
        if etype == "spot":
            row[0:3] = np.asarray(espec.get("position", (0, 0, 0)),
                                  np.float32)
        axis = np.asarray(espec.get("direction", (0, 0, 1)), np.float32)
    row[6:9] = axis / max(np.linalg.norm(axis), 1e-12)
    if etype == "directional":
        row[3:6] = _rgb(espec.get("irradiance"), (1, 1, 1))
        return em_pkg.DIRECTIONAL, row
    row[3:6] = _rgb(espec.get("intensity"), (1, 1, 1))
    cutoff_deg = float(espec.get("cutoff_angle", 20.0))
    cutoff = cutoff_deg * np.pi / 180.0
    beam = float(espec.get("beam_width", cutoff_deg * 0.75)) * np.pi / 180.0
    row[9] = np.cos(cutoff)
    row[10] = cutoff
    row[11] = 1.0 / max(cutoff - beam, 1e-6)
    return em_pkg.SPOT, row


def _accel_builder(dev: torch.device):
    """The accel build that ``MI3T_ACCEL`` selects for a scene on `dev`
    (None: the dense test)."""
    choice = os.environ.get("MI3T_ACCEL", "auto")
    if choice == "auto":
        choice = "xla" if dev.type == "cpu" else "cells"
    if choice not in ACCELS:
        raise ValueError(f"MI3T_ACCEL: unknown accel {choice!r}")
    return ACCELS[choice]


def _area_radiance(espec: dict, spectral_variant: bool = False):
    """(radiance row, SPD or None) of a shape's ``area`` or
    ``directionalarea`` emitter: the SPD of a sampled-spectrum radiance
    in the spectral variant (None in RGB)."""
    if espec.get("type") not in ("area", "directionalarea"):
        raise _not_ported(f"shape emitter type {espec.get('type')!r}")
    _check_keys(espec, ("type", "radiance"), f"{espec['type']} emitter")
    rad = espec.get("radiance")
    if not spectral_variant:
        return _rgb(rad, (1, 1, 1)), None
    return _rgb(_projected(rad), (1, 1, 1)), _spd_row(rad)


def _env_data(env_spec: dict) -> np.ndarray:
    """The environment's [H, W, 3] radiance map, as the JAX loader makes
    it."""
    etype = env_spec["type"]
    if etype == "constant":
        rad = _rgb(env_spec.get("radiance"), (1.0, 1.0, 1.0))
        return np.broadcast_to(rad, (4, 8, 3)).astype(np.float32)
    if etype == "sunsky":
        return sunsky.build_sunsky_envmap(env_spec)
    if etype == "timed_sunsky":
        return sunsky.build_timed_sunsky_envmap(env_spec)
    if "filename" in env_spec or "data" in env_spec:
        return load_texture_spec({"type": "bitmap", **{
            k: v for k, v in env_spec.items()
            if k in ("filename", "data", "raw")}}).data
    return np.ones((4, 8, 3), np.float32)


def _emitter_sampling(em_faces, em_areas, n_faces: int, n_emitters: int):
    """(face_inv_total_area [F], ef_face [FE], ef_cdf [FE]): per face
    1/(its emitter's total area), and the global area-weighted CDF over
    emissive faces, whose total is the area emitters' share n_area/E of
    the emitter pick (the environment and delta emitters take the rest)."""
    face_inv_total_area = np.zeros(n_faces, np.float32)
    ef_face, ef_pmf = [], []
    for fids, areas in zip(em_faces, em_areas):
        total = float(areas.sum())
        face_inv_total_area[fids] = 1.0 / total
        ef_face.extend(fids)
        ef_pmf.extend((areas / total / max(n_emitters, 1)).tolist())
    ef_cdf = np.cumsum(np.asarray(ef_pmf, np.float64)).astype(np.float32)
    if ef_cdf.size:
        ef_cdf[-1] = len(em_faces) / max(n_emitters, 1)
    return face_inv_total_area, np.asarray(ef_face, np.int32), ef_cdf


def _tri_rows(vertices, faces):
    """(p0, e1, e2) [F, 3] arrays of `faces`."""
    p0 = vertices[faces[:, 0]]
    return p0, vertices[faces[:, 1]] - p0, vertices[faces[:, 2]] - p0


def _lower_prototypes(shapegroups, instance_specs, add_bsdf, n_shapes,
                      vertices, faces, face_uv, face_normals, face_colors,
                      face_shape, face_bsdf, face_emitter, face_medium,
                      face_inv_total_area):
    """The JAX loader's true instancing: each referenced shapegroup lowered
    once into prototype-space faces appended to the face arrays (its
    members tessellated by build_shape, padded to a TRI_CHUNK multiple),
    and per instance its transforms and world AABB, the instance table
    padded to a multiple of INSTANCE_PAD with never-hit rows. Returns the
    extended arrays, the prototypes' (base, count) face ranges and the
    InstanceTable's arrays."""
    slots: dict[str, int] = {}
    ranges, lo_g, hi_g = [], [], []
    v_parts, f_parts = [vertices], [faces]
    uv_p, ns_p, fs_p, fb_p = [], [], [], []
    v_off, f_total = vertices.shape[0], faces.shape[0]
    for gid, _ in instance_specs:
        if gid in slots:
            continue
        if gid not in shapegroups:
            raise ValueError(f"instance references unknown shapegroup "
                             f"{gid!r}")
        slots[gid] = len(ranges)
        base = f_total
        g_lo = np.full(3, np.inf, np.float32)
        g_hi = np.full(3, -np.inf, np.float32)
        for member in shapegroups[gid]:
            mtype = member.get("type")
            if mtype in ("sdfgrid", "ellipsoids"):
                raise ValueError(f"shapegroup member type {mtype!r} cannot "
                                 f"be instanced (triangle meshes only)")
            if member.get("emitter") is not None:
                raise ValueError(
                    "emitters inside shapegroups are not supported "
                    "(matches the reference instance.cpp restriction)")
            mesh = shapes_pkg.build_shape(member)
            bspec = member.get("bsdf")
            b_idx = add_bsdf(bspec if bspec is not None
                             else {"type": "diffuse"})
            nf = mesh.faces.shape[0]
            mv = mesh.vertices.astype(np.float32)
            v_parts.append(mv)
            f_parts.append((mesh.faces + v_off).astype(np.int32))
            fs_p.extend([n_shapes] * nf)
            fb_p.extend([b_idx] * nf)
            uv_p.append(mesh.uvs[mesh.faces] if mesh.uvs is not None
                        else np.zeros((nf, 3, 2)))
            ns_p.append(mesh.normals[mesh.faces]
                        if mesh.normals is not None else np.zeros((nf, 3, 3)))
            g_lo = np.minimum(g_lo, mv.min(axis=0))
            g_hi = np.maximum(g_hi, mv.max(axis=0))
            v_off += mv.shape[0]
            f_total += nf
            n_shapes += 1
        pad = (-(f_total - base)) % TRI_CHUNK
        if pad:
            f_parts.append(np.zeros((pad, 3), np.int32))
            fs_p.extend([-1] * pad)
            fb_p.extend([0] * pad)
            uv_p.append(np.zeros((pad, 3, 2)))
            ns_p.append(np.zeros((pad, 3, 3)))
            f_total += pad
        ranges.append((int(base), int(f_total - base)))
        lo_g.append(g_lo)
        hi_g.append(g_hi)
    n_new = f_total - faces.shape[0]

    def cat(a, b, dtype):
        return np.concatenate([a, np.asarray(b, dtype).reshape(
            (n_new,) + a.shape[1:])], 0)

    n_inst = len(instance_specs)
    n_pad = n_inst + (-n_inst) % INSTANCE_PAD
    tables = {"to_world": np.tile(np.eye(3, 4, dtype=np.float32).reshape(
        1, 12), (n_pad, 1)), "n_mat": np.tile(np.eye(
            3, dtype=np.float32).reshape(1, 9), (n_pad, 1)),
        # NaN boxes: every slab comparison is False, so a padding row is
        # never a candidate
        "aabb_lo": np.full((n_pad, 3), np.nan, np.float32),
        "aabb_hi": np.full((n_pad, 3), np.nan, np.float32),
        "proto_of": np.zeros(n_pad, np.int32)}
    tables["to_proto"] = tables["to_world"].copy()
    for ix, (gid, tw) in enumerate(instance_specs):
        slot = slots[gid]
        mtx = np.asarray(tw.matrix, np.float64)
        inv = np.linalg.inv(mtx)
        tables["proto_of"][ix] = slot
        tables["to_world"][ix] = mtx[:3, :4].reshape(-1)
        tables["to_proto"][ix] = inv[:3, :4].reshape(-1)
        tables["n_mat"][ix] = inv[:3, :3].T.reshape(-1)
        lo, hi = lo_g[slot], hi_g[slot]
        corners = np.array([[x, y, z] for z in (lo[2], hi[2])
                            for y in (lo[1], hi[1]) for x in (lo[0], hi[0])])
        wc = corners @ mtx[:3, :3].T + mtx[:3, 3]
        tables["aabb_lo"][ix] = wc.min(axis=0)
        tables["aabb_hi"][ix] = wc.max(axis=0)
    return (np.concatenate(v_parts, 0).astype(np.float32),
            np.concatenate(f_parts, 0).astype(np.int32),
            cat(face_uv, np.concatenate([np.zeros((0, 3, 2))] + uv_p, 0),
                np.float32),
            cat(face_normals, np.concatenate([np.zeros((0, 3, 3))] + ns_p,
                                             0), np.float32),
            cat(face_colors, np.zeros((n_new, 3, 3)), np.float32),
            cat(face_shape, fs_p, np.int32), cat(face_bsdf, fb_p, np.int32),
            cat(face_emitter, np.full(n_new, -1), np.int32),
            cat(face_medium, np.full((n_new, 2), -2), np.int32),
            cat(face_inv_total_area, np.zeros(n_new), np.float32),
            tuple(ranges), tables)


def load_dict(d: dict, device=None, spectral: bool | None = None) -> Scene:
    """Lower a scene dict to a Scene on `device` (the card by default), in
    the spectral variant when `spectral` is true; None reads the variant
    that ``set_variant`` chose (RGB unless a "spectral" one)."""
    if spectral is None:
        from . import variant
        spectral = "spectral" in variant()
    dev = resolve_device(device)
    if d.get("type") != "scene":
        raise ValueError("Top-level dict must have type='scene'")

    integrator_cfg = PathConfig()
    film_cfg = FilmConfig()
    sensor = None
    spp = 64
    sampler_type = "independent"
    bsdf_types: list[int] = []
    bsdf_params: list[np.ndarray] = []
    named_bsdf: dict[str, int] = {}
    textures: list[Texture] = []
    measured: list[dict] = []
    bsdf_spds = [] if spectral else None   # sampled reflectances' SPDs

    def add_bsdf(spec, name=None):
        if spec.get("type") == "ref":
            return named_bsdf[spec["id"]]
        tid, row = _bsdf_row(spec, add_bsdf, textures, measured, bsdf_spds)
        bsdf_types.append(tid)
        bsdf_params.append(row)
        if name is not None:
            named_bsdf[name] = len(bsdf_types) - 1
        return len(bsdf_types) - 1

    # media: named at the top level, a shape's interior/exterior, the
    # sensor's medium
    named_medium: dict[str, int] = {}
    medium_types: list[int] = []
    phase_types: list[int] = []
    medium_rows: list[np.ndarray] = []
    medium_to_grids: list[np.ndarray] = []
    medium_grids: list[np.ndarray] = []
    phase_tables: list[np.ndarray] = []
    sensor_medium = -1

    def add_medium(spec, name=None):
        if spec.get("type") == "ref":
            return named_medium[spec["id"]]
        if spec.get("type") not in MEDIUM_KEYS:
            raise _not_ported(f"medium type {spec.get('type')!r}")
        mtype, ptype, row, to_grid = _medium_row(spec, medium_grids,
                                                 phase_tables)
        medium_types.append(mtype)
        phase_types.append(ptype)
        medium_rows.append(row)
        medium_to_grids.append(to_grid)
        if name is not None:
            named_medium[name] = len(medium_types) - 1
        return len(medium_types) - 1

    shape_items = []
    instance_specs = []   # (shapegroup id, to_world) per instance
    env_spec = None
    delta_specs = []
    # shapegroups may be referenced before they are defined
    shapegroups = {key: [v for v in val.values() if isinstance(v, dict)
                         and v.get("type") in GROUP_MEMBER_TYPES]
                   for key, val in d.items() if isinstance(val, dict)
                   and val.get("type") == "shapegroup"}
    for key, val in d.items():
        if key == "type" or not isinstance(val, dict):
            continue
        vtype = val.get("type")
        if key == "integrator" or vtype in INTEGRATORS:
            integrator_cfg = integrator_from_dict(val)
        elif vtype in sensors_pkg.TYPES or vtype == "batch":
            film_cfg, spp, sampler_type, sensor = _sensor(val, dev)
            if val.get("medium") is not None:
                sensor_medium = add_medium(val["medium"])
        elif vtype in BSDF_NAMES or bsdfs_pkg.custom_type(vtype) is not None:
            add_bsdf(val, name=key)
        elif vtype in MEDIUM_KEYS:
            add_medium(val, name=key)
        elif vtype in shapes_pkg.SHAPE_KEYS:
            if vtype == "ellipsoidsmesh" and "bsdf" not in val:
                # the shells default to their primitives' colors
                val = dict(val, bsdf=ELLIPSOID_BSDF)
            shape_items.append(val)
        elif vtype == "shapegroup":
            pass   # read above
        elif vtype == "instance":
            ref = next(v for v in val.values()
                       if isinstance(v, dict) and v.get("type") == "ref")
            instance_specs.append((ref["id"], as_transform(
                val.get("to_world", np.eye(4)))))
        elif vtype == "merge":
            # merge.cpp: every mesh lands in one face table anyway, so the
            # children are inlined
            shape_items.extend(
                cv for cv in val.values() if isinstance(cv, dict)
                and cv.get("type") in GROUP_MEMBER_TYPES)
        elif vtype in ENV_KEYS:
            _check_keys(val, ENV_KEYS[vtype], f"{vtype} emitter")
            env_spec = val
        elif vtype in DELTA_KEYS:
            delta_specs.append(val)
        else:
            raise _not_ported(f"plugin type {vtype!r} (scene key {key!r})")

    sensor_data, sensor_cfg = sensor or sensors_pkg.build_perspective(
        {"fov": 45.0}, film_cfg.width, film_cfg.height, dev)

    # ---- lower shapes; area emitters take the first emitter slots ----
    all_verts, all_faces, face_uv, face_ns, face_vc = [], [], [], [], []
    face_shape, face_bsdf, face_emitter, face_medium = [], [], [], []
    em_radiance, em_faces, em_areas = [], [], []
    em_spds = []                         # per area emitter: SPD or None
    em_sphere, em_directional = [], []   # per area emitter; its slots
    analytic_rows, sdf_grids, sdf_rows = [], [], []
    v_off = f_off = 0
    any_colors = False

    def implicit_media(spec):
        """An analytic or SDF shape's (interior, exterior) media, -2 where
        none is given."""
        int_spec = spec.get("interior") or spec.get("interior_medium")
        ext_spec = spec.get("exterior") or spec.get("exterior_medium")
        return (add_medium(int_spec) if int_spec is not None else -2,
                add_medium(ext_spec) if ext_spec is not None else -2)

    for s_idx, spec in enumerate(shape_items):
        shapes_pkg.check_keys(spec)
        arow = shapes_pkg.analytic_row(spec)
        bspec = spec.get("bsdf")
        b_idx = add_bsdf(bspec if bspec is not None else {"type": "diffuse"})
        stype = spec["type"]
        if stype == "sdfgrid":
            # the grid in the to_world-mapped unit cube, sphere-traced at
            # render time (ops/sdf.py)
            row = np.zeros(sdf_mod.SDF_COLS, np.float32)
            mtx = as_transform(spec.get("to_world", np.eye(4))).matrix
            row[0:12] = np.linalg.inv(mtx)[:3, :4].reshape(-1)
            row[13], row[14] = s_idx, b_idx
            row[15], row[16] = implicit_media(spec)
            row[12] = len(sdf_grids)
            if "filename" in spec:
                from .utils.vol_io import read_vol
                sdf_grids.append(read_vol(spec["filename"])[0])
            else:
                sdf_grids.append(np.asarray(spec["grid"], np.float32))
            sdf_rows.append(row)
            continue
        rows = None
        if arow is not None:
            rows = arow[None]
        elif stype in ("linearcurve", "bsplinecurve") \
                and not spec.get("tessellate", False) \
                and spec.get("emitter") is None:
            # exact swept-sphere curves: round-cone rows, a tube above
            # MAX_CONES
            rows = curves_mod.curve_cone_rows(spec, stype == "bsplinecurve")
        if rows is not None:
            # implicit: no faces, intersected analytically
            rows[:, 15], rows[:, 16], rows[:, 17] = s_idx, b_idx, -1
            rows[:, 18], rows[:, 19] = implicit_media(spec)
            analytic_rows.extend(rows)
            continue
        mesh = shapes_pkg.build_shape(spec)
        nf = mesh.faces.shape[0]
        e_idx = -1
        if spec.get("emitter") is not None:
            e_idx = len(em_radiance)
            rad, spd = _area_radiance(spec["emitter"], spectral)
            em_radiance.append(rad)
            em_spds.append(spd)
            em_faces.append(list(range(f_off, f_off + nf)))
            em_areas.append(mesh.face_areas())
            if spec["emitter"]["type"] == "directionalarea":
                em_directional.append(e_idx)
            em_sphere.append(shapes_pkg.sphere_center_radius(spec))
        all_verts.append(mesh.vertices)
        all_faces.append(mesh.faces + v_off)
        face_uv.append(mesh.uvs[mesh.faces] if mesh.uvs is not None
                       else np.zeros((nf, 3, 2)))
        face_ns.append(mesh.normals[mesh.faces] if mesh.normals is not None
                       else np.zeros((nf, 3, 3)))
        face_vc.append(mesh.colors[mesh.faces] if mesh.colors is not None
                       else np.zeros((nf, 3, 3)))
        any_colors = any_colors or mesh.colors is not None
        int_spec = spec.get("interior") or spec.get("interior_medium")
        ext_spec = spec.get("exterior") or spec.get("exterior_medium")
        if int_spec is not None or ext_spec is not None:
            m_in = add_medium(int_spec) if int_spec is not None else -1
            m_ex = add_medium(ext_spec) if ext_spec is not None else -1
        else:
            m_in = m_ex = -2    # NO_TRANSITION
        face_medium.extend([(m_in, m_ex)] * nf)
        face_shape.extend([s_idx] * nf)
        face_bsdf.extend([b_idx] * nf)
        face_emitter.extend([e_idx] * nf)
        v_off += mesh.vertices.shape[0]
        f_off += nf
    if not all_verts:
        if not analytic_rows and not sdf_rows:
            raise ValueError("Scene contains no shapes")
        # an all-implicit scene keeps one degenerate (never hit) triangle,
        # so that the face tables are not empty
        all_verts.append(np.zeros((3, 3)))
        all_faces.append(np.zeros((1, 3), np.int64))
        face_uv.append(np.zeros((1, 3, 2)))
        face_ns.append(np.zeros((1, 3, 3)))
        face_vc.append(np.zeros((1, 3, 3)))
        face_medium.append((-2, -2))
        face_shape.append(-1)
        face_bsdf.append(0)
        face_emitter.append(-1)

    vertices = np.concatenate(all_verts, 0).astype(np.float32)
    faces = np.concatenate(all_faces, 0).astype(np.int32)
    face_uv = np.concatenate(face_uv, 0).astype(np.float32)
    face_normals = np.concatenate(face_ns, 0).astype(np.float32)
    face_colors = np.concatenate(face_vc, 0).astype(np.float32)
    face_shape = np.asarray(face_shape, np.int32)
    face_bsdf = np.asarray(face_bsdf, np.int32)
    face_emitter = np.asarray(face_emitter, np.int32)
    face_medium = np.asarray(face_medium, np.int32).reshape(-1, 2)
    n_faces = faces.shape[0]

    # emitter slots: [area emitters][delta emitters][environment]
    n_area = len(em_radiance)
    lowered = [_delta_row(e, textures) for e in delta_specs]
    de_types = tuple(tid for tid, _ in lowered)
    de_rows = [row for _, row in lowered]
    n_delta = len(de_rows)
    has_env = env_spec is not None
    env_index = n_area + n_delta if has_env else -1
    n_emitters = n_area + n_delta + (1 if has_env else 0)
    if has_env:
        env_data = _env_data(env_spec)
        env_scale = float(env_spec.get("scale", 1.0))
        # the environment holds an em_radiance slot too (unused for eval)
        em_radiance.append(np.zeros(3, np.float32))
    else:
        env_data = np.zeros((1, 1, 3), np.float32)
        env_scale = 1.0
    env_warp = env_mod.build_tables(env_data, dev)
    face_inv_total_area, ef_face, ef_cdf = _emitter_sampling(
        em_faces, em_areas, n_faces, n_emitters)

    # pad faces with degenerate triangles (vertex 0 repeated): to TRI_PAD
    # for small scenes, to a TRI_CHUNK multiple for large ones
    grain = TRI_PAD if n_faces <= TRI_CHUNK else TRI_CHUNK
    pad = (-n_faces) % grain
    if pad:
        faces = np.concatenate([faces, np.zeros((pad, 3), np.int32)], 0)
        face_shape = np.concatenate([face_shape, np.full(pad, -1, np.int32)])
        face_bsdf = np.concatenate([face_bsdf, np.zeros(pad, np.int32)])
        face_emitter = np.concatenate([face_emitter,
                                       np.full(pad, -1, np.int32)])
        face_medium = np.concatenate(
            [face_medium, np.full((pad, 2), -2, np.int32)], 0)
        face_inv_total_area = np.concatenate(
            [face_inv_total_area, np.zeros(pad, np.float32)])
        face_uv = np.concatenate(
            [face_uv, np.zeros((pad, 3, 2), np.float32)], 0)
        face_normals = np.concatenate(
            [face_normals, np.zeros((pad, 3, 3), np.float32)], 0)
        face_colors = np.concatenate(
            [face_colors, np.zeros((pad, 3, 3), np.float32)], 0)
    n_padded = faces.shape[0]

    # small scenes keep the dense all-triangles test (accel None)
    accel = None
    build = _accel_builder(dev) if n_padded > ACCEL_MIN_FACES else None
    if build is not None:
        accel = build(*_tri_rows(vertices, faces), device=dev)

    def t(a):
        return torch.as_tensor(np.ascontiguousarray(a), device=dev)

    em_spd = None
    if any(r is not None for r in em_spds):
        em_spd = np.zeros((len(em_radiance), spectral_mod.SPD_N), np.float32)
        for i, r in enumerate(em_spds):
            if r is not None:
                em_spd[i] = r

    instances, proto_accels, proto_ranges = None, (), ()
    if instance_specs:
        # prototype faces appended past the queried ones, in prototype
        # space, each shapegroup once
        (vertices, faces, face_uv, face_normals, face_colors, face_shape,
         face_bsdf, face_emitter, face_medium, face_inv_total_area,
         proto_ranges, tables) = _lower_prototypes(
            shapegroups, instance_specs, add_bsdf, len(shape_items),
            vertices, faces, face_uv, face_normals, face_colors, face_shape,
            face_bsdf, face_emitter, face_medium, face_inv_total_area)
        proto_accels = tuple(
            cellserve.build(*_tri_rows(vertices, faces[b:b + c]), device=dev)
            if c > ACCEL_MIN_FACES else None for b, c in proto_ranges)
        instances = instancing.InstanceTable(
            **{k: t(v) for k, v in tables.items()})

    return Scene(
        vertices=t(vertices),
        faces=t(faces),
        face_shape=t(face_shape),
        face_bsdf=t(face_bsdf),
        face_emitter=t(face_emitter),
        face_inv_total_area=t(face_inv_total_area),
        face_uv=t(face_uv),
        face_normals=t(face_normals),
        em_radiance=t(np.asarray(em_radiance, np.float32).reshape(-1, 3)
                      if em_radiance else np.zeros((1, 3), np.float32)),
        ef_face=t(ef_face),
        ef_cdf=t(ef_cdf),
        env_data=t(env_data),
        env_warp=env_warp,
        env_scale=torch.tensor(env_scale, dtype=torch.float32, device=dev),
        de_params=t(np.stack(de_rows, 0)) if de_rows else None,
        bsdf_params=t(np.stack(bsdf_params, 0)),
        sensor=sensor_data,
        accel=accel,
        textures=tuple(t(tx.data) for tx in textures),
        texture_mips=tuple(
            tuple(t(lv) for lv in tex_mod.build_mips(tx.data))
            if tx.meta[2] else () for tx in textures),
        face_colors=t(face_colors) if any_colors else None,
        measured_tables=tuple(measured_tables(s, dev) for s in measured),
        medium_params=t(np.stack(medium_rows, 0) if medium_rows else
                        np.zeros((0, media_pkg.N_MPARAMS), np.float32)),
        medium_grids=tuple(t(g) for g in medium_grids),
        phase_tables=tuple(t(tb) for tb in phase_tables),
        medium_to_grid=t(np.stack(medium_to_grids, 0) if medium_to_grids
                         else np.zeros((0, 3, 4), np.float32)),
        face_medium=t(face_medium),
        em_sphere=(t(np.stack([r if r is not None
                               else np.zeros(4, np.float32)
                               for r in em_sphere], 0))
                   if any(r is not None for r in em_sphere) else None),
        em_sphere_slots=tuple(i for i, r in enumerate(em_sphere)
                              if r is not None),
        em_directional=tuple(em_directional),
        projector_textures=em_pkg.projector_textures(de_types, de_rows),
        analytic_prims=(t(np.stack(analytic_rows, 0)) if analytic_rows
                        else None),
        sdf_grids=tuple(t(g) for g in sdf_grids),
        sdf_rows=t(np.stack(sdf_rows, 0)) if sdf_rows else None,
        instances=instances,
        proto_accels=proto_accels,
        proto_ranges=proto_ranges,
        n_query_faces=n_padded if instance_specs else 0,
        em_spd=t(em_spd) if em_spd is not None else None,
        bsdf_spd=t(np.stack(bsdf_spds, 0)) if bsdf_spds else None,
        em_spd_slots=tuple(i for i, r in enumerate(em_spds) if r is not None),
        spectral=bool(spectral),
        medium_types=tuple(medium_types),
        phase_types=tuple(phase_types),
        sensor_medium=sensor_medium,
        n_emitters=n_emitters,
        n_area_emitters=n_area,
        env_emitter=env_index,
        delta_emitter_types=de_types,
        bsdf_types=tuple(bsdf_types),
        texture_meta=tuple(tx.meta for tx in textures),
        **bsdfs_pkg.dispatch_tables(bsdf_types, bsdf_params, reached_slots(
            face_bsdf, face_shape,
            np.stack(analytic_rows, 0) if analytic_rows else None,
            np.stack(sdf_rows, 0) if sdf_rows else None)),
        bsdf_flags=_slot_flags(bsdf_types, bsdf_params),
        adapter_max_depth=_adapter_chain_depth(bsdf_types, bsdf_params),
        film=film_cfg,
        sensor_config=sensor_cfg,
        integrator=integrator_cfg,
        spp=spp,
        sampler_type=sampler_type)
