"""Integrator registry — counterpart of ``mitsuba3_tpu/integrators/__init__.py``.

The port carries ``path``, ``prb`` (path replay backpropagation,
``ad/prb.py``), ``volpath`` and ``volpathmis`` (``volpath.py``),
``prbvolpath`` (``ad/prbvolpath.py``), ``direct``, ``aov`` and ``depth``
(``aov.py``), ``moment`` and ``ptracer`` (the light tracer, rendered by
``ptracer.render_ptracer``). Each module exposes
``sample(scene, rng, ray, cfg) -> (L, valid, n_rays)``, L a Vec3 or an
[N, C] tensor of ``n_channels(cfg)`` channels; its frozen config rides
in the scene's ``integrator`` field. ``stokes``, ``volprim_rf_basic``,
``prb_projective`` and ``direct_projective`` are not ported.
"""
from __future__ import annotations

import dataclasses
import types

from . import aov as aov_mod
from . import direct as direct_mod
from . import moment as moment_mod
from . import path as path_mod
from . import ptracer as ptracer_mod
from . import volpath as volpath_mod
from .path import PathConfig

TYPES = ("path", "prb", "volpath", "volpathmis", "prbvolpath", "direct",
         "aov", "depth", "moment", "ptracer")
_depth_mod = types.SimpleNamespace(sample=aov_mod.depth_sample,
                                   n_channels=aov_mod.depth_n_channels)
_MODULES = {"path": path_mod, "volpath": volpath_mod,
            "volpathmis": volpath_mod, "direct": direct_mod,
            "aov": aov_mod, "depth": _depth_mod, "moment": moment_mod,
            "ptracer": ptracer_mod}


def get_integrator(cfg):
    if cfg.type == "prb":
        from ..ad import prb as prb_mod
        return prb_mod
    if cfg.type == "prbvolpath":
        from ..ad import prbvolpath as prbvol_mod
        return prbvol_mod
    return _MODULES[cfg.type]


def n_channels(cfg) -> int:
    """The film's channel count under integrator `cfg` (3 but for aov and
    moment)."""
    return getattr(get_integrator(cfg), "n_channels", lambda _: 3)(cfg)


def config_from_dict(spec: dict):
    itype = spec.get("type", "path")
    if itype not in TYPES:
        raise NotImplementedError(f"integrator type {itype!r} is not ported")
    if itype in ("volpath", "volpathmis"):
        return volpath_mod.config_from_dict(spec)
    if itype == "prbvolpath":
        from ..ad.prbvolpath import PRBVolpathConfig
        return volpath_mod.config_from_dict(spec, PRBVolpathConfig)
    if itype in ("direct", "ptracer", "moment"):
        return _MODULES[itype].config_from_dict(spec)
    if itype in ("aov", "depth"):
        return aov_mod.config_from_dict(spec)
    cls = PathConfig
    if itype == "prb":
        from ..ad.prb import PRBConfig
        cls = PRBConfig
    return cls(
        type=itype,
        max_depth=int(spec.get("max_depth", 8)),
        rr_depth=int(spec.get("rr_depth", 5)),
        hide_emitters=bool(spec.get("hide_emitters", False)))


def config_to_dict(cfg) -> dict:
    """A spec that `config_from_dict` turns back into `cfg`: the fields of
    the port's config of that type, read by name from `cfg` (a JAX or a
    port config alike), the nested configs of ``moment`` and ``aov`` as
    specs of their own."""
    fields = dataclasses.fields(type(config_from_dict({"type": cfg.type})))
    spec = {f.name: getattr(cfg, f.name) for f in fields}
    if spec.get("nested") is not None:
        spec["nested"] = config_to_dict(spec["nested"])
    if "inner" in spec:
        inner = spec.pop("inner")
        spec["aovs"] = list(spec["aovs"])
        if inner is not None:
            spec["integrator"] = config_to_dict(inner)
    return spec
