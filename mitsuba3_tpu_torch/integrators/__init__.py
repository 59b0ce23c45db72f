"""Integrator registry — counterpart of ``mitsuba3_tpu/integrators/__init__.py``.

The port carries ``path``, ``prb`` (path replay backpropagation,
``ad/prb.py``), ``volpath`` and ``volpathmis`` (``volpath.py``) and
``prbvolpath`` (``ad/prbvolpath.py``). Each module exposes
``sample(scene, rng, ray, cfg) -> (L, valid, n_rays)``; its frozen config
rides in the scene's ``integrator`` field.
"""
from __future__ import annotations

from . import path as path_mod
from . import volpath as volpath_mod
from .path import PathConfig

TYPES = ("path", "prb", "volpath", "volpathmis", "prbvolpath")


def get_integrator(cfg):
    if cfg.type == "prb":
        from ..ad import prb as prb_mod
        return prb_mod
    if cfg.type == "prbvolpath":
        from ..ad import prbvolpath as prbvol_mod
        return prbvol_mod
    if cfg.type in ("volpath", "volpathmis"):
        return volpath_mod
    return path_mod


def config_from_dict(spec: dict):
    itype = spec.get("type", "path")
    if itype not in TYPES:
        raise NotImplementedError(f"integrator type {itype!r} is not ported")
    if itype in ("volpath", "volpathmis"):
        return volpath_mod.config_from_dict(spec)
    if itype == "prbvolpath":
        from ..ad.prbvolpath import PRBVolpathConfig
        return volpath_mod.config_from_dict(spec, PRBVolpathConfig)
    cls = PathConfig
    if itype == "prb":
        from ..ad.prb import PRBConfig
        cls = PRBConfig
    return cls(
        type=itype,
        max_depth=int(spec.get("max_depth", 8)),
        rr_depth=int(spec.get("rr_depth", 5)),
        hide_emitters=bool(spec.get("hide_emitters", False)))
