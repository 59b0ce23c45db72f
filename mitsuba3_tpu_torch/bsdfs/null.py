"""Null (pass-through) BSDF — counterpart of ``mitsuba3_tpu/bsdfs/null.py``.

Index-matched transmission: light continues undeflected (wo = -wi in the
local frame). Param row: [0:3] transmittance rgb (default 1).
"""
from __future__ import annotations

import torch

from ..core.vec import Vec3
from ..render.records import BSDFSample

FLAGS = 0x0001 | 0x2000 | 0x4000  # Null | FrontSide | BackSide


def sample(scene, bsdf_idx, si, s1, s2):
    params = scene.gather_bsdf_params(bsdf_idx)
    ones = torch.ones_like(si.t)
    bs = BSDFSample(
        wo=-si.wi, pdf=ones, eta=ones,
        sampled_type=torch.full_like(si.t, 0x0001, dtype=torch.int32),
        sampled_component=torch.zeros_like(si.t, dtype=torch.int32))
    return bs, Vec3(params[0], params[1], params[2])


def eval_pdf(scene, bsdf_idx, si, wo):
    return Vec3.zeros(si.t.shape[0], si.t.device), torch.zeros_like(si.t)


def eval_null_transmission(scene, bsdf_idx, si):
    """The transmittance of a shadow ray passing straight through."""
    params = scene.gather_bsdf_params(bsdf_idx)
    return Vec3(params[0], params[1], params[2])
