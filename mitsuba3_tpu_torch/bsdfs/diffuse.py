"""Smooth diffuse (Lambertian) BSDF — counterpart of
``mitsuba3_tpu/bsdfs/diffuse.py``.

Param row: [0:3] reflectance rgb, [3] texture id (0 = constant),
[16] two-sided flag. `params` arrives as SoA rows [N_PARAMS, N].
"""
from __future__ import annotations

import torch

from ..core import math as m
from ..core.vec import Vec2, Vec3
from ..core.warp import square_to_cosine_hemisphere
from ..render.records import BSDFSample
from ..render.texture import eval_color

FLAGS = 0x0002 | 0x2000  # DiffuseReflection | FrontSide


def _side_sign(params, si):
    """Two-sided handling: flip the local frame for lanes hit from the
    back when the two-sided flag is set."""
    flip = (params[16] > 0.5) & (si.wi.z < 0.0)
    return torch.where(flip, -1.0, 1.0)


def reflectance(scene, params, si) -> Vec3:
    return eval_color(scene, Vec3(params[0], params[1], params[2]),
                      params[3], si, scene.texture_ids("diffuse"))


def sample(scene, bsdf_idx, si, s1, s2: Vec2):
    params = scene.gather_bsdf_params(bsdf_idx)
    sgn = _side_sign(params, si)
    active = si.wi.z * sgn > 0.0

    wo = square_to_cosine_hemisphere(s2)
    pdf = wo.z * m.InvPi
    wo = Vec3(wo.x, wo.y, wo.z * sgn)

    # weight = f * cos / pdf = reflectance (diffuse.cpp sample)
    weight = reflectance(scene, params, si).mask(active)
    bs = BSDFSample(
        wo=wo,
        pdf=torch.where(active, pdf, 0.0),
        eta=torch.ones_like(pdf),
        sampled_type=torch.full_like(pdf, 0x0002, dtype=torch.int32),
        sampled_component=torch.zeros_like(pdf, dtype=torch.int32))
    return bs, weight


def eval_pdf(scene, bsdf_idx, si, wo: Vec3):
    params = scene.gather_bsdf_params(bsdf_idx)
    sgn = _side_sign(params, si)
    cos_theta_o = wo.z * sgn
    active = (si.wi.z * sgn > 0.0) & (cos_theta_o > 0.0)

    factor = m.InvPi * torch.clamp(cos_theta_o, min=0.0)
    value = (reflectance(scene, params, si) * factor).mask(active)
    pdf = torch.where(active, factor, 0.0)
    return value, pdf
