"""Thin dielectric — counterpart of ``mitsuba3_tpu/bsdfs/thindielectric.py``.

A thin slab: internal reflections sum analytically to r' = 2r / (1 + r);
transmission passes straight through (wo = -wi, eta 1). Param row:
[0] eta, [1:4] specular reflectance, [4:7] specular transmittance.
"""
from __future__ import annotations

import torch

from ..core.vec import Vec3
from ..render.fresnel import fresnel_dielectric, reflect
from ..render.records import BSDFSample

FLAGS = 0x0020 | 0x0040 | 0x2000 | 0x4000  # DeltaR|DeltaT|Front|Back


def sample(scene, bsdf_idx, si, s1, s2):
    params = scene.gather_bsdf_params(bsdf_idx)
    r = fresnel_dielectric(si.wi.z.abs(), params[0])[0]
    r = r * 2.0 / (1.0 + r)  # the slab's interreflection sum
    pick_reflect = s1 <= r
    wo = Vec3.where(pick_reflect, reflect(si.wi), -si.wi)
    pdf = torch.where(pick_reflect, r, 1.0 - r)
    weight = Vec3.where(pick_reflect, Vec3(params[1], params[2], params[3]),
                        Vec3(params[4], params[5], params[6]))
    active = pdf > 0.0
    bs = BSDFSample(
        wo=wo, pdf=torch.where(active, pdf, 0.0),
        eta=torch.ones_like(pdf),
        sampled_type=torch.where(pick_reflect, 0x0020, 0x0040).to(
            torch.int32),
        sampled_component=torch.where(pick_reflect, 0, 1).to(torch.int32))
    return bs, weight.mask(active)


def eval_pdf(scene, bsdf_idx, si, wo):
    return Vec3.zeros(si.t.shape[0], si.t.device), torch.zeros_like(si.t)
