"""Smooth dielectric — counterpart of ``mitsuba3_tpu/bsdfs/dielectric.py``.

Delta reflection and refraction with Fresnel-weighted lobe selection.
Param row: [0] eta (int_ior / ext_ior), [1:4] specular reflectance,
[4:7] specular transmittance. The port renders RGB only: the row's
dispersion slot [8] belongs to the JAX package's spectral variant.
"""
from __future__ import annotations

import torch

from ..core.vec import Vec3
from ..render.fresnel import fresnel_dielectric, reflect, refract
from ..render.records import BSDFSample

FLAGS = 0x0020 | 0x0040 | 0x2000 | 0x4000  # DeltaR|DeltaT|Front|Back


def sample(scene, bsdf_idx, si, s1, s2):
    params = scene.gather_bsdf_params(bsdf_idx)
    r, cos_theta_t, eta_it, eta_ti = fresnel_dielectric(si.wi.z, params[0])

    pick_reflect = s1 <= r
    wo = Vec3.where(pick_reflect, reflect(si.wi),
                    refract(si.wi, cos_theta_t, eta_ti))
    pdf = torch.where(pick_reflect, r, 1.0 - r)
    # radiance scales by eta_ti^2 on transmission (solid-angle compression)
    spec_r = Vec3(params[1], params[2], params[3])
    spec_t = Vec3(params[4], params[5], params[6]) * (eta_ti * eta_ti)
    weight = Vec3.where(pick_reflect, spec_r, spec_t)
    active = pdf > 0.0
    bs = BSDFSample(
        wo=wo,
        pdf=torch.where(active, pdf, 0.0),
        eta=torch.where(pick_reflect, 1.0, eta_it),
        sampled_type=torch.where(pick_reflect, 0x0020, 0x0040).to(
            torch.int32),
        sampled_component=torch.where(pick_reflect, 0, 1).to(torch.int32))
    # the lobe weight (F or 1 - F) cancels against the selection pdf
    return bs, weight.mask(active)


def eval_pdf(scene, bsdf_idx, si, wo):
    return Vec3.zeros(si.t.shape[0], si.t.device), torch.zeros_like(si.t)
