"""Smooth plastic — counterpart of ``mitsuba3_tpu/bsdfs/plastic.py``.

A delta specular coat over a diffuse base with analytic internal-scattering
compensation. Param row: [0:3] diffuse rgb, [3] texture id, [4] eta,
[5] nonlinear flag, [6] specular sampling weight, [8:11] specular
reflectance, [16] two-sided flag.
"""
from __future__ import annotations

import torch

from ..core import math as m
from ..core.vec import Vec2, Vec3
from ..core.warp import square_to_cosine_hemisphere
from ..render.fresnel import (fresnel_dielectric,
                              fresnel_diffuse_reflectance, reflect)
from ..render.records import BSDFSample
from ..render.texture import eval_color

FLAGS = 0x0020 | 0x0002 | 0x2000  # DeltaReflection | DiffuseReflection | Front


def _side_sign(params, si):
    flip = (params[16] > 0.5) & (si.wi.z < 0.0)
    return torch.where(flip, -1.0, 1.0)


def _probs(f_i, w_s):
    ps = f_i * w_s
    pd = (1.0 - f_i) * (1.0 - w_s)
    ps = m.safe_div(ps, ps + pd)
    return ps, 1.0 - ps


def _diffuse_scale(scene, params, si, eta):
    """diffuse / (1 - fdr_int) (per channel under `nonlinear`) and 1/eta^2."""
    fdr_int = fresnel_diffuse_reflectance(1.0 / eta)
    diff = eval_color(scene, Vec3(params[0], params[1], params[2]),
                      params[3], si, scene.texture_ids("plastic"))
    denom = Vec3.where(params[5] > 0.5, 1.0 - diff * fdr_int, 1.0 - fdr_int)
    return diff / denom, 1.0 / (eta * eta)


def sample(scene, bsdf_idx, si, s1, s2: Vec2):
    params = scene.gather_bsdf_params(bsdf_idx)
    sgn = _side_sign(params, si)
    cos_theta_i = si.wi.z * sgn
    active = cos_theta_i > 0.0
    eta = params[4]
    wi_loc = Vec3(si.wi.x, si.wi.y, si.wi.z * sgn)

    f_i = fresnel_dielectric(cos_theta_i, eta)[0]
    prob_s, prob_d = _probs(f_i, params[6])
    pick_s = (s1 < prob_s) & active

    wo = Vec3.where(pick_s, reflect(wi_loc),
                    square_to_cosine_hemisphere(s2))
    pdf = torch.where(pick_s, prob_s, prob_d * wo.z * m.InvPi)

    spec = Vec3(params[8], params[9], params[10])
    w_spec = spec * m.safe_div(f_i, prob_s)
    # the diffuse weight with internal scattering compensation
    f_o = fresnel_dielectric(wo.z, eta)[0]
    diff_scale, inv_eta_2 = _diffuse_scale(scene, params, si, eta)
    w_diff = diff_scale * m.safe_div(inv_eta_2 * (1.0 - f_i) * (1.0 - f_o),
                                     prob_d)

    weight = Vec3.where(pick_s, w_spec, w_diff)
    wo = Vec3(wo.x, wo.y, wo.z * sgn)
    ok = active & (pdf > 0.0)
    bs = BSDFSample(
        wo=wo, pdf=torch.where(ok, pdf, 0.0),
        eta=torch.ones_like(pdf),
        sampled_type=torch.where(pick_s, 0x0020, 0x0002).to(torch.int32),
        sampled_component=torch.where(pick_s, 0, 1).to(torch.int32))
    return bs, weight.mask(ok)


def eval_pdf(scene, bsdf_idx, si, wo: Vec3):
    params = scene.gather_bsdf_params(bsdf_idx)
    sgn = _side_sign(params, si)
    cos_theta_i = si.wi.z * sgn
    cos_theta_o = wo.z * sgn
    active = (cos_theta_i > 0.0) & (cos_theta_o > 0.0)
    eta = params[4]

    f_i = fresnel_dielectric(cos_theta_i, eta)[0]
    f_o = fresnel_dielectric(cos_theta_o, eta)[0]
    diff_scale, inv_eta_2 = _diffuse_scale(scene, params, si, eta)
    hemi_pdf = torch.clamp(cos_theta_o, min=0.0) * m.InvPi
    value = (diff_scale * (hemi_pdf * inv_eta_2 * (1.0 - f_i)
                           * (1.0 - f_o))).mask(active)
    prob_d = _probs(f_i, params[6])[1]
    return value, torch.where(active, hemi_pdf * prob_d, 0.0)
