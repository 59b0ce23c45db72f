"""Rough conductor — counterpart of ``mitsuba3_tpu/bsdfs/roughconductor.py``.

Microfacet reflection with visible-normal sampling and Smith shadowing.
Param row: [0:3] eta, [3:6] k, [6] alpha_u, [7] alpha_v, [8:11] specular
reflectance, [11] distribution (0 GGX, 1 Beckmann), [16] two-sided flag.
As in the JAX package, the lobe is GGX whatever [11] says.
"""
from __future__ import annotations

import torch

from ..core import math as m
from ..core.vec import Vec3
from ..render import microfacet as mf
from ..render.fresnel import fresnel_conductor, reflect_m
from ..render.records import BSDFSample

FLAGS = 0x0008 | 0x2000  # GlossyReflection | FrontSide


def _flip(v, sgn):
    return Vec3(v.x, v.y, v.z * sgn)


def _side_sign(params, si):
    return torch.where((params[16] > 0.5) & (si.wi.z < 0.0), -1.0, 1.0)


def sample(scene, bsdf_idx, si, s1, s2):
    params = scene.gather_bsdf_params(bsdf_idx)
    sgn = _side_sign(params, si)
    wi = _flip(si.wi, sgn)
    active = wi.z > 0.0
    alpha_u = params[6]
    alpha_v = params[7]

    mn, pdf_m = mf.sample_visible(mf.GGX, wi, s2, alpha_u, alpha_v)
    wo = reflect_m(wi, mn)
    active = active & (wo.z > 0.0) & (pdf_m > 0.0)

    # VNDF weight: F * G2 / G1 * specular reflectance
    f = fresnel_conductor(wi.dot(mn), Vec3(params[0], params[1], params[2]),
                          Vec3(params[3], params[4], params[5]))
    g2 = mf.G(mf.GGX, wi, wo, mn, alpha_u, alpha_v)
    g1 = mf.smith_g1(mf.GGX, wi, mn, alpha_u, alpha_v)
    spec = Vec3(params[8], params[9], params[10])
    weight = (spec * f * m.safe_div(g2, g1)).mask(active)

    pdf = m.safe_div(pdf_m, 4.0 * wo.dot(mn).abs())
    bs = BSDFSample(
        wo=_flip(wo, sgn),
        pdf=torch.where(active, pdf, 0.0),
        eta=torch.ones_like(pdf),
        sampled_type=torch.full_like(pdf, 0x0008, dtype=torch.int32),
        sampled_component=torch.zeros_like(pdf, dtype=torch.int32))
    return bs, weight


def eval_pdf(scene, bsdf_idx, si, wo):
    params = scene.gather_bsdf_params(bsdf_idx)
    sgn = _side_sign(params, si)
    wi = _flip(si.wi, sgn)
    wo = _flip(wo, sgn)
    cos_theta_i = wi.z
    active = (cos_theta_i > 0.0) & (wo.z > 0.0)
    alpha_u = params[6]
    alpha_v = params[7]

    h = (wi + wo).normalize()
    d = mf.eval_ndf(mf.GGX, h, alpha_u, alpha_v)
    g = mf.G(mf.GGX, wi, wo, h, alpha_u, alpha_v)
    f = fresnel_conductor(wi.dot(h), Vec3(params[0], params[1], params[2]),
                          Vec3(params[3], params[4], params[5]))
    spec = Vec3(params[8], params[9], params[10])

    # the value holds cos_theta_o: f_r cos_o = D F G / (4 cos_i)
    scale = m.safe_div(d * g, 4.0 * cos_theta_i)
    value = (spec * f * scale).mask(active)
    pdf = m.safe_div(d * mf.smith_g1(mf.GGX, wi, h, alpha_u, alpha_v),
                     4.0 * cos_theta_i)
    return value, torch.where(active, pdf, 0.0)
