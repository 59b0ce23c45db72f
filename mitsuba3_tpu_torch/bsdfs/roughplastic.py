"""Rough plastic — counterpart of ``mitsuba3_tpu/bsdfs/roughplastic.py``.

A GGX or Beckmann specular coat over a diffuse base with internal
scattering compensation. The coat's rough transmittance is fitted at load
(``rough_transmittance.fit``) into the row. Param row: [0:3] diffuse rgb,
[3] texture id, [4] eta, [5] nonlinear flag, [6] specular sampling
weight, [8:11] specular reflectance, [11] alpha, [12] distribution
(0 GGX, 1 Beckmann), [16] two-sided flag, [17:25] the transmittance fit,
[25] the rough internal diffuse reflectance.
"""
from __future__ import annotations

import torch

from ..core import math as m
from ..core.vec import Vec2, Vec3
from ..core.warp import square_to_cosine_hemisphere
from ..render import microfacet as mf
from ..render.fresnel import fresnel_dielectric, reflect_m
from ..render.records import BSDFSample
from ..render.texture import eval_color
from . import rough_transmittance as rtrans
from .plastic import _side_sign

FLAGS = 0x0008 | 0x0002 | 0x2000  # GlossyReflection|DiffuseReflection|Front


def _distr(params, fn, *args):
    """`fn` for the lane's distribution ([12]: 0 GGX, 1 Beckmann)."""
    return mf.per_lane(params[12] > 0.5, fn, *args)


def _probs(t_i, w_s):
    ps = (1.0 - t_i) * w_s
    pd = t_i * (1.0 - w_s)
    ps = m.safe_div(ps, ps + pd)
    return ps, 1.0 - ps


def _fit(params, mu):
    return rtrans.eval_fit([params[17 + k] for k in range(rtrans.N_COEF)],
                           mu)


def _eval_pdf_local(scene, params, si, wi, wo):
    """(value, pdf) in the (possibly mirrored) local frame."""
    eta = params[4]
    alpha = params[11]
    cos_theta_i = wi.z
    cos_theta_o = wo.z
    active = (cos_theta_i > 0.0) & (cos_theta_o > 0.0)

    h = (wi + wo).normalize()
    d = _distr(params, mf.eval_ndf, h, alpha, alpha)
    f = fresnel_dielectric(wi.dot(h), eta)[0]
    g = (_distr(params, mf.smith_g1, wi, h, alpha, alpha)
         * _distr(params, mf.smith_g1, wo, h, alpha, alpha))
    spec = Vec3(params[8], params[9], params[10])
    value = spec * m.safe_div(f * d * g, 4.0 * cos_theta_i)

    t_i = _fit(params, cos_theta_i)
    t_o = _fit(params, cos_theta_o)
    fdr_int = params[25]
    diff = eval_color(scene, Vec3(params[0], params[1], params[2]),
                      params[3], si, scene.texture_ids("roughplastic"))
    denom = Vec3.where(params[5] > 0.5, 1.0 - diff * fdr_int, 1.0 - fdr_int)
    inv_eta_2 = 1.0 / (eta * eta)
    value = value + (diff / denom) * (m.InvPi * inv_eta_2
                                      * torch.clamp(cos_theta_o, min=0.0)
                                      * t_i * t_o)

    prob_s, prob_d = _probs(t_i, params[6])
    pdf_spec = _distr(params, mf.pdf_visible, wi, h, alpha, alpha)
    pdf_spec = pdf_spec * m.safe_div(1.0, 4.0 * wo.dot(h))
    pdf = (prob_s * pdf_spec
           + prob_d * torch.clamp(cos_theta_o, min=0.0) * m.InvPi)
    return value.mask(active), torch.where(active, pdf, 0.0)


def sample(scene, bsdf_idx, si, s1, s2: Vec2):
    params = scene.gather_bsdf_params(bsdf_idx)
    sgn = _side_sign(params, si)
    wi = Vec3(si.wi.x, si.wi.y, si.wi.z * sgn)
    active = wi.z > 0.0
    alpha = params[11]

    prob_s = _probs(_fit(params, wi.z), params[6])[0]
    pick_s = (s1 < prob_s) & active

    mn = _distr(params, mf.sample_visible, wi, s2, alpha, alpha)[0]
    wo = Vec3.where(pick_s, reflect_m(wi, mn),
                    square_to_cosine_hemisphere(s2))

    value, pdf = _eval_pdf_local(scene, params, si, wi, wo)
    ok = active & (pdf > 1e-12)
    inv_pdf = torch.where(ok, 1.0 / torch.clamp(pdf, min=1e-20), 0.0)
    weight = value * inv_pdf
    bs = BSDFSample(
        wo=Vec3(wo.x, wo.y, wo.z * sgn), pdf=torch.where(ok, pdf, 0.0),
        eta=torch.ones_like(pdf),
        sampled_type=torch.where(pick_s, 0x0008, 0x0002).to(torch.int32),
        sampled_component=torch.where(pick_s, 0, 1).to(torch.int32))
    return bs, weight.mask(ok)


def eval_pdf(scene, bsdf_idx, si, wo: Vec3):
    params = scene.gather_bsdf_params(bsdf_idx)
    sgn = _side_sign(params, si)
    wi = Vec3(si.wi.x, si.wi.y, si.wi.z * sgn)
    return _eval_pdf_local(scene, params, si, wi,
                           Vec3(wo.x, wo.y, wo.z * sgn))
