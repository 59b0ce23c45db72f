"""Rough dielectric — counterpart of
``mitsuba3_tpu/bsdfs/roughdielectric.py``.

Microfacet reflection and refraction with visible-normal sampling and a
Fresnel-weighted lobe choice. Param row: [0] eta, [1] alpha_u,
[2] alpha_v, [3] distribution (0 GGX, 1 Beckmann), [4:7] specular
reflectance, [7:10] specular transmittance.
"""
from __future__ import annotations

import torch

from ..core import math as m
from ..core.vec import Vec3
from ..render import microfacet as mf
from ..render.fresnel import fresnel_dielectric, reflect_m, refract_m
from ..render.records import BSDFSample

FLAGS = 0x0008 | 0x0010 | 0x2000 | 0x4000  # GlossyR|GlossyT|Front|Back


def _mulsign(v: Vec3, s):
    sgn = torch.where(s >= 0.0, 1.0, -1.0)
    return Vec3(v.x * sgn, v.y * sgn, v.z * sgn)


def _distr_eval(params, fn, *args):
    """`fn` for the lane's distribution ([3]: 0 GGX, 1 Beckmann)."""
    return mf.per_lane(params[3] > 0.5, fn, *args)


def sample(scene, bsdf_idx, si, s1, s2):
    params = scene.gather_bsdf_params(bsdf_idx)
    eta = params[0]
    au, av = params[1], params[2]
    cos_theta_i = si.wi.z
    active = cos_theta_i != 0.0

    wi_up = _mulsign(si.wi, cos_theta_i)
    mn, pdf_m = _distr_eval(params, mf.sample_visible, wi_up, s2, au, av)
    active = active & (pdf_m > 0.0)

    f, cos_theta_t, eta_it, eta_ti = fresnel_dielectric(si.wi.dot(mn), eta)
    sel_r = s1 <= f
    pdf = pdf_m * torch.where(sel_r, f, 1.0 - f)

    wo = Vec3.where(sel_r, reflect_m(si.wi, mn),
                    refract_m(si.wi, mn, cos_theta_t, eta_ti))
    bs_eta = torch.where(sel_r, 1.0, eta_it)

    # half-direction Jacobians
    dwh_dwo_r = m.safe_div(1.0, 4.0 * wo.dot(mn))
    denom_t = si.wi.dot(mn) + bs_eta * wo.dot(mn)
    dwh_dwo_t = m.safe_div(m.sqr(bs_eta) * wo.dot(mn), m.sqr(denom_t))
    pdf = pdf * torch.where(sel_r, dwh_dwo_r, dwh_dwo_t).abs()

    # the VNDF weight is G1(wo)
    g1_o = _distr_eval(params, mf.smith_g1, wo, mn, au, av)
    spec_r = Vec3(params[4], params[5], params[6])
    spec_t = Vec3(params[7], params[8], params[9]) * (eta_ti * eta_ti)
    weight = Vec3.where(sel_r, spec_r, spec_t) * g1_o

    active = active & (pdf > 1e-12)
    bs = BSDFSample(
        wo=wo, pdf=torch.where(active, pdf, 0.0), eta=bs_eta,
        sampled_type=torch.where(sel_r, 0x0008, 0x0010).to(torch.int32),
        sampled_component=torch.where(sel_r, 0, 1).to(torch.int32))
    return bs, weight.mask(active)


def eval_pdf(scene, bsdf_idx, si, wo):
    params = scene.gather_bsdf_params(bsdf_idx)
    eta0 = params[0]
    au, av = params[1], params[2]
    cos_theta_i = si.wi.z
    cos_theta_o = wo.z
    active = cos_theta_i != 0.0
    is_reflect = cos_theta_i * cos_theta_o > 0.0

    outside = cos_theta_i > 0.0
    eta = torch.where(outside, eta0, 1.0 / eta0)
    inv_eta = torch.where(outside, 1.0 / eta0, eta0)

    mn = (si.wi + wo * torch.where(is_reflect, 1.0, eta)).normalize()
    mn = _mulsign(mn, mn.z)

    d = _distr_eval(params, mf.eval_ndf, mn, au, av)
    f = fresnel_dielectric(si.wi.dot(mn), eta0)[0]
    g = (_distr_eval(params, mf.smith_g1, si.wi, mn, au, av)
         * _distr_eval(params, mf.smith_g1, wo, mn, au, av))

    spec_r = Vec3(params[4], params[5], params[6])
    spec_t = Vec3(params[7], params[8], params[9])
    val_r = f * d * g / (4.0 * cos_theta_i.abs())
    denom = si.wi.dot(mn) + eta * wo.dot(mn)
    val_t = m.safe_div(
        m.sqr(inv_eta) * (1.0 - f) * d * g * m.sqr(eta)
        * si.wi.dot(mn) * wo.dot(mn), cos_theta_i * m.sqr(denom)).abs()
    value = Vec3.where(is_reflect, spec_r * val_r, spec_t * val_t)

    # the VNDF pdf times the lobe probability times the Jacobian
    side_ok = ((si.wi.dot(mn) * cos_theta_i > 0.0)
               & (wo.dot(mn) * cos_theta_o > 0.0))
    dwh_dwo = torch.where(is_reflect, m.safe_div(1.0, 4.0 * wo.dot(mn)),
                          m.safe_div(m.sqr(eta) * wo.dot(mn), m.sqr(denom)))
    pdf_m = _distr_eval(params, mf.pdf_visible, _mulsign(si.wi, cos_theta_i),
                        mn, au, av)
    pdf = pdf_m * torch.where(is_reflect, f, 1.0 - f) * dwh_dwo.abs()

    ok = active & side_ok
    return value.mask(ok), torch.where(ok, pdf, 0.0)
