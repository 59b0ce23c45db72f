"""Thin principled (Disney) BSDF — counterpart of
``mitsuba3_tpu/bsdfs/principledthin.py``.

A symmetric thin sheet: diffuse reflection (Burley retro, the flatness
term, sheen), GGX specular reflection with the thin Fresnel, GGX specular
transmission (the reflection lobe mirrored to the other side, with
IOR-scaled roughness) and Lambertian diffuse transmission. Sampling picks
one of the four lobes by `s1`; the weight is eval / pdf of the mixture.

Param row: [0:3] base_color, [3] texture id, [4] spec_trans, [5]
roughness, [6] anisotropic, [7] eta, [8] spec_tint, [9] sheen, [10]
sheen_tint, [11] diff_trans (in [0, 2]), [12] flatness.
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
from .principled import _schlick_w, _tint

DIFFUSE_REFLECTION = 0x0002
DIFFUSE_TRANSMISSION = 0x0004
GLOSSY_REFLECTION = 0x0008
GLOSSY_TRANSMISSION = 0x0010
FLAGS = (DIFFUSE_REFLECTION | DIFFUSE_TRANSMISSION | GLOSSY_REFLECTION
         | GLOSSY_TRANSMISSION | 0x2000 | 0x4000)


def _alphas(rough, aniso):
    aspect = torch.sqrt(1.0 - 0.9 * aniso)
    a2 = torch.clamp(rough, 0.01, 1.0) ** 2
    return (torch.clamp(a2 / aspect, min=1e-4),
            torch.clamp(a2 * aspect, min=1e-4))


def _lobes(params):
    """(spec_trans, rough, aniso, eta, diff_trans) as the lobes read them."""
    return (torch.clamp(params[4], 0.0, 1.0),
            torch.clamp(params[5], 0.01, 1.0), params[6],
            torch.clamp(params[7], min=1.01),
            torch.clamp(params[11], 0.0, 2.0) * 0.5)


def _probs(spec_trans, diff_trans):
    """The four lobes' selection probabilities (sr, st, dr, dt)."""
    p_sr = spec_trans * 0.5
    p_st = spec_trans * 0.5
    p_dr = (1.0 - spec_trans) * (1.0 - diff_trans)
    p_dt = (1.0 - spec_trans) * diff_trans
    total = torch.clamp(p_sr + p_st + p_dr + p_dt, min=1e-9)
    return p_sr / total, p_st / total, p_dr / total, p_dt / total


def _eval_pdf_thin(scene, params, si, wi: Vec3, wo_t: Vec3):
    """Both directions already mirrored to the front side (wi.z > 0)."""
    base = eval_color(scene, Vec3(params[0], params[1], params[2]),
                      params[3], si, scene.texture_ids("principledthin"))
    spec_trans, rough, aniso, eta_t, diff_trans = _lobes(params)
    spec_tint, sheen, sheen_tint = params[8], params[9], params[10]
    flatness = params[12]

    cos_i = wi.z
    cos_o = wo_t.z
    refl = cos_o > 0.0
    refr = cos_o < 0.0

    # the half vector of wo's reflected image, for both specular lobes
    wo_r = Vec3(wo_t.x, wo_t.y, wo_t.z.abs())
    wh = (wi + wo_r).normalize()
    cos_d = wo_r.dot(wh)
    compat_r = (wi.dot(wh) > 0.0) & (wo_t.dot(wh) > 0.0)
    compat_t = (wi.dot(wh) > 0.0) & (wo_t.dot(-wh) > 0.0)
    value = Vec3.zeros(cos_i.shape[0], cos_i.device)

    # specular reflection with the thin Fresnel
    f_diel = fresnel_dielectric(wi.dot(wh), eta_t)[0]
    au, av = _alphas(rough, aniso)
    d_r = mf.eval_ndf(mf.GGX, wh, au, av)
    g_r = (mf.smith_g1(mf.GGX, wi, wh, au, av)
           * mf.smith_g1(mf.GGX, wo_r, wh, au, av))
    tint = _tint(base)
    r0 = ((eta_t - 1.0) / (eta_t + 1.0)) ** 2
    f0_tint = tint * r0
    f_schlick = f0_tint + (1.0 - f0_tint) * _schlick_w(wi.dot(wh))
    f_thin = f_schlick * spec_tint + f_diel * (1.0 - spec_tint)
    v_sr = f_thin * m.safe_div(spec_trans * d_r * g_r, 4.0 * cos_i)
    value = Vec3.where(refl & compat_r, value + v_sr, value)

    # specular transmission
    rough_s = torch.clamp((0.65 * eta_t - 0.35) * rough, 0.01, 1.0)
    aus, avs = _alphas(rough_s, aniso)
    d_t = mf.eval_ndf(mf.GGX, wh, aus, avs)
    g_t = (mf.smith_g1(mf.GGX, wi, wh, aus, avs)
           * mf.smith_g1(mf.GGX, wo_r, wh, aus, avs))
    v_st = base * m.safe_div(spec_trans * (1.0 - f_diel) * d_t * g_t,
                             4.0 * cos_i)
    value = Vec3.where(refr & compat_t, value + v_st, value)

    # diffuse reflection + retro + flatness + sheen
    fo = _schlick_w(cos_o)
    fi = _schlick_w(cos_i)
    f_diff = (1.0 - 0.5 * fi) * (1.0 - 0.5 * fo)
    cos_td = wh.dot(wo_t)
    rr = 2.0 * rough * cos_td * cos_td
    f_retro = rr * (fo + fi + fo * fi * (rr - 1.0))
    fss90 = 0.5 * rr
    fss = (1.0 + (fss90 - 1.0) * fo) * (1.0 + (fss90 - 1.0) * fi)
    f_ss = 1.25 * (fss * (m.safe_div(1.0, cos_o.abs() + cos_i.abs())
                          - 0.5) + 0.5)
    diff_mix = (1.0 - flatness) * (f_diff + f_retro) + flatness * f_ss
    v_dr = base * ((1.0 - spec_trans) * (1.0 - diff_trans) * m.InvPi
                   * diff_mix * cos_o)
    sheen_col = tint * sheen_tint + (1.0 - sheen_tint)
    v_sheen = sheen_col * (sheen * (1.0 - spec_trans) * (1.0 - diff_trans)
                           * _schlick_w(cos_td) * cos_o.abs())
    value = Vec3.where(refl, value + v_dr + v_sheen, value)

    # Lambertian diffuse transmission
    v_dt = base * ((1.0 - spec_trans) * diff_trans * m.InvPi * cos_o.abs())
    value = Vec3.where(refr, value + v_dt, value)

    p_sr, p_st, p_dr, p_dt = _probs(spec_trans, diff_trans)
    dwh_dwo = m.safe_div(1.0, 4.0 * cos_d.abs())
    pdf_sr = mf.pdf_visible(mf.GGX, wi, wh, au, av) * dwh_dwo
    pdf_st = mf.pdf_visible(mf.GGX, wi, wh, aus, avs) * dwh_dwo
    pdf = torch.where(refl & compat_r, p_sr * pdf_sr, 0.0)
    pdf = pdf + torch.where(refr & compat_t, p_st * pdf_st, 0.0)
    pdf = pdf + torch.where(refl, p_dr * cos_o.abs() * m.InvPi, 0.0)
    pdf = pdf + torch.where(refr, p_dt * cos_o.abs() * m.InvPi, 0.0)

    active = (cos_i > 0.0) & (cos_o != 0.0)
    return value.mask(active), torch.where(active, pdf, 0.0)


def _flip(si):
    """The sheet is symmetric: mirror the frame so that wi.z > 0."""
    sgn = torch.where(si.wi.z >= 0.0, 1.0, -1.0)
    return Vec3(si.wi.x, si.wi.y, si.wi.z * sgn), sgn


def sample(scene, bsdf_idx, si, s1, s2: Vec2):
    params = scene.gather_bsdf_params(bsdf_idx)
    wi, sgn = _flip(si)
    spec_trans, rough, aniso, eta_t, diff_trans = _lobes(params)
    p_sr, p_st, p_dr, _ = _probs(spec_trans, diff_trans)
    c1, c2 = p_sr, p_sr + p_st
    c3 = c2 + p_dr

    au, av = _alphas(rough, aniso)
    rough_s = torch.clamp((0.65 * eta_t - 0.35) * rough, 0.01, 1.0)
    aus, avs = _alphas(rough_s, aniso)
    wo_sr = reflect_m(wi, mf.sample_visible(mf.GGX, wi, s2, au, av)[0])
    wo_st_r = reflect_m(wi, mf.sample_visible(mf.GGX, wi, s2, aus, avs)[0])
    wo_st = Vec3(wo_st_r.x, wo_st_r.y, -wo_st_r.z.abs())
    wo_d = square_to_cosine_hemisphere(s2)
    wo_dt = Vec3(wo_d.x, wo_d.y, -wo_d.z)

    pick_sr = s1 < c1
    pick_st = (s1 >= c1) & (s1 < c2)
    pick_dr = (s1 >= c2) & (s1 < c3)
    wo_t = Vec3.where(pick_sr, wo_sr, Vec3.where(
        pick_st, wo_st, Vec3.where(pick_dr, wo_d, wo_dt)))
    value, pdf = _eval_pdf_thin(scene, params, si, wi, wo_t)
    ok = (wi.z > 0.0) & (pdf > 1e-9)
    stype = torch.where(pick_sr, GLOSSY_REFLECTION, torch.where(
        pick_st, GLOSSY_TRANSMISSION, torch.where(
            pick_dr, DIFFUSE_REFLECTION, DIFFUSE_TRANSMISSION)))
    bs = BSDFSample(
        wo=Vec3(wo_t.x, wo_t.y, wo_t.z * sgn), pdf=torch.where(ok, pdf, 0.0),
        eta=torch.ones_like(s1), sampled_type=stype.to(torch.int32),
        sampled_component=torch.zeros_like(s1, dtype=torch.int32))
    return bs, (value * m.safe_div(1.0, pdf)).mask(ok)


def eval_pdf(scene, bsdf_idx, si, wo: Vec3):
    params = scene.gather_bsdf_params(bsdf_idx)
    wi, sgn = _flip(si)
    return _eval_pdf_thin(scene, params, si, wi,
                          Vec3(wo.x, wo.y, wo.z * sgn))
