"""Principled (Disney) BSDF — counterpart of
``mitsuba3_tpu/bsdfs/principled.py`` (the reflection side; the thin sheet
is ``principledthin.py``).

Lobes: diffuse with Burley retro-reflection and the flatness (fake
subsurface) term, sheen, a GGX specular lobe with Schlick Fresnel toward
the tinted F0, and the GTR1 clearcoat (Smith alpha 0.25, F0 0.04). The
lobe is picked by `s1` against detached probabilities (specular always,
diffuse by 1 - metallic, clearcoat by 0.25 clearcoat); the weight is
eval / pdf of the mixture.

Param row: [0:3] base_color, [3] texture id, [4] metallic, [5] roughness,
[6] anisotropic, [8] spec_tint, [9] sheen, [10] sheen_tint, [11]
clearcoat, [12] clearcoat_gloss, [13] specular, [14] flatness, [16]
two-sided flag.
"""
from __future__ import annotations

import torch

from ..core import math as m
from ..core.vec import Vec2, Vec3
from ..core.warp import square_to_cosine_hemisphere
from ..render import microfacet as mf
from ..render.records import BSDFSample
from ..render.texture import eval_color
from .diffuse import _side_sign

FLAGS = 0x0002 | 0x0008 | 0x2000  # Diffuse | Glossy | Front


def _schlick_w(cos_t):
    x = torch.clamp(1.0 - cos_t.abs(), 0.0, 1.0)
    x2 = x * x
    return x2 * x2 * x


def _alphas(params):
    rough = torch.clamp(params[5], 0.01, 1.0)
    aspect = torch.sqrt(1.0 - 0.9 * params[6])
    a2 = rough * rough
    return (torch.clamp(a2 / aspect, min=1e-4),
            torch.clamp(a2 * aspect, min=1e-4))


def _gtr1_eval(mn, alpha):
    """The clearcoat NDF (principledhelpers.h GTR1)."""
    a2 = alpha * alpha
    ct2 = mn.z * mn.z
    denom = m.Pi * torch.log(torch.clamp(a2, min=1e-7)) * (
        1.0 + (a2 - 1.0) * ct2)
    return m.safe_div(a2 - 1.0, denom)


def _gtr1_sample(s2: Vec2, alpha):
    a2 = alpha * alpha
    ct2 = m.safe_div(1.0 - torch.pow(torch.clamp(a2, min=1e-7), 1.0 - s2.x),
                     1.0 - a2)
    ct = m.safe_sqrt(torch.clamp(ct2, 0.0, 1.0))
    st = m.safe_sqrt(1.0 - ct * ct)
    phi = m.TwoPi * s2.y
    return Vec3(st * torch.cos(phi), st * torch.sin(phi), ct)


def _clearcoat_alpha(params):
    return 0.1 * (1.0 - params[12]) + 0.001 * params[12]


def _lobe_probs(params):
    """(diffuse, specular, clearcoat) selection probabilities."""
    w_diff = 1.0 - params[4]
    w_cc = 0.25 * params[11]
    total = 1.0 + w_diff + w_cc
    return w_diff / total, 1.0 / total, w_cc / total


def _tint(base: Vec3) -> Vec3:
    lum = 0.212671 * base.x + 0.715160 * base.y + 0.072169 * base.z
    return Vec3(m.safe_div(base.x, lum, 1.0), m.safe_div(base.y, lum, 1.0),
                m.safe_div(base.z, lum, 1.0))


def _eval_pdf_impl(scene, params, si, wi, wo):
    cos_i = wi.z
    cos_o = wo.z
    active = (cos_i > 0.0) & (cos_o > 0.0)

    base = eval_color(scene, Vec3(params[0], params[1], params[2]),
                      params[3], si, scene.texture_ids("principled"))
    metallic, rough = params[4], torch.clamp(params[5], 0.01, 1.0)
    spec_tint, sheen, sheen_tint = params[8], params[9], params[10]
    cc, specular, flatness = params[11], params[13], params[14]

    h = (wi + wo).normalize()
    cos_d = wo.dot(h)

    # diffuse + retro-reflection + flatness (Burley 2015)
    fl = _schlick_w(cos_i)
    fv = _schlick_w(cos_o)
    rr = 2.0 * rough * cos_d * cos_d
    f_retro = rr * (fl + fv + fl * fv * (rr - 1.0))
    f_diff = (1.0 - 0.5 * fl) * (1.0 - 0.5 * fv) + f_retro
    fss90 = rr * 0.5
    fss = (1.0 + (fss90 - 1.0) * fl) * (1.0 + (fss90 - 1.0) * fv)
    f_ss = 1.25 * (fss * (m.safe_div(1.0, cos_i + cos_o) - 0.5) + 0.5)
    diff_mix = (1.0 - flatness) * f_diff + flatness * f_ss
    val_diff = base * (m.InvPi * diff_mix * cos_o * (1.0 - metallic))

    # sheen (products in the JAX package's order)
    tint = _tint(base)
    sheen_col = tint * sheen_tint + (1.0 - sheen_tint)
    x = torch.clamp(1.0 - cos_d.abs(), 0.0, 1.0)
    x2 = x * x
    val_sheen = sheen_col * (sheen * (1.0 - metallic) * x2 * x2 * x * cos_o)

    # specular GGX with the tinted Schlick F0
    au, av = _alphas(params)
    d_spec = mf.eval_ndf(mf.GGX, h, au, av)
    g_spec = (mf.smith_g1(mf.GGX, wi, h, au, av)
              * mf.smith_g1(mf.GGX, wo, h, au, av))
    c_spec0 = (tint * spec_tint + (1.0 - spec_tint)) * (specular * 0.08)
    f0 = c_spec0 * (1.0 - metallic) + base * metallic
    f_spec = f0 + (1.0 - f0) * _schlick_w(cos_d)
    val_spec = f_spec * m.safe_div(d_spec * g_spec, 4.0 * cos_i)

    # clearcoat GTR1
    d_cc = _gtr1_eval(h, _clearcoat_alpha(params))
    g_cc = (mf.smith_g1(mf.GGX, wi, h, 0.25, 0.25)
            * mf.smith_g1(mf.GGX, wo, h, 0.25, 0.25))
    f_cc = 0.04 + (1.0 - 0.04) * x2 * x2 * x
    val_cc = (0.25 * cc) * f_cc * m.safe_div(d_cc * g_cc, 4.0 * cos_i)

    value = val_diff + val_sheen + val_spec + val_cc

    p_diff, p_spec, p_cc = _lobe_probs(params)
    pdf_diff = torch.where(cos_o > 0.0, cos_o, 0.0) * m.InvPi
    inv_jac = m.safe_div(1.0, 4.0 * cos_d.abs())
    pdf_spec = mf.pdf_visible(mf.GGX, wi, h, au, av) * inv_jac
    pdf_cc = (d_cc * h.z).abs() * inv_jac
    pdf = p_diff * pdf_diff + p_spec * pdf_spec + p_cc * pdf_cc
    return value.mask(active), torch.where(active, pdf, 0.0)


def sample(scene, bsdf_idx, si, s1, s2: Vec2):
    params = scene.gather_bsdf_params(bsdf_idx)
    sgn = _side_sign(params, si)
    wi = Vec3(si.wi.x, si.wi.y, si.wi.z * sgn)
    active = wi.z > 0.0
    p_diff, p_spec, _ = _lobe_probs(params)
    pick_diff = s1 < p_diff
    pick_cc = s1 >= (p_diff + p_spec)

    au, av = _alphas(params)
    wo_diff = square_to_cosine_hemisphere(s2)
    mn_spec = mf.sample_visible(mf.GGX, wi, s2, au, av)[0]
    wo_spec = mn_spec * (2.0 * wi.dot(mn_spec)) - wi
    mn_cc = _gtr1_sample(s2, _clearcoat_alpha(params))
    wo_cc = mn_cc * (2.0 * wi.dot(mn_cc)) - wi
    wo = Vec3.where(pick_diff, wo_diff, Vec3.where(pick_cc, wo_cc, wo_spec))

    value, pdf = _eval_pdf_impl(scene, params, si, wi, wo)
    ok = active & (pdf > 1e-9) & (wo.z > 0.0)
    inv_pdf = torch.where(ok, 1.0 / torch.clamp(pdf, min=1e-20), 0.0)
    bs = BSDFSample(
        wo=Vec3(wo.x, wo.y, wo.z * sgn), pdf=torch.where(ok, pdf, 0.0),
        eta=torch.ones_like(pdf),
        sampled_type=torch.where(pick_diff, 0x0002, 0x0008).to(torch.int32),
        sampled_component=torch.where(
            pick_diff, 0, torch.where(pick_cc, 2, 1)).to(torch.int32))
    return bs, (value * inv_pdf).mask(ok)


def eval_pdf(scene, bsdf_idx, si, wo: Vec3):
    params = scene.gather_bsdf_params(bsdf_idx)
    sgn = _side_sign(params, si)
    wi = Vec3(si.wi.x, si.wi.y, si.wi.z * sgn)
    return _eval_pdf_impl(scene, params, si, wi,
                          Vec3(wo.x, wo.y, wo.z * sgn))
