"""Hair BSDF — counterpart of ``mitsuba3_tpu/bsdfs/hair.py`` (the
Marschner / d'Eon fiber model as pbrt-v3 formulates it: the R, TT and TRT
lobes and a residual, the longitudinal M_p, the trimmed logistic
azimuthal N_p, Fresnel and absorption attenuation A_p).

The fiber axis is the local X axis of the shading frame; the azimuthal
offset across the fiber is taken from the tube's texture coordinate,
h = 2 uv.y - 1, as the JAX package takes it.

Param row: [0] beta_m (longitudinal roughness), [1] beta_n (azimuthal),
[2] scale tilt alpha (degrees), [3] eta, [4:7] sigma_a RGB.
"""
from __future__ import annotations

import torch

from ..core import math as m
from ..core.vec import Vec2, Vec3
from ..render.fresnel import fresnel_dielectric
from ..render.records import BSDFSample

FLAGS = 0x0008 | 0x2000 | 0x4000  # Glossy | FrontSide | BackSide
P_MAX = 3
SQRT_PI_OVER_8 = 0.626657069


def _sincos_theta(w: Vec3):
    """The longitudinal angle to the fiber axis (local X)."""
    sin_t = torch.clamp(w.x, -1.0, 1.0)
    return sin_t, m.safe_sqrt(1.0 - sin_t * sin_t)


def _phi(w: Vec3):
    """The azimuth in the normal plane (Y-Z)."""
    return torch.atan2(w.z, w.y)


def _i0(x):
    """The modified Bessel function I0 (pbrt's series)."""
    val = torch.zeros_like(x)
    x2i = torch.ones_like(x)
    ifact = 1.0
    i4 = 1.0
    for i in range(10):
        if i > 1:
            ifact *= i
        val = val + x2i / (i4 * ifact * ifact)
        x2i = x2i * x * x
        i4 *= 4.0
    return val


def _ipow(x, n: int):
    """x ** n by squaring, in the order of XLA's integer_pow."""
    acc = None
    while n > 0:
        if n & 1:
            acc = x if acc is None else acc * x
        n >>= 1
        if n > 0:
            x = x * x
    return acc


def _log_i0(x):
    """log I0(x); each branch reads only inputs where it is taken (the
    other lanes' values would put an inf into the replay's gradient)."""
    big = x > 12.0
    xb = torch.clamp(x, min=12.0)
    return torch.where(
        big, xb + 0.5 * (-torch.log(torch.full_like(x, 2.0 * m.Pi))
                         + torch.log(1.0 / xb) + 1.0 / (8.0 * xb)),
        torch.log(torch.clamp(_i0(torch.clamp(x, max=12.0)), min=1e-30)))


def _mp(cos_ti, cos_to, sin_ti, sin_to, v):
    """Longitudinal scattering (hair.cpp longitudinal_scattering)."""
    small = v <= 0.1
    a = cos_ti * cos_to / v
    b = sin_ti * sin_to / v
    mp_small = torch.exp(_log_i0(a) - b - 1.0 / v + 0.6931
                         + torch.log(1.0 / (2.0 * v)))
    # the large-v branch on v > 0.1 only, where it is taken: at small v
    # sinh and I0 overflow
    vb = torch.where(small, 1.0, v)
    ab = cos_ti * cos_to / vb
    bb = sin_ti * sin_to / vb
    mp_big = (torch.exp(-bb) * _i0(ab)) / (
        torch.sinh(1.0 / torch.clamp(vb, min=1e-4)) * 2.0 * vb)
    return torch.where(small, mp_small, mp_big)


def _logistic(x, s):
    x = x.abs()
    e = torch.exp(-x / s)
    return e / (s * (1.0 + e) ** 2)


def _logistic_cdf(x, s):
    return 1.0 / (1.0 + torch.exp(-x / s))


def _trimmed_logistic(x, s):
    return _logistic(x, s) / (_logistic_cdf(m.Pi, s)
                              - _logistic_cdf(-m.Pi, s))


def _sample_trimmed_logistic(u, s):
    lo = _logistic_cdf(-m.Pi, s)
    k = _logistic_cdf(m.Pi, s) - lo
    x = -s * torch.log(1.0 / torch.clamp(u * k + lo, 1e-7, 1.0 - 1e-7)
                       - 1.0)
    return torch.clamp(x, -m.Pi, m.Pi)


def _phi_ap(p: int, gamma_i, gamma_t):
    return 2.0 * p * gamma_t - 2.0 * gamma_i + p * m.Pi


def _np(phi, p: int, s, gamma_i, gamma_t):
    dphi = phi - _phi_ap(p, gamma_i, gamma_t)
    # wrapped to [-pi, pi] as jnp.mod wraps: fmod, then the divisor
    # added to a negative remainder
    r = torch.fmod(dphi + m.Pi, 2.0 * m.Pi)
    dphi = torch.where(r < 0.0, r + 2.0 * m.Pi, r) - m.Pi
    return _trimmed_logistic(dphi, s)


def _params_of(scene, bsdf_idx, si):
    pr = scene.gather_bsdf_params(bsdf_idx)
    beta_m = torch.clamp(pr[0], 1e-3, 1.0)
    beta_n = torch.clamp(pr[1], 1e-3, 1.0)
    alpha = pr[2] * (m.Pi / 180.0)
    eta = torch.clamp(pr[3], min=1.0001)
    sigma_a = Vec3(pr[4], pr[5], pr[6])
    # pbrt's roughness -> variance mapping
    t = (0.726 * beta_m + 0.812 * _ipow(beta_m, 2)
         + 3.7 * _ipow(beta_m, 20))
    v0 = t * t
    v = [v0, 0.25 * v0, 4.0 * v0]
    v.append(v[2])
    s = SQRT_PI_OVER_8 * (0.265 * beta_n + 1.194 * _ipow(beta_n, 2)
                          + 5.372 * _ipow(beta_n, 22))
    sin2k = [torch.sin(alpha)]
    cos2k = [torch.cos(alpha)]
    for i in range(1, 3):
        sa, ca = sin2k[i - 1], cos2k[i - 1]
        sin2k.append(2.0 * ca * sa)
        cos2k.append(ca * ca - sa * sa)
    h = torch.clamp(2.0 * si.uv.y - 1.0, -0.999, 0.999)
    return eta, sigma_a, v, s, sin2k, cos2k, h


def _ap(cos_theta_i, eta, h, sigma_a: Vec3):
    """The attenuation of each lobe: [P_MAX + 1] Vec3 (pbrt Ap)."""
    cos_gamma_i = m.safe_sqrt(1.0 - h * h)
    f = fresnel_dielectric(cos_theta_i * cos_gamma_i, eta)[0]
    a0 = Vec3(f, f, f)
    sin_theta_i = m.safe_sqrt(1.0 - cos_theta_i * cos_theta_i)
    sin_theta_t = sin_theta_i / eta
    cos_theta_t = m.safe_sqrt(1.0 - sin_theta_t * sin_theta_t)
    etap = m.safe_sqrt(torch.clamp(eta * eta - sin_theta_i * sin_theta_i,
                                   min=1e-9)) / torch.clamp(cos_theta_i,
                                                            min=1e-4)
    sin_gamma_t = torch.clamp(h / etap, -1.0, 1.0)
    cos_gamma_t = m.safe_sqrt(1.0 - sin_gamma_t * sin_gamma_t)
    tr = (sigma_a * (-2.0 * cos_gamma_t
                     / torch.clamp(cos_theta_t, min=1e-4))).exp()
    a1 = tr * ((1.0 - f) * (1.0 - f))
    a2 = a1 * tr * f
    # the residual: a1 (tr f)^2 / (1 - tr f)
    trf = tr * f
    a3 = Vec3(*(getattr(a2, c) * getattr(trf, c)
                / torch.clamp(1.0 - getattr(trf, c), min=1e-5)
                for c in "xyz"))
    return [a0, a1, a2, a3]


def _ap_pdf(cos_theta_i, eta, h, sigma_a):
    ap = _ap(cos_theta_i, eta, h, sigma_a)
    lums = [0.212671 * a.x + 0.715160 * a.y + 0.072169 * a.z for a in ap]
    total = torch.clamp(sum(lums), min=1e-9)
    return [lum / total for lum in lums], ap


def _reframe(sin_ti, cos_ti, p: int, sin2k, cos2k):
    """The scale-tilt reframing of each lobe (hair.cpp
    reframe_with_scales)."""
    if p == 0:
        return (sin_ti * cos2k[1] - cos_ti * sin2k[1],
                cos_ti * cos2k[1] + sin_ti * sin2k[1])
    if p == 1:
        return (sin_ti * cos2k[0] + cos_ti * sin2k[0],
                cos_ti * cos2k[0] - sin_ti * sin2k[0])
    if p == 2:
        return (sin_ti * cos2k[2] + cos_ti * sin2k[2],
                cos_ti * cos2k[2] - sin_ti * sin2k[2])
    return sin_ti, cos_ti


def _gammas(sin_ti, cos_ti, eta, h):
    """(gamma_i, gamma_t): the azimuths of entry and of refraction."""
    etap = m.safe_sqrt(torch.clamp(eta * eta - sin_ti * sin_ti, min=1e-9)) \
        / torch.clamp(cos_ti, min=1e-4)
    sin_gamma_t = torch.clamp(h / etap, -1.0, 1.0)
    return torch.asin(h), torch.asin(sin_gamma_t)


def _eval_pdf_impl(params, si, wo):
    eta, sigma_a, v, s, sin2k, cos2k, h = params
    wi = si.wi
    sin_ti, cos_ti = _sincos_theta(wi)
    sin_to, cos_to = _sincos_theta(wo)
    gamma_i, gamma_t = _gammas(sin_ti, cos_ti, eta, h)
    phi = _phi(wo) - _phi(wi)

    apdf, ap = _ap_pdf(cos_ti, eta, h, sigma_a)
    value = Vec3.zeros(cos_ti.shape[0], cos_ti.device)
    pdf = torch.zeros_like(cos_ti)
    for p in range(P_MAX + 1):
        sin_tip, cos_tip = _reframe(sin_ti, cos_ti, p, sin2k, cos2k)
        mp = _mp(cos_tip.abs(), cos_to, sin_tip, sin_to, v[min(p, 3)])
        if p < P_MAX:
            npv = _np(phi, p, s, gamma_i, gamma_t)
        else:
            npv = torch.full_like(phi, 1.0 / (2.0 * m.Pi))
        value = value + ap[p] * (mp * npv)
        pdf = pdf + apdf[p] * mp * npv
    # f * cos, as pbrt's fsum before its division by |cos_theta_o|
    return value, pdf


def eval_pdf(scene, bsdf_idx, si, wo: Vec3):
    value, pdf = _eval_pdf_impl(_params_of(scene, bsdf_idx, si), si, wo)
    ok = torch.isfinite(pdf) & (pdf > 0.0)
    return value.mask(ok), torch.where(ok, pdf, 0.0)


def sample(scene, bsdf_idx, si, s1, s2: Vec2):
    params = _params_of(scene, bsdf_idx, si)
    eta, sigma_a, v, s, sin2k, cos2k, h = params
    wi = si.wi
    sin_ti, cos_ti = _sincos_theta(wi)
    gamma_i, gamma_t = _gammas(sin_ti, cos_ti, eta, h)

    # the lobe from the attenuation pdf, `s1` rescaled (hair.cpp:238-249)
    apdf = _ap_pdf(cos_ti, eta, h, sigma_a)[0]
    p_sel = torch.zeros_like(s1, dtype=torch.int32)
    u_re = torch.clamp(m.safe_div(s1, apdf[0]), 0.0, 1.0)
    acc = apdf[0]
    for i in range(1, P_MAX + 1):
        pick = s1 >= acc
        p_sel = torch.where(pick, i, p_sel)
        u_re = torch.where(pick, torch.clamp(
            m.safe_div(s1 - acc, apdf[i]), 0.0, 1.0), u_re)
        acc = acc + apdf[i]

    sin_tip, cos_tip = sin_ti, cos_ti
    for p in range(P_MAX + 1):
        sp, cp = _reframe(sin_ti, cos_ti, p, sin2k, cos2k)
        sel = p_sel == p
        sin_tip = torch.where(sel, sp, sin_tip)
        cos_tip = torch.where(sel, cp.abs(), cos_tip)
    vp = v[3]
    for p in range(P_MAX):
        vp = torch.where(p_sel == p, v[p], vp)

    # the longitudinal angle (hair.cpp:256-266)
    u10 = s2.x
    cos_theta = 1.0 + vp * torch.log(torch.clamp(
        u10 + (1.0 - u10) * torch.exp(-2.0 / torch.clamp(vp, min=1e-6)),
        1e-30, 1.0))
    cos_theta = torch.clamp(cos_theta, -1.0, 1.0)
    sin_theta = m.safe_sqrt(1.0 - cos_theta * cos_theta)
    cos_phi_l = torch.cos(2.0 * m.Pi * s2.y)
    sin_to = -cos_theta * sin_tip + sin_theta * cos_phi_l * cos_tip
    cos_to = m.safe_sqrt(1.0 - sin_to * sin_to)

    # the azimuth
    dphi = torch.zeros_like(s1)
    for p in range(P_MAX):
        dphi = torch.where(p_sel == p, _phi_ap(p, gamma_i, gamma_t)
                           + _sample_trimmed_logistic(u_re, s), dphi)
    dphi = torch.where(p_sel == P_MAX, 2.0 * m.Pi * u_re, dphi)
    phi_o = _phi(wi) + dphi
    wo = Vec3(sin_to, cos_to * torch.cos(phi_o), cos_to * torch.sin(phi_o))

    value, pdf = _eval_pdf_impl(params, si, wo)
    ok = torch.isfinite(pdf) & (pdf > 1e-9)
    inv = torch.where(ok, 1.0 / torch.clamp(pdf, min=1e-20), 0.0)
    bs = BSDFSample(
        wo=wo, pdf=torch.where(ok, pdf, 0.0), eta=torch.ones_like(pdf),
        sampled_type=torch.full_like(p_sel, 0x0008), sampled_component=p_sel)
    return bs, (value * inv).mask(ok)
