"""Fresnel equations — counterpart of ``mitsuba3_tpu/render/fresnel.py``.

Dielectric Fresnel (with total internal reflection bookkeeping) and
complex conductor Fresnel, component-SoA: scalar arguments are ``[N]``
tensors; colour arguments (a conductor's eta and k) are Vec3.
"""
from __future__ import annotations

import torch

from ..core import math as m
from ..core.vec import Vec3


def fresnel_dielectric(cos_theta_i, eta):
    """-> (r, cos_theta_t, eta_it, eta_ti) for the relative IOR
    eta = n_transmitted / n_incident ([N]); cos_theta_i < 0 is a ray hitting
    from inside."""
    outside = cos_theta_i >= 0.0
    rcp_eta = 1.0 / eta
    eta_it = torch.where(outside, eta, rcp_eta)
    eta_ti = torch.where(outside, rcp_eta, eta)

    cos_theta_t_sqr = 1.0 - (1.0 - cos_theta_i * cos_theta_i) * (eta_ti
                                                                 * eta_ti)
    abs_cos_i = cos_theta_i.abs()
    cos_theta_t = m.safe_sqrt(cos_theta_t_sqr)

    a_s = m.safe_div(abs_cos_i - eta_it * cos_theta_t,
                     abs_cos_i + eta_it * cos_theta_t)
    a_p = m.safe_div(eta_it * abs_cos_i - cos_theta_t,
                     eta_it * abs_cos_i + cos_theta_t)
    r = 0.5 * (a_s * a_s + a_p * a_p)
    tir = cos_theta_t_sqr <= 0.0
    r = torch.where(tir, 1.0, r)
    r = torch.where(eta == 1.0, 0.0, r)
    cos_theta_t = torch.where(tir, 0.0, cos_theta_t) * -m.sign(cos_theta_i)
    return r, cos_theta_t, eta_it, eta_ti


def _fresnel_conductor_1(cos_theta_i, eta_re, eta_im):
    ct2 = cos_theta_i * cos_theta_i
    st2 = 1.0 - ct2
    e2_re = eta_re * eta_re - eta_im * eta_im
    e2_im = 2.0 * eta_re * eta_im
    t0_re = e2_re - st2
    t0_im = e2_im
    mag = m.safe_sqrt(t0_re * t0_re + t0_im * t0_im)
    a2_re = m.safe_sqrt(0.5 * (mag + t0_re))
    a2_im = m.safe_sqrt(0.5 * (mag - t0_re))
    a2_im = torch.where(t0_im < 0.0, -a2_im, a2_im)
    num_re = a2_re - cos_theta_i
    den_re = a2_re + cos_theta_i
    rs = (num_re * num_re + a2_im * a2_im) / (den_re * den_re
                                              + a2_im * a2_im)
    b_re = e2_re * cos_theta_i
    b_im = e2_im * cos_theta_i
    nr = b_re - a2_re
    ni = b_im - a2_im
    dr = b_re + a2_re
    di = b_im + a2_im
    rp = (nr * nr + ni * ni) / (dr * dr + di * di)
    return 0.5 * (rs + rp)


def fresnel_conductor(cos_theta_i, eta: Vec3, k: Vec3) -> Vec3:
    """Unpolarized reflectance of a conductor of complex IOR eta + i k,
    per RGB channel."""
    return Vec3(_fresnel_conductor_1(cos_theta_i, eta.x, k.x),
                _fresnel_conductor_1(cos_theta_i, eta.y, k.y),
                _fresnel_conductor_1(cos_theta_i, eta.z, k.z))


def reflect(wi: Vec3) -> Vec3:
    """Local-frame mirror reflection about +z."""
    return Vec3(-wi.x, -wi.y, wi.z)


def reflect_m(wi: Vec3, mn: Vec3) -> Vec3:
    """Reflection about a micro-normal m."""
    return mn * (2.0 * wi.dot(mn)) - wi


def refract(wi: Vec3, cos_theta_t, eta_ti) -> Vec3:
    """Local-frame refraction about +z."""
    return Vec3(-eta_ti * wi.x, -eta_ti * wi.y, cos_theta_t)


def refract_m(wi: Vec3, mn: Vec3, cos_theta_t, eta_ti) -> Vec3:
    """Refraction about a micro-normal m."""
    dp = wi.dot(mn)
    return mn * (dp * eta_ti + cos_theta_t) - wi * eta_ti


# Named IOR presets (ior.h data): real and imaginary parts at the RGB
# primaries; the loader reads them by a conductor's `material`
CONDUCTOR_IOR = {
    "Au": ((0.143119, 0.374957, 1.44248), (3.98316, 2.38572, 1.60322)),
    "Ag": ((0.155184, 0.116677, 0.138372), (4.82807, 3.12227, 2.14606)),
    "Al": ((1.6547, 0.880369, 0.521229), (9.22377, 6.26937, 4.83701)),
    "Cu": ((0.200438, 0.924033, 1.10221), (3.91295, 2.44763, 2.14219)),
    "none": ((0.0, 0.0, 0.0), (1.0, 1.0, 1.0)),  # perfect mirror
}


def fresnel_diffuse_reflectance(eta):
    """Average Fresnel reflectance for diffuse illumination (Egan-Hilgeman
    fit below eta 1, d'Eon-Irving above)."""
    inv_eta = 1.0 / eta
    approx_1 = 0.0636 * inv_eta + eta * (eta * -1.4399 + 0.7099) + 0.6681
    approx_2 = (0.919317 + inv_eta * (-3.4793 + inv_eta * (
        6.75335 + inv_eta * (-7.80989 + inv_eta * (4.98554
                                                   + inv_eta * -1.36881)))))
    return torch.where(eta < 1.0, approx_1, approx_2)
