"""Rough dielectric directional transmittance — counterpart of
``mitsuba3_tpu/bsdfs/rough_transmittance.py`` (a copy: the port imports
nothing of the JAX package).

Host-side (NumPy, at scene load): for a microfacet coat with a given
(eta, alpha, distribution), the directional reflectance

    R(mu_i) = \\int_hemi D(h) F(wi.h, eta) G(wi, wo, h) / (4 mu_i) dwo

is integrated with Gauss-Legendre quadrature; T = 1 - R is then fitted
as a degree-7 polynomial in sqrt(mu). The renderer evaluates the fit per
lane from the flat bsdf_params row (``eval_fit``). The internal-scattering
compensation constant is fdr = 2 \\int R_int(mu) mu dmu with the inverted
IOR. ``fit`` is the JAX package's, line for line, so the rows it fills
are bit-equal.
"""
from __future__ import annotations

import numpy as np

N_COEF = 8


def _ndf(cos_h, alpha, beckmann):
    c2 = np.clip(cos_h, 1e-9, 1.0) ** 2
    t2 = (1.0 - c2) / c2
    a2 = alpha * alpha
    if beckmann:
        return np.exp(-t2 / a2) / (np.pi * a2 * c2 * c2)
    return a2 / (np.pi * c2 * c2 * (a2 + t2) ** 2)


def _smith_g1(cos_v, alpha, beckmann):
    cos_v = np.clip(cos_v, 1e-9, 1.0)
    t = np.sqrt(1.0 - cos_v * cos_v) / cos_v
    if beckmann:
        a = 1.0 / np.maximum(alpha * t, 1e-9)
        g = np.where(a >= 1.6, 1.0,
                     (3.535 * a + 2.181 * a * a)
                     / (1.0 + 2.276 * a + 2.577 * a * a))
        return g
    a2 = alpha * alpha
    return 2.0 / (1.0 + np.sqrt(1.0 + a2 * t * t))


def _fresnel(cos_i, eta):
    cos_i = np.clip(cos_i, 0.0, 1.0)
    st2 = (1.0 - cos_i * cos_i) / (eta * eta)
    tir = st2 > 1.0
    cos_t = np.sqrt(np.maximum(1.0 - st2, 0.0))
    rs = (cos_i - eta * cos_t) / np.maximum(cos_i + eta * cos_t, 1e-12)
    rp = (eta * cos_i - cos_t) / np.maximum(eta * cos_i + cos_t, 1e-12)
    return np.where(tir, 1.0, 0.5 * (rs * rs + rp * rp))


def directional_reflectance(mu_i, eta, alpha, beckmann,
                            n_theta=64, n_phi=64):
    """Hemispherical reflectance of the rough coat for incidence cosine
    mu_i (vectorized over mu_i)."""
    mu_i = np.atleast_1d(np.asarray(mu_i, np.float64))
    if alpha < 1e-3:
        return _fresnel(mu_i, eta)
    xt, wt = np.polynomial.legendre.leggauss(n_theta)
    th = (xt + 1.0) * (np.pi / 4.0)           # theta_o in (0, pi/2)
    wth = wt * (np.pi / 4.0)
    xp, wp = np.polynomial.legendre.leggauss(n_phi)
    ph = (xp + 1.0) * np.pi                   # phi in (0, 2 pi)
    wph = wp * np.pi

    si = np.sqrt(np.maximum(1.0 - mu_i**2, 0.0))
    wi = np.stack([si, np.zeros_like(mu_i), mu_i], -1)      # [M, 3]
    st, ct = np.sin(th), np.cos(th)
    wo = np.stack([np.outer(st, np.cos(ph)),
                   np.outer(st, np.sin(ph)),
                   np.outer(ct, np.ones_like(ph))], -1)     # [T, P, 3]

    h = wi[:, None, None, :] + wo[None, :, :, :]
    h /= np.linalg.norm(h, axis=-1, keepdims=True)
    cos_h = np.clip(h[..., 2], 0.0, 1.0)
    wih = np.clip(np.einsum("mi,mtpi->mtp", wi, h), 0.0, 1.0)
    d = _ndf(cos_h, alpha, beckmann)
    f = _fresnel(wih, eta)
    g = (_smith_g1(mu_i, alpha, beckmann)[:, None, None]
         * _smith_g1(ct, alpha, beckmann)[None, :, None])
    integrand = d * f * g / (4.0 * mu_i[:, None, None])
    # dwo = sin(theta) dtheta dphi
    w2d = (wth[:, None] * st[:, None]) * wph[None, :]
    return np.einsum("mtp,tp->m", integrand, w2d)


def fit(eta, alpha, beckmann):
    """-> (coeffs [N_COEF] of T(mu) in u = sqrt(mu), fdr_internal)."""
    mu = 0.5 - 0.5 * np.cos(np.pi * (np.arange(48) + 0.5) / 48)
    mu = np.clip(mu, 5e-3, 1.0)
    t_ext = np.clip(1.0 - directional_reflectance(mu, eta, alpha,
                                                  beckmann), 0.0, 1.0)
    u = np.sqrt(mu)
    v = np.vander(u, N_COEF, increasing=True)
    coeffs, *_ = np.linalg.lstsq(v, t_ext, rcond=None)

    # rough internal diffuse reflectance: 2 int R_int(mu) mu dmu
    xg, wg = np.polynomial.legendre.leggauss(24)
    mu_g = (xg + 1.0) * 0.5
    r_int = directional_reflectance(np.clip(mu_g, 5e-3, 1.0),
                                    1.0 / eta, alpha, beckmann)
    fdr = float(np.sum(2.0 * r_int * mu_g * (wg * 0.5)))
    return coeffs.astype(np.float32), np.float32(np.clip(fdr, 0.0, 1.0))


def eval_fit(coeffs_rows, mu):
    """Horner evaluation: coeffs_rows is [N_COEF] per-lane rows ([N] each),
    mu [N] -> T [N] clamped to [0, 1]."""
    import torch
    u = torch.sqrt(torch.clamp(mu, 0.0, 1.0))
    acc = coeffs_rows[N_COEF - 1]
    for k in range(N_COEF - 2, -1, -1):
        acc = acc * u + coeffs_rows[k]
    return torch.clamp(acc, 0.0, 1.0)
