"""Smooth dielectric — counterpart of ``mitsuba3_tpu/bsdfs/dielectric.py``.

Delta reflection and refraction with Fresnel-weighted lobe selection.
Param row: [0] eta (int_ior / ext_ior), [1:4] specular reflectance,
[4:7] specular transmittance, [8] the Cauchy dispersion coefficient B
[um^2]: in the spectral variant eta(lambda) = eta + B (1 / lambda^2 -
1 / lambda_d^2) at the hero wavelength, which the refraction follows; the
other two wavelengths of a dispersive transmission end there (their
channels zero, the hero's times 3).
"""
from __future__ import annotations

import torch

from ..core.vec import Vec3
from ..render.fresnel import fresnel_dielectric, reflect, refract
from ..render.records import BSDFSample

FLAGS = 0x0020 | 0x0040 | 0x2000 | 0x4000  # DeltaR|DeltaT|Front|Back

LAMBDA_D = 0.5893  # the sodium d line [um], where eta is given


def eta_of(params, si):
    """Per lane eta: at the hero wavelength in the spectral variant."""
    wl = getattr(si, "wavelengths", None)
    if wl is None:
        return params[0]
    lam_um = wl.x * 1e-3
    return params[0] + params[8] * (1.0 / (lam_um * lam_um)
                                    - 1.0 / (LAMBDA_D * LAMBDA_D))


def sample(scene, bsdf_idx, si, s1, s2):
    params = scene.gather_bsdf_params(bsdf_idx)
    r, cos_theta_t, eta_it, eta_ti = fresnel_dielectric(si.wi.z,
                                                        eta_of(params, si))

    pick_reflect = s1 <= r
    wo = Vec3.where(pick_reflect, reflect(si.wi),
                    refract(si.wi, cos_theta_t, eta_ti))
    pdf = torch.where(pick_reflect, r, 1.0 - r)
    # radiance scales by eta_ti^2 on transmission (solid-angle compression)
    spec_r = Vec3(params[1], params[2], params[3])
    spec_t = Vec3(params[4], params[5], params[6]) * (eta_ti * eta_ti)
    wl = getattr(si, "wavelengths", None)
    if wl is not None:
        # once per path: the integrator then collapses its wavelengths to
        # the hero's, and lambda_1 == lambda_0 stops this
        dispersive = (params[8] != 0.0) & (wl.y != wl.x)
        zero = torch.zeros_like(spec_t.x)
        spec_t = Vec3.where(dispersive, Vec3(spec_t.x * 3.0, zero, zero),
                            spec_t)
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
