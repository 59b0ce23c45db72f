"""Henyey-Greenstein phase function — counterpart of
``mitsuba3_tpu/phase/hg.py`` (src/phase/hg.cpp:64-99). The row's [7]
holds g; eval uses dot(wo, wi) with wi = -ray.d; sampling builds a
frame around wi and emits z = -cos_theta."""
from __future__ import annotations

import torch

from ..core import math as m
from ..core.frame import Frame
from ..core.vec import Vec3

FLAGS = 0x02

_EPS_G = 1e-4


def _eval_hg(g, cos_theta):
    temp = 1.0 + g * g + 2.0 * g * cos_theta
    return m.InvFourPi * (1.0 - g * g) / (temp * m.safe_sqrt(temp))


def sample(scene, med_idx, wi, s1, s2):
    g = scene.gather_medium_params(med_idx)[7]
    sqr_term = (1.0 - g * g) / (1.0 - g + 2.0 * g * s2.x)
    cos_theta = m.safe_div(1.0 + g * g - sqr_term * sqr_term, 2.0 * g)
    # the diffuse fallback near g = 0 (hg.cpp:81)
    cos_theta = torch.where(g.abs() < _EPS_G, 1.0 - 2.0 * s2.x, cos_theta)
    cos_theta = torch.clamp(cos_theta, -1.0, 1.0)
    sin_theta = m.safe_sqrt(1.0 - cos_theta * cos_theta)
    phi = m.TwoPi * s2.y
    local = Vec3(sin_theta * torch.cos(phi), sin_theta * torch.sin(phi),
                 -cos_theta)
    wo = Frame.from_normal(wi).to_world(local)
    return wo, torch.ones_like(s1), _eval_hg(g, -cos_theta)


def eval_pdf(scene, med_idx, wi, wo):
    g = scene.gather_medium_params(med_idx)[7]
    pdf = _eval_hg(g, wo.dot(wi))
    return pdf, pdf
