"""Rayleigh phase function — counterpart of ``mitsuba3_tpu/phase/rayleigh.py``
(src/phase/rayleigh.cpp): p(cos θ) = 3/(16π) (1 + cos²θ), sampled by the
cube-root inversion of its CDF (rayleigh.cpp:60-66)."""
from __future__ import annotations

import torch

from ..core import math as m
from ..core.frame import Frame
from ..core.vec import Vec3

FLAGS = 0x02


def _cbrt(x):
    return torch.sign(x) * x.abs().pow(1.0 / 3.0)


def _eval_rayleigh(cos_theta):
    return (3.0 / 16.0) * m.InvPi * (1.0 + cos_theta * cos_theta)


def sample(scene, med_idx, wi, s1, s2):
    z = 2.0 * (2.0 * s2.x - 1.0)
    tmp = torch.sqrt(z * z + 1.0)
    cos_theta = torch.clamp(_cbrt(z + tmp) + _cbrt(z - tmp), -1.0, 1.0)
    sin_theta = m.safe_sqrt(1.0 - cos_theta * cos_theta)
    phi = m.TwoPi * s2.y
    local = Vec3(sin_theta * torch.cos(phi), sin_theta * torch.sin(phi),
                 cos_theta)
    wo = Frame.from_normal(wi).to_world(local)
    return wo, torch.ones_like(s1), _eval_rayleigh(-cos_theta)


def eval_pdf(scene, med_idx, wi, wo):
    pdf = _eval_rayleigh(wo.dot(wi))
    return pdf, pdf
