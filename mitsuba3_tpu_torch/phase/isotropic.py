"""Isotropic phase function — counterpart of
``mitsuba3_tpu/phase/isotropic.py`` (src/phase/isotropic.cpp):
uniform-sphere sampling, value = pdf = 1/(4π)."""
from __future__ import annotations

import torch

from ..core import math as m
from ..core.warp import square_to_uniform_sphere

FLAGS = 0x01


def sample(scene, med_idx, wi, s1, s2):
    wo = square_to_uniform_sphere(s2)
    return wo, torch.ones_like(s1), torch.full_like(s1, m.InvFourPi)


def eval_pdf(scene, med_idx, wi, wo):
    pdf = torch.full_like(wo.x, m.InvFourPi)
    return pdf, pdf
