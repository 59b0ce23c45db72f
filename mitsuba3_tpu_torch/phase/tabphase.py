"""Tabulated phase function — counterpart of ``mitsuba3_tpu/phase/tabphase.py``
(src/phase/tabphase.cpp): a piecewise-linear pdf over cos θ' in [-1, 1]
with cos θ' = -dot(wo, wi) (forward scattering at 1). The table is
``scene.phase_tables[k]`` for the row's [18] = k + 1 and is differentiable.
Each table is evaluated on every lane and selected by a ``where``: no
lane gathers a table of its own."""
from __future__ import annotations

import torch

from ..core import math as m
from ..core.distr import ContinuousDistribution
from ..core.frame import Frame
from ..core.vec import Vec3

FLAGS = 0x02


def _slot(scene, med_idx):
    return torch.round(scene.gather_medium_params(med_idx)[18]).to(
        torch.int32)


def sample(scene, med_idx, wi, s1, s2):
    slot = _slot(scene, med_idx)
    cos_tp = torch.zeros_like(s1)
    pdf = torch.full_like(s1, m.InvFourPi)
    for k, table in enumerate(scene.phase_tables):
        d = ContinuousDistribution.from_pdf(table, -1.0, 1.0)
        c = d.sample(s2.x)
        sel = slot == k + 1
        cos_tp = torch.where(sel, c, cos_tp)
        pdf = torch.where(sel, d.eval_pdf_normalized(c) * m.InvTwoPi, pdf)
    sin_tp = m.safe_sqrt(1.0 - cos_tp * cos_tp)
    phi = m.TwoPi * s2.y
    local = Vec3(sin_tp * torch.cos(phi), sin_tp * torch.sin(phi), cos_tp)
    wo = -Frame.from_normal(wi).to_world(local)
    return wo, torch.ones_like(s1), pdf


def eval_pdf(scene, med_idx, wi, wo):
    slot = _slot(scene, med_idx)
    cos_tp = -wo.dot(wi)
    pdf = torch.full_like(cos_tp, m.InvFourPi)
    for k, table in enumerate(scene.phase_tables):
        d = ContinuousDistribution.from_pdf(table, -1.0, 1.0)
        pdf = torch.where(slot == k + 1,
                          d.eval_pdf_normalized(cos_tp) * m.InvTwoPi, pdf)
    return pdf, pdf
