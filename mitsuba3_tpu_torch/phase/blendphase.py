"""Blended phase function — counterpart of ``mitsuba3_tpu/phase/blendphase.py``
(src/phase/blendphase.cpp): value = (1 - w) phase_0 + w phase_1 with
one-sample selection by w. The row's [19] holds w, [20] / [21] the nested
phase types (a blend inside a blend is refused at load)."""
from __future__ import annotations

import torch

from ..core import math as m
from ..core.vec import Vec3

FLAGS = 0x02


def _nested(scene, med_idx, fn_name, type_row, *args):
    """Masked dispatch over the non-adapter phase types by per-lane type
    id; every type reads the blend's own row."""
    from . import _REGISTRY, HG, ISOTROPIC, RAYLEIGH, SGGX
    from ..bsdfs import _where_tree
    result = None
    for t in (ISOTROPIC, HG, RAYLEIGH, SGGX):
        out = getattr(_REGISTRY[t], fn_name)(scene, med_idx, *args)
        result = out if result is None else _where_tree(type_row == t, out,
                                                        result)
    return result


def _weights(scene, med_idx):
    params = scene.gather_medium_params(med_idx)
    return (torch.clamp(params[19], 0.0, 1.0),
            torch.round(params[20]).to(torch.int32),
            torch.round(params[21]).to(torch.int32))


def sample(scene, med_idx, wi, s1, s2):
    w, t0, t1 = _weights(scene, med_idx)
    pick1 = s1 < w
    s1r = torch.where(pick1, m.safe_div(s1, w), m.safe_div(s1 - w, 1.0 - w))
    wo0 = _nested(scene, med_idx, "sample", t0, wi, s1r, s2)[0]
    wo1 = _nested(scene, med_idx, "sample", t1, wi, s1r, s2)[0]
    wo = Vec3.where(pick1, wo1, wo0)
    # one-sample MIS over the mixture: the blended pdf and value
    v0, p0 = _nested(scene, med_idx, "eval_pdf", t0, wi, wo)
    v1, p1 = _nested(scene, med_idx, "eval_pdf", t1, wi, wo)
    pdf = (1.0 - w) * p0 + w * p1
    val = (1.0 - w) * v0 + w * v1
    return wo, m.safe_div(val, pdf, fallback=0.0), pdf


def eval_pdf(scene, med_idx, wi, wo):
    w, t0, t1 = _weights(scene, med_idx)
    v0, p0 = _nested(scene, med_idx, "eval_pdf", t0, wi, wo)
    v1, p1 = _nested(scene, med_idx, "eval_pdf", t1, wi, wo)
    return (1.0 - w) * v0 + w * v1, (1.0 - w) * p0 + w * p1
