"""Linear BSDF blend — counterpart of ``mitsuba3_tpu/bsdfs/blendbsdf.py``.

value = w * bsdf_1 + (1 - w) * bsdf_0 with one-sample MIS between the two
nested lobes; the weight is a constant or a texture. Param row: [0]
weight, [1] its texture id (0: the constant), [14] nested slot 0, [15]
nested slot 1, [16] two-sided flag. `level` is the nesting
level of the dispatch that called the function (0 at the top).
"""
from __future__ import annotations

import torch

from ..core import math as m
from ..core.vec import Vec3
from ..render.records import BSDFSample
from ..render.texture import eval_color

FLAGS = 0x0002 | 0x0008 | 0x2000  # Diffuse|Glossy|Front (conservative)


def _weight(scene, params, si):
    c = eval_color(scene, Vec3(params[0], params[0], params[0]), params[1],
                   si, scene.texture_ids("blendbsdf"), raw=True)
    return torch.clamp(c.mean(), 0.0, 1.0)


def _nested(params):
    return (torch.round(params[14]).to(torch.int32),
            torch.round(params[15]).to(torch.int32))


def sample(scene, bsdf_idx, si, s1, s2, level: int = 0):
    from . import dispatch_nested, flip_for_twosided
    params = scene.gather_bsdf_params(bsdf_idx)
    w = _weight(scene, params, si)
    n0, n1 = _nested(params)
    si, sgn = flip_for_twosided(params, si)
    lv = level + 1

    pick1 = s1 <= w
    s1_0 = torch.clamp(m.safe_div(s1 - w, 1.0 - w), 0.0, 1.0 - 1e-7)
    s1_1 = torch.clamp(m.safe_div(s1, w), 0.0, 1.0 - 1e-7)

    bs0, w0 = dispatch_nested(scene, n0, "sample", si, s1_0, s2, level=lv,
                              parent="blendbsdf")
    bs1, w1 = dispatch_nested(scene, n1, "sample", si, s1_1, s2, level=lv,
                              parent="blendbsdf")
    # cross evaluation for one-sample MIS
    e1_at0, p1_at0 = dispatch_nested(scene, n1, "eval_pdf", si, bs0.wo,
                                     level=lv, parent="blendbsdf")
    e0_at1, p0_at1 = dispatch_nested(scene, n0, "eval_pdf", si, bs1.wo,
                                     level=lv, parent="blendbsdf")

    pdf_b0 = w * p1_at0 + (1.0 - w) * bs0.pdf
    res0 = (e1_at0 * w + w0 * bs0.pdf * (1.0 - w)) * m.safe_div(1.0, pdf_b0)
    pdf_b1 = w * bs1.pdf + (1.0 - w) * p0_at1
    res1 = (w1 * bs1.pdf * w + e0_at1 * (1.0 - w)) * m.safe_div(1.0, pdf_b1)

    pdf = torch.where(pick1, pdf_b1, pdf_b0)
    wo = Vec3.where(pick1, bs1.wo, bs0.wo)
    bs = BSDFSample(
        wo=Vec3(wo.x, wo.y, wo.z * sgn), pdf=torch.where(pdf > 0.0, pdf, 0.0),
        eta=torch.where(pick1, bs1.eta, bs0.eta),
        sampled_type=torch.where(pick1, bs1.sampled_type, bs0.sampled_type),
        sampled_component=torch.where(pick1, bs1.sampled_component,
                                      bs0.sampled_component))
    return bs, Vec3.where(pick1, res1, res0).mask(pdf > 0.0)


def eval_pdf(scene, bsdf_idx, si, wo, level: int = 0):
    from . import dispatch_nested, flip_for_twosided
    params = scene.gather_bsdf_params(bsdf_idx)
    w = _weight(scene, params, si)
    n0, n1 = _nested(params)
    si, sgn = flip_for_twosided(params, si)
    wo = Vec3(wo.x, wo.y, wo.z * sgn)
    v0, p0 = dispatch_nested(scene, n0, "eval_pdf", si, wo, level=level + 1,
                             parent="blendbsdf")
    v1, p1 = dispatch_nested(scene, n1, "eval_pdf", si, wo, level=level + 1,
                             parent="blendbsdf")
    return v0 * (1.0 - w) + v1 * w, p0 * (1.0 - w) + p1 * w
