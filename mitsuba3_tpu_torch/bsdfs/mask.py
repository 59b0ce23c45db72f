"""Opacity mask — counterpart of ``mitsuba3_tpu/bsdfs/mask.py``.

Blends a nested BSDF with perfect null transmission by an opacity,
constant or from a texture. Param row: [0] opacity, [1] its texture id
(0: the constant), [15] nested BSDF slot, [16] two-sided flag. `level`
is the nesting level of the dispatch that called the function (0 at the
top).
"""
from __future__ import annotations

import torch

from ..core import math as m
from ..core.vec import Vec3
from ..render.records import BSDFSample
from ..render.texture import eval_color

FLAGS = 0x0001 | 0x0002 | 0x0008 | 0x2000 | 0x4000  # Null|Smooth-ish|2-sided


def _opacity(scene, params, si):
    c = eval_color(scene, Vec3(params[0], params[0], params[0]), params[1],
                   si, scene.texture_ids("mask"), raw=True)
    return torch.clamp(c.mean(), 0.0, 1.0)


def _nested_idx(params):
    return torch.round(params[15]).to(torch.int32)


def sample(scene, bsdf_idx, si, s1, s2, level: int = 0):
    from . import dispatch_nested, flip_for_twosided
    params = scene.gather_bsdf_params(bsdf_idx)
    op = _opacity(scene, params, si)
    si_n, sgn = flip_for_twosided(params, si)

    pick_nested = s1 < op
    s1_r = torch.clamp(m.safe_div(s1, op), 0.0, 1.0 - 1e-7)
    bs_n, w_n = dispatch_nested(scene, _nested_idx(params), "sample", si_n,
                                s1_r, s2, level=level + 1, parent="mask")
    wo_n = Vec3(bs_n.wo.x, bs_n.wo.y, bs_n.wo.z * sgn)

    wo = Vec3.where(pick_nested, wo_n, -si.wi)
    pdf = torch.where(pick_nested, bs_n.pdf * op, 1.0 - op)
    # attached opacity over the detached selection probability
    rel_n = op / torch.clamp(op.detach(), min=1e-6)
    rel_t = (1.0 - op) / torch.clamp((1.0 - op).detach(), min=1e-6)
    weight = Vec3.where(pick_nested, w_n * rel_n, Vec3(rel_t, rel_t, rel_t))
    bs = BSDFSample(
        wo=wo, pdf=torch.where(pdf > 0.0, pdf, 0.0),
        eta=torch.where(pick_nested, bs_n.eta, 1.0),
        sampled_type=torch.where(pick_nested, bs_n.sampled_type, 0x0001).to(
            torch.int32),
        sampled_component=torch.where(pick_nested, bs_n.sampled_component,
                                      -1).to(torch.int32))
    return bs, weight.mask(pdf > 0.0)


def eval_pdf(scene, bsdf_idx, si, wo, level: int = 0):
    from . import dispatch_nested, flip_for_twosided
    params = scene.gather_bsdf_params(bsdf_idx)
    op = _opacity(scene, params, si)
    si_n, sgn = flip_for_twosided(params, si)
    val, pdf = dispatch_nested(scene, _nested_idx(params), "eval_pdf", si_n,
                               Vec3(wo.x, wo.y, wo.z * sgn), level=level + 1,
                               parent="mask")
    return val * op, pdf * op


def eval_null_transmission(scene, bsdf_idx, si):
    t = 1.0 - _opacity(scene, scene.gather_bsdf_params(bsdf_idx), si)
    return Vec3(t, t, t)
