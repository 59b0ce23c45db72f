"""Normal map — counterpart of ``mitsuba3_tpu/bsdfs/normalmap.py``
(src/bsdfs/normalmap.cpp; a ``bumpmap`` is lowered to a normal map at
load time).

Perturbs the shading frame with a tangent-space normal fetched from a
texture (2c - 1), then calls the nested BSDF in the perturbed frame. Param
row: [1] normal texture id (0: the flat normal), [15] nested BSDF slot,
[16] two-sided flag. `level` is the nesting level of the dispatch that
called the function (0 at the top).
"""
from __future__ import annotations

import torch

from ..core.frame import Frame
from ..core.vec import Vec3
from ..render.texture import eval_color

FLAGS = 0x0002 | 0x0008 | 0x2000  # conservative: diffuse|glossy|front


def _perturbed_si(scene, params, si):
    """si with the shading frame turned to the mapped normal
    (normalmap.cpp frame): n = 2 * tex - 1 in tangent space."""
    half = torch.full_like(si.t, 0.5)
    c = eval_color(scene, Vec3(half, half, torch.ones_like(si.t)),
                   params[1], si, scene.texture_ids("normalmap"), raw=True)
    n_tan = Vec3(c.x * 2.0 - 1.0, c.y * 2.0 - 1.0,
                 torch.clamp(c.z * 2.0 - 1.0, min=1e-3)).normalize()
    frame = Frame.from_normal(si.sh_frame.to_world(n_tan))
    wi_new = frame.to_local(si.sh_frame.to_world(si.wi))
    return si.replace(sh_frame=frame, wi=wi_new), frame


def _nested_idx(params):
    return torch.round(params[15]).to(torch.int32)


def sample(scene, bsdf_idx, si, s1, s2, level: int = 0):
    from . import dispatch_nested, flip_for_twosided
    params = scene.gather_bsdf_params(bsdf_idx)
    si, sgn = flip_for_twosided(params, si)
    si_p, frame = _perturbed_si(scene, params, si)
    bs, w = dispatch_nested(scene, _nested_idx(params), "sample", si_p, s1,
                            s2, level=level + 1, parent="normalmap")
    # wo back in the original shading frame
    wo = si.sh_frame.to_local(frame.to_world(bs.wo))
    # reject samples bent below the geometric surface
    ok = (wo.z * si.wi.z > 0.0) & (bs.pdf > 0.0)
    bs = bs.replace(wo=Vec3(wo.x, wo.y, wo.z * sgn),
                    pdf=torch.where(ok, bs.pdf, 0.0))
    return bs, w.mask(ok)


def eval_pdf(scene, bsdf_idx, si, wo, level: int = 0):
    from . import dispatch_nested, flip_for_twosided
    params = scene.gather_bsdf_params(bsdf_idx)
    si, sgn = flip_for_twosided(params, si)
    wo = Vec3(wo.x, wo.y, wo.z * sgn)
    si_p, frame = _perturbed_si(scene, params, si)
    wo_p = frame.to_local(si.sh_frame.to_world(wo))
    val, pdf = dispatch_nested(scene, _nested_idx(params), "eval_pdf", si_p,
                               wo_p, level=level + 1, parent="normalmap")
    ok = wo.z * si.wi.z > 0.0
    return val.mask(ok), torch.where(ok, pdf, 0.0)
