"""Smooth conductor — counterpart of ``mitsuba3_tpu/bsdfs/conductor.py``.

Perfect specular reflection with complex-IOR Fresnel. Param row:
[0:3] eta (real part) rgb, [3:6] k rgb, [8:11] specular reflectance rgb,
[16] two-sided flag.
"""
from __future__ import annotations

import torch

from ..core.vec import Vec3
from ..render.fresnel import fresnel_conductor, reflect
from ..render.records import BSDFSample

FLAGS = 0x0020 | 0x2000  # DeltaReflection | FrontSide


def sample(scene, bsdf_idx, si, s1, s2):
    params = scene.gather_bsdf_params(bsdf_idx)
    # two-sided: the mirror direction is the same in a mirrored frame, so
    # only the Fresnel cosine and the active test take the flipped sign
    sgn = torch.where((params[16] > 0.5) & (si.wi.z < 0.0), -1.0, 1.0)
    cos_theta_i = si.wi.z * sgn
    active = cos_theta_i > 0.0

    wo = reflect(si.wi)
    eta = Vec3(params[0], params[1], params[2])
    k = Vec3(params[3], params[4], params[5])
    spec = Vec3(params[8], params[9], params[10])
    weight = (spec * fresnel_conductor(cos_theta_i, eta, k)).mask(active)
    bs = BSDFSample(
        wo=wo,
        pdf=torch.where(active, 1.0, 0.0),
        eta=torch.ones_like(cos_theta_i),
        sampled_type=torch.full_like(cos_theta_i, 0x0020, dtype=torch.int32),
        sampled_component=torch.zeros_like(cos_theta_i, dtype=torch.int32))
    return bs, weight


def eval_pdf(scene, bsdf_idx, si, wo):
    # a delta lobe has zero density with respect to solid angle
    return Vec3.zeros(si.t.shape[0], si.t.device), torch.zeros_like(si.t)
