"""Phase functions — counterpart of ``mitsuba3_tpu/phase/__init__.py``
(include/mitsuba/render/phase.h and src/phase/).

Each phase type is a module of functions over per-lane medium parameter
rows (``scene.gather_medium_params``)::

  sample(scene, med_idx, wi, s1, s2) -> (wo Vec3 world, weight [N], pdf [N])
  eval_pdf(scene, med_idx, wi, wo)   -> (value [N], pdf [N])

with ``wi = -ray.d`` and world-space directions, as in the reference.
The dispatch is masked over the phase types the scene's media have, like
the BSDF layer's: with several types, each type's function reads its own
lanes' rows and, on the other lanes (vacuum lanes included), the row of
the first medium of its type, so no type sees a row of another (an SGGX
matrix of zeros under a Henyey-Greenstein lobe); the values it computes
there are discarded. The selected lanes compute what the JAX package
computes.
"""
from __future__ import annotations

import torch

from ..bsdfs import _where_tree, slot_table

ISOTROPIC_FLAG = 0x01
ANISOTROPIC_FLAG = 0x02
MICROFLAKE_FLAG = 0x04

# type ids (the scene's static `phase_types` entries)
ISOTROPIC = 0
HG = 1
RAYLEIGH = 2
SGGX = 3
TABPHASE = 4
BLEND = 5

NAMES = {"isotropic": ISOTROPIC, "hg": HG, "rayleigh": RAYLEIGH,
         "sggx": SGGX, "tabphase": TABPHASE, "blendphase": BLEND}

_REGISTRY = {}


def _dispatch(scene, med_idx, fn_name, *args):
    if not scene.phase_types:
        return getattr(_REGISTRY[ISOTROPIC], fn_name)(scene, med_idx, *args)
    lane_type = slot_table(tuple(scene.phase_types), med_idx.device)[
        torch.clamp(med_idx, 0, len(scene.phase_types) - 1).long()]
    result = None
    for t in sorted(set(scene.phase_types)):
        mine = lane_type == t
        idx_t = torch.where(mine & (med_idx >= 0), med_idx,
                            scene.phase_types.index(t))
        out = getattr(_REGISTRY[t], fn_name)(scene, idx_t, *args)
        result = out if result is None else _where_tree(mine, out, result)
    return result


def sample(scene, med_idx, wi, s1, s2):
    """-> (wo Vec3 world, weight [N], pdf [N])"""
    return _dispatch(scene, med_idx, "sample", wi, s1, s2)


def eval_pdf(scene, med_idx, wi, wo):
    """-> (value [N], pdf [N])"""
    return _dispatch(scene, med_idx, "eval_pdf", wi, wo)


from . import blendphase, hg, isotropic, rayleigh, sggx, tabphase  # noqa: E402

_REGISTRY.update({ISOTROPIC: isotropic, HG: hg, RAYLEIGH: rayleigh,
                  SGGX: sggx, TABPHASE: tabphase, BLEND: blendphase})
