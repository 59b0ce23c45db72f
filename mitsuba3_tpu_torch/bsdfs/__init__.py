"""BSDF registry and masked per-type dispatch — counterpart of
``mitsuba3_tpu/bsdfs/__init__.py``.

Each BSDF type is a module of functions over per-lane parameter rows;
per-lane dispatch evaluates every type present in the scene and blends
by mask. The port registers the JAX package's type ids 0-10: diffuse,
conductor, roughconductor, dielectric, plastic, null, thindielectric,
roughdielectric, roughplastic and the adapters mask and blendbsdf
(``twosided`` is the row's flag [16], not a type).

Adapters wrap nested BSDF slots. Their nesting unrolls statically:
``dispatch_nested`` includes adapter types until the scene's longest
adapter chain (``scene.adapter_max_depth``, computed at load) is reached,
then dispatches over leaf types only. The nesting level is an argument of
the adapters' functions.
"""
from __future__ import annotations

import dataclasses
import functools

import torch

from ..core.vec import Vec3
from . import (blendbsdf, conductor, dielectric, diffuse, mask, null,
               plastic, roughconductor, roughdielectric, roughplastic,
               thindielectric)

# BSDFFlags (bsdf.h)
NULL_FLAG = 0x0001
DIFFUSE_REFLECTION = 0x0002
DIFFUSE_TRANSMISSION = 0x0004
GLOSSY_REFLECTION = 0x0008
GLOSSY_TRANSMISSION = 0x0010
DELTA_REFLECTION = 0x0020
DELTA_TRANSMISSION = 0x0040
FRONT_SIDE = 0x2000
BACK_SIDE = 0x4000
SMOOTH = (DIFFUSE_REFLECTION | DIFFUSE_TRANSMISSION | GLOSSY_REFLECTION
          | GLOSSY_TRANSMISSION)
DELTA = DELTA_REFLECTION | DELTA_TRANSMISSION

# type ids, shared with the JAX package's static `bsdf_types` tuples
DIFFUSE = 0
CONDUCTOR = 1
ROUGH_CONDUCTOR = 2
DIELECTRIC = 3
PLASTIC = 4
NULL = 5
THIN_DIELECTRIC = 6
ROUGH_DIELECTRIC = 7
ROUGH_PLASTIC = 8
MASK = 9
BLEND = 10
N_PARAMS = 28  # bsdf_params row width ([16] = two-sided flag, all types;
#                [14], [15] = nested slots; [17:26] = roughplastic's fit)

_REGISTRY = {DIFFUSE: diffuse, CONDUCTOR: conductor,
             ROUGH_CONDUCTOR: roughconductor, DIELECTRIC: dielectric,
             PLASTIC: plastic, NULL: null, THIN_DIELECTRIC: thindielectric,
             ROUGH_DIELECTRIC: roughdielectric, ROUGH_PLASTIC: roughplastic,
             MASK: mask, BLEND: blendbsdf}
ADAPTER_TYPES = frozenset((MASK, BLEND))


@functools.lru_cache(maxsize=256)
def slot_table(values: tuple, device: torch.device) -> torch.Tensor:
    """A per-slot int32 table (types or flags) on `device`, made once: a
    host-to-device copy per dispatch would wait on the stream."""
    return torch.tensor(values, dtype=torch.int32, device=device)


def type_flags(type_id) -> int:
    return _REGISTRY[type_id].FLAGS


def lane_flags(bsdf_types: tuple, bsdf_idx, slot_flags: tuple = None):
    """Per-lane BSDFFlags: static table lookup by bsdf slot index.

    ``slot_flags`` (scene.bsdf_flags, computed at load) refines the
    per-type table with resolved adapter chains: mask(conductor) reports
    Delta | Null, not the adapter's conservative flags."""
    flags = slot_flags or tuple(type_flags(t) for t in bsdf_types)
    return slot_table(tuple(flags), bsdf_idx.device)[bsdf_idx]


def _where_tree(mask, new, old):
    if isinstance(new, torch.Tensor):
        return torch.where(mask, new, old)
    if dataclasses.is_dataclass(new):
        return dataclasses.replace(new, **{
            f.name: _where_tree(mask, getattr(new, f.name),
                                getattr(old, f.name))
            for f in dataclasses.fields(new)})
    return tuple(_where_tree(mask, a, b) for a, b in zip(new, old))


def _dispatch(scene, bsdf_idx, fn_name, *args, level: int = 0):
    """Masked static dispatch over the types present at nesting `level`
    (0 at the top): adapter types only while `level` is below the scene's
    longest adapter chain.

    With several types, each type's function reads its own lanes' rows and,
    on the other lanes, the row of the first slot of its type: the values
    it computes there are discarded, and a row of another type (a diffuse
    row's zero roughness under a microfacet lobe) would put an inf or NaN
    into the gradient that the replay of ``prb`` takes through the masked
    select. The selected lanes compute what the JAX package computes."""
    max_depth = getattr(scene, "adapter_max_depth", 1) or 1
    unique = tuple(t for t in sorted(set(scene.bsdf_types))
                   if level < max_depth or t not in ADAPTER_TYPES)
    if len(unique) == 1:
        kw = {"level": level} if unique[0] in ADAPTER_TYPES else {}
        return getattr(_REGISTRY[unique[0]], fn_name)(scene, bsdf_idx,
                                                      *args, **kw)
    lane_type = slot_table(tuple(scene.bsdf_types), bsdf_idx.device)[bsdf_idx]
    result = None
    for t in unique:
        kw = {"level": level} if t in ADAPTER_TYPES else {}
        mine = lane_type == t
        idx_t = torch.where(mine, bsdf_idx, scene.bsdf_types.index(t))
        out = getattr(_REGISTRY[t], fn_name)(scene, idx_t, *args, **kw)
        result = out if result is None else _where_tree(mine, out, result)
    return result


def sample(scene, bsdf_idx, si, s1, s2):
    """-> (BSDFSample, weight Vec3)"""
    return _dispatch(scene, bsdf_idx, "sample", si, s1, s2)


def eval_pdf(scene, bsdf_idx, si, wo):
    """-> (value Vec3 including cosine foreshortening, pdf [N])"""
    return _dispatch(scene, bsdf_idx, "eval_pdf", si, wo)


def dispatch_nested(scene, bsdf_idx, fn_name, *args, level: int):
    """An adapter's call of its nested slots `bsdf_idx` at nesting `level`
    (1 for an adapter dispatched at the top)."""
    return _dispatch(scene, bsdf_idx, fn_name, *args, level=level)


def eval_null_transmission(scene, bsdf_idx, si):
    """Per-lane transmittance of straight-through shadow rays for the
    null-like types (null, mask); zero elsewhere."""
    out = Vec3.zeros(si.t.shape[0], si.t.device)
    present = set(scene.bsdf_types)
    lane_type = slot_table(tuple(scene.bsdf_types), bsdf_idx.device)[bsdf_idx]
    for t in (NULL, MASK):
        if t in present:
            val = _REGISTRY[t].eval_null_transmission(scene, bsdf_idx, si)
            out = Vec3.where(lane_type == t, val, out)
    return out


def flip_for_twosided(params, si):
    """Two-sided adapter handling: when the row carries the two-sided
    flag ([16]) and the query is on the back side, mirror the local frame
    for the nested calls; the caller mirrors sampled directions back with
    ``sgn``."""
    sgn = torch.where((params[16] > 0.5) & (si.wi.z < 0.0), -1.0, 1.0)
    si_f = si.replace(wi=Vec3(si.wi.x, si.wi.y, si.wi.z * sgn))
    return si_f, sgn
