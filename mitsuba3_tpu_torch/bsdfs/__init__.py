"""BSDF registry and masked per-type dispatch — counterpart of
``mitsuba3_tpu/bsdfs/__init__.py``.

Each BSDF type is a module of functions over per-lane parameter rows;
per-lane dispatch evaluates every type present in the scene and blends
by mask. The port registers the JAX package's type ids 0-13, 15 and 18:
diffuse, conductor, roughconductor, dielectric, plastic, null,
thindielectric, roughdielectric, roughplastic, the adapters mask,
blendbsdf and normalmap, principled, hair, measured and principledthin
(``twosided`` is the row's flag [16], not a type; a bumpmap loads as a
normalmap). The polarized types (14, 16, 17) are not ported.

A user's own BSDF registers through ``register_custom`` (the port's
``register_bsdf``) under a scene-dict type name and gets an id from 100
up, as in the JAX package. Its module has the port's contract: ``FLAGS``
and ``sample(scene, bsdf_idx, si, s1, s2) -> (BSDFSample, weight Vec3)``
and ``eval_pdf(scene, bsdf_idx, si, wo) -> (value Vec3, pdf)`` on torch
tensors, reading its rows by ``scene.gather_bsdf_params(bsdf_idx)``.

Adapters wrap nested BSDF slots. Their nesting unrolls statically:
``dispatch_nested`` includes adapter types until the scene's longest
adapter chain (``scene.adapter_max_depth``, computed at load) is reached,
then dispatches over leaf types only. The nesting level is an argument of
the adapters' functions.
"""
from __future__ import annotations

import dataclasses
import functools

import numpy as np
import torch

from ..core.vec import Vec3
from . import (blendbsdf, conductor, dielectric, diffuse, hair, mask,
               measured, normalmap, null, plastic, principled, principledthin,
               roughconductor, roughdielectric, roughplastic, thindielectric)

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
NORMALMAP = 11
PRINCIPLED = 12
HAIR = 13
MEASURED = 15
PRINCIPLED_THIN = 18
CUSTOM_BASE = 100   # the first id of a user's registered BSDF
N_PARAMS = 28  # bsdf_params row width ([16] = two-sided flag, all types;
#                [14], [15] = nested slots; [17:26] = roughplastic's fit)

_REGISTRY = {DIFFUSE: diffuse, CONDUCTOR: conductor,
             ROUGH_CONDUCTOR: roughconductor, DIELECTRIC: dielectric,
             PLASTIC: plastic, NULL: null, THIN_DIELECTRIC: thindielectric,
             ROUGH_DIELECTRIC: roughdielectric, ROUGH_PLASTIC: roughplastic,
             MASK: mask, BLEND: blendbsdf, NORMALMAP: normalmap,
             PRINCIPLED: principled, HAIR: hair, MEASURED: measured,
             PRINCIPLED_THIN: principledthin}
_CUSTOM = {}   # name -> (type id, lower function or None)
ADAPTER_TYPES = frozenset((MASK, BLEND, NORMALMAP))
# the row column of each textured type's texture id
TEXTURE_COLUMN = {DIFFUSE: 3, PLASTIC: 3, ROUGH_PLASTIC: 3, MASK: 1,
                  BLEND: 1, NORMALMAP: 1, PRINCIPLED: 3, PRINCIPLED_THIN: 3}


def register_custom(name: str, module, lower=None) -> int:
    """Register a user's BSDF `module` under the scene-dict type `name`;
    returns its type id (from CUSTOM_BASE up; registering a name again
    replaces its module and keeps its id). `lower(spec)` gives the row's
    first values (at most N_PARAMS floats); without it [0:3] is the spec's
    ``reflectance`` (0.5 by default)."""
    tid = _CUSTOM[name][0] if name in _CUSTOM else CUSTOM_BASE + len(_CUSTOM)
    _CUSTOM[name] = (tid, lower)
    _REGISTRY[tid] = module
    return tid


def custom_type(name: str):
    """(type id, lower function) of a registered BSDF name, else None."""
    return _CUSTOM.get(name)


def _name(type_id) -> str:
    return _REGISTRY[type_id].__name__.rpartition(".")[2]


def nested_slots(type_id, row) -> list:
    """The nested slots of an adapter row (mask, normalmap: [15]; blend:
    [15], [14])."""
    kids = [int(round(float(row[15])))]
    if type_id == BLEND:
        kids.append(int(round(float(row[14]))))
    return kids


def reachable_types(bsdf_types, bsdf_rows, face_slots) -> tuple:
    """((None, the types of the slots faces name), (adapter module name,
    the types of the slots its rows nest), ...): the types a dispatch at
    the top and one nested in each adapter can meet (``_dispatch``)."""
    n = len(bsdf_types)
    nested = {}
    for t, row in zip(bsdf_types, bsdf_rows):
        if t in ADAPTER_TYPES:
            nested.setdefault(_name(t), set()).update(
                bsdf_types[k] for k in nested_slots(t, row) if 0 <= k < n)
    top = sorted({bsdf_types[int(s)] for s in set(face_slots)})
    return ((None, tuple(top)),) + tuple(
        (name, tuple(sorted(types))) for name, types in sorted(nested.items()))


def texture_users(bsdf_types, bsdf_rows) -> tuple:
    """((BSDF module name, texture ids its rows hold), ...): the ids
    (k + 1 for scene.textures[k], -1 for vertex colors) in the texture
    column of every row of each textured type. A masked dispatch gives a
    type's function rows of that type only, so its color lookups need no
    other texture (``Scene.texture_ids``)."""
    users = {}
    for t, row in zip(bsdf_types, bsdf_rows):
        if t in TEXTURE_COLUMN:
            k = int(np.float32(row[TEXTURE_COLUMN[t]]))
            ids = users.setdefault(_name(t), set())
            if k:
                ids.add(k)
    return tuple((name, tuple(sorted(ids))) for name, ids in
                 sorted(users.items()))


def dispatch_tables(bsdf_types, bsdf_rows, face_slots) -> dict:
    """A Scene's ``bsdf_textures`` and ``bsdf_reach`` for the host rows
    `bsdf_rows` and the slots `face_slots` that faces name."""
    return {"bsdf_textures": texture_users(bsdf_types, bsdf_rows),
            "bsdf_reach": reachable_types(bsdf_types, bsdf_rows, face_slots)}


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


def _dispatch(scene, bsdf_idx, fn_name, *args, level: int = 0,
              parent: str = None):
    """Masked static dispatch over the types present at nesting `level`
    (0 at the top; `parent` names the adapter module of a nested call):
    adapter types only while `level` is below the scene's longest adapter
    chain, and of those only the types that the faces' slots (at the top)
    or the parent's rows' nested slots have (``scene.bsdf_reach``): no lane
    reaches another type there.

    With several types, each type's function reads its own lanes' rows and,
    on the other lanes, the row of the first slot of its type: the values
    it computes there are discarded, and a row of another type (a diffuse
    row's zero roughness under a microfacet lobe) would put an inf or NaN
    into the gradient that the replay of ``prb`` takes through the masked
    select. The selected lanes compute what the JAX package computes."""
    max_depth = getattr(scene, "adapter_max_depth", 1) or 1
    reach = dict(scene.bsdf_reach)[parent]
    unique = tuple(t for t in sorted(set(scene.bsdf_types))
                   if (level < max_depth or t not in ADAPTER_TYPES)
                   and t in reach)
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


def dispatch_nested(scene, bsdf_idx, fn_name, *args, level: int,
                    parent: str):
    """Adapter module `parent`'s call of its nested slots `bsdf_idx` at
    nesting `level` (1 for an adapter dispatched at the top)."""
    return _dispatch(scene, bsdf_idx, fn_name, *args, level=level,
                     parent=parent)


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
