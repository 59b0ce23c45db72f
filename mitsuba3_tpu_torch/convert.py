"""Carry a scene's state between the JAX package and the port.

A renderer's "weights" are its scene tables. ``arrays_from_scene`` reads
the leaves a scene of the port needs (vertices, faces, the face tables
with their vertex colors, area-emitter sampling tables, emitters,
environment map and warp, BSDF rows, textures and their mip levels,
medium rows, density grids, phase tables, world->grid affines and the
faces' media, the measured BSDFs' tables, sensor or a batch sensor's
sub-sensors, accel arrays) into
a flat dict of numpy arrays plus a dict of static fields (among them the
textures' metadata, the media's and phases' types, the sensor's medium,
the film with its crop window, the sensor config, the sampler type, the
sphere emitters' and directionalarea emitters' slots and the
integrator's config, a volumetric one's ``max_null_events`` and
``shadow_segments`` and the nested config of a ``moment`` or an ``aov``
included, as specs ``integrators.config_from_dict`` reads). The sphere
emitters' cone rows (``em_sphere``) are an array like the others. The
spectral variant comes across whole: the flag ``spectral``, the
emitters' and reflectances' SPDs (``em_spd``, ``bsdf_spd``), the SPD
emitters' slots and a specfilm's response functions (the film's
``srfs``). It takes a JAX ``Scene`` or a port ``Scene`` alike, by
attribute names, and imports nothing of JAX.
``scene_from_arrays`` builds the port's ``Scene`` from them on a device.

Implicit geometry comes across too: the analytic rows (``analytic_prims``),
the SDF grids and rows, the instance table (``instances.<field>``), each
prototype's accel (``proto_accels.<p>.<field>``, its kind in
``meta["proto_accels"]``, ``"dense"`` for none), the prototypes' face
ranges and ``n_query_faces``.

The accel is None for the dense all-triangles test (kind ``"dense"``,
no arrays), or one of cellserve (``MI3T_ACCEL`` cells, or auto on the
card), bvh_serve (``serve``), bvh_tiled (``tiled``), bvh_xla (``xla``, or
auto on a CPU device), the DDA grid (``grid``) or a ``HybridAccel``
(kind ``"hybrid"``: each side's arrays under ``closest.`` and
``anyhit.``, each side's meta under its name); its kind is told by the
fields it has, and ``meta["accel"]["kind"]`` carries it across.
``accel_arrays`` and ``accel_from_arrays`` do the same for an accel on
its own, which may also be one of the attic's (``"pallas"`` for
bvh_pallas, ``"bvh2"``; bvh_queue's is a ``"serve"`` accel); no scene
holds an attic accel, so ``scene_from_arrays`` refuses those two kinds.

The JAX cellserve accel stores its cell occupancy as a packed byte
bitmap (``occ_bytes``, cell c at byte c >> 3, bit c & 7); the port keeps
it unpacked as one bool per cell (``occ``). ``unpack_occupancy`` and
``pack_occupancy`` convert between the two.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from . import bsdfs
from .core.distr2d import SlicedMarginal2D
from . import emitters
from .integrators import config_from_dict, config_to_dict
from .ops.attic.bvh2 import BVH2
from .ops.attic.bvh_pallas import BVHData
from .ops.bvh_serve import BVHServe
from .ops.bvh_tiled import BVHTiled
from .ops.bvh_xla import BVHXLA
from .ops.cellserve import CellServe
from .ops.grid import GridAccel
from .render.film import FilmConfig
from .render.instancing import INSTANCE_FIELDS, InstanceTable
from .render.scene import HybridAccel, Scene, reached_slots
from .sensors import SensorConfig, SensorData

SCENE_ARRAYS = ("vertices", "faces", "face_shape", "face_bsdf",
                "face_emitter", "face_inv_total_area", "face_uv",
                "face_normals", "face_colors", "em_radiance", "ef_face",
                "ef_cdf", "env_data", "env_scale", "bsdf_params",
                "de_params", "medium_params", "medium_to_grid", "face_medium",
                "em_sphere", "analytic_prims", "sdf_rows", "em_spd",
                "bsdf_spd")
TUPLES = ("medium_grids", "phase_tables", "sdf_grids")   # tuples of arrays
WARP_ARRAYS = ("density", "marg_cdf", "cond_cdf")
# a measured BSDF's table: its arrays and its two SlicedMarginal2D warps
MEASURED_ARRAYS = ("theta_i", "phi_i", "reduction", "spectra", "ndf",
                   "sigma")
MEASURED_WARPS = ("lum", "vndf")
SENSOR_ARRAYS = ("origin", "axis_x", "axis_y", "axis_z", "tan_half_x",
                 "tan_half_y", "aperture_radius", "focus_distance")
# accel kind -> (class, array fields, static fields)
ACCELS = {
    "cells": (CellServe, ("tris", "start", "occ", "lo", "inv_cell"),
              ("res", "n_tris", "pair_slots", "max_steps")),
    "serve": (BVHServe, ("tris", "bounds", "sup"),
              ("n_leaves", "m_pad", "topk")),
    "tiled": (BVHTiled, ("leaf_bounds", "tris", "prim", "scene_lo",
                         "scene_span"), ("n_leaves",)),
    "pallas": (BVHData, ("node_bounds", "node_meta", "tris", "prim_order"),
               ("n_leaves",)),
    "bvh2": (BVH2, ("bounds", "tris"), ("n_nodes",)),
    "xla": (BVHXLA, ("bounds", "left", "right", "parent", "is_left", "tri",
                     "prim"), ("n_nodes",)),
    "grid": (GridAccel, ("table", "lo", "inv_cell"),
             ("res", "max_steps", "k")),
}
HYBRID_SIDES = ("closest", "anyhit")   # a HybridAccel's two accels
ATTIC = ("pallas", "bvh2")   # standalone accels only: no scene holds one
SCENE_META = ("n_emitters", "n_area_emitters", "env_emitter",
              "delta_emitter_types", "bsdf_types", "bsdf_flags",
              "adapter_max_depth", "spp", "sampler_type", "texture_meta",
              "medium_types", "phase_types", "sensor_medium",
              "em_sphere_slots", "em_directional", "em_spd_slots",
              "spectral")


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def _fields(obj, cls) -> dict:
    """The fields of dataclass `cls` read from `obj` by name."""
    return {f.name: getattr(obj, f.name) for f in dataclasses.fields(cls)}


def unpack_occupancy(occ_bytes, n_cells: int) -> np.ndarray:
    """Packed occupancy bytes (any shape, values 0-255) -> [n_cells] bool."""
    b = np.asarray(np.asarray(occ_bytes, np.float32), np.uint8).reshape(-1)
    return np.unpackbits(b, bitorder="little")[:n_cells].astype(bool)


def pack_occupancy(occ, n_groups: int) -> np.ndarray:
    """[C] bool -> [n_groups, 32] occupancy bytes (the JAX layout)."""
    out = np.zeros(n_groups * 32, np.uint8)
    packed = np.packbits(np.asarray(occ, bool), bitorder="little")
    out[:packed.shape[0]] = packed
    return out.reshape(n_groups, 32)


def arrays_from_scene(scene):
    """(arrays, meta) of `scene`: arrays maps dotted leaf names to numpy
    arrays, meta holds the static fields."""
    arrays = {}
    for name in SCENE_ARRAYS:
        value = getattr(scene, name)
        if value is not None:
            arrays[name] = _np(value)
    for name in TUPLES:
        for i, a in enumerate(getattr(scene, name)):
            arrays[f"{name}.{i}"] = _np(a)
    for i, tex in enumerate(scene.textures):
        arrays[f"textures.{i}"] = _np(tex)
        for j, level in enumerate(scene.texture_mips[i]
                                  if i < len(scene.texture_mips) else ()):
            arrays[f"texture_mips.{i}.{j}"] = _np(level)
    for name in WARP_ARRAYS:
        arrays[f"env_warp.{name}"] = _np(getattr(scene.env_warp, name))
    for i, tbl in enumerate(getattr(scene, "measured_tables", ())):
        for name in MEASURED_ARRAYS:
            arrays[f"measured_tables.{i}.{name}"] = _np(tbl[name])
        for warp in MEASURED_WARPS:
            for name in WARP_ARRAYS:
                arrays[f"measured_tables.{i}.{warp}.{name}"] = _np(
                    getattr(tbl[warp], name))
    for prefix, sensor in _sensor_prefixes(scene.sensor):
        for name in SENSOR_ARRAYS:
            if getattr(sensor, name, None) is not None:
                arrays[f"{prefix}.{name}"] = _np(getattr(sensor, name))
    acc_arrays, acc_meta = _accel_or_dense(scene.accel)
    arrays.update({f"accel.{name}": a for name, a in acc_arrays.items()})
    if getattr(scene, "instances", None) is not None:
        for name in INSTANCE_FIELDS:
            arrays[f"instances.{name}"] = _np(getattr(scene.instances, name))
    proto_meta = []
    for p, acc in enumerate(getattr(scene, "proto_accels", ())):
        acc_arrays, acc_p = _accel_or_dense(acc)
        arrays.update({f"proto_accels.{p}.{name}": a
                       for name, a in acc_arrays.items()})
        proto_meta.append(acc_p)

    meta = {name: tuple(getattr(scene, name)) if name in (
        "em_sphere_slots", "em_directional", "em_spd_slots")
        else getattr(scene, name) for name in SCENE_META}
    meta["spectral"] = bool(scene.spectral)
    meta["texture_meta"] = tuple(
        (str(w), str(f), bool(mip), tuple(float(x) for x in extra))
        for w, f, mip, extra in scene.texture_meta)
    meta["film"] = _fields(scene.film, FilmConfig)
    meta["sensor_config"] = _fields(scene.sensor_config, SensorConfig)
    # the fields of the port's config of that type (a volumetric one's
    # max_null_events and shadow_segments), not a JAX config's others
    meta["integrator"] = config_to_dict(scene.integrator)
    meta["accel"] = acc_meta
    meta["proto_accels"] = proto_meta
    meta["proto_ranges"] = tuple(tuple(int(x) for x in r)
                                 for r in getattr(scene, "proto_ranges", ()))
    meta["n_query_faces"] = int(getattr(scene, "n_query_faces", 0))
    return arrays, meta


def _accel_or_dense(acc):
    """accel_arrays of `acc`, or no arrays and kind "dense" for None."""
    return ({}, {"kind": "dense"}) if acc is None else accel_arrays(acc)


def _sensor_prefixes(sensor):
    """(array-name prefix, SensorData) per sensor: "sensor", or
    "sensor.k" for a batch sensor's k-th sub-sensor."""
    if isinstance(sensor, tuple):
        return [(f"sensor.{k}", s) for k, s in enumerate(sensor)]
    return [("sensor", sensor)]


def accel_kind(acc) -> str:
    """"cells", "serve", "tiled", "xla", "grid", "hybrid", "pallas" or
    "bvh2", from the accel's fields (a JAX or a port accel alike)."""
    for kind, marks in (("cells", ("start", "inv_cell")),
                        ("serve", ("sup", "m_pad")),
                        ("tiled", ("leaf_bounds", "scene_span")),
                        ("xla", ("parent", "is_left")),
                        ("grid", ("table", "max_steps")),
                        ("hybrid", HYBRID_SIDES),
                        ("pallas", ("node_meta", "prim_order")),
                        ("bvh2", ("bounds", "n_nodes"))):
        if all(hasattr(acc, mark) for mark in marks):
            return kind
    raise NotImplementedError(
        f"accel {type(acc).__name__} is not ported to mitsuba3_tpu_torch")


def accel_arrays(acc):
    """(arrays, meta) of an accel alone: its array fields as numpy arrays,
    its static fields and its kind (meta["kind"])."""
    kind = accel_kind(acc)
    if kind == "hybrid":
        # each side's arrays under its name, its meta in meta[side]
        arrays, meta = {}, {"kind": kind}
        for side in HYBRID_SIDES:
            side_arrays, meta[side] = accel_arrays(getattr(acc, side))
            arrays.update({f"{side}.{name}": a
                           for name, a in side_arrays.items()})
        return arrays, meta
    _, array_names, meta_names = ACCELS[kind]
    arrays = {}
    for name in array_names:
        if name == "occ" and hasattr(acc, "occ_bytes"):
            arrays[name] = unpack_occupancy(_np(acc.occ_bytes),
                                            int(acc.res) ** 3)
        else:
            arrays[name] = _np(getattr(acc, name))
    meta = {name: int(getattr(acc, name)) for name in meta_names}
    meta["kind"] = kind
    return arrays, meta


def accel_from_arrays(arrays: dict, meta: dict, device):
    """The port's accel from `accel_arrays` output, on `device`."""
    meta = dict(meta)
    kind = meta.pop("kind")
    if kind == "hybrid":
        return HybridAccel(**{side: accel_from_arrays(
            {name[len(side) + 1:]: a for name, a in arrays.items()
             if name.startswith(f"{side}.")}, meta[side], device)
            for side in HYBRID_SIDES})
    cls, array_names, _ = ACCELS[kind]
    return cls(**{name: torch.as_tensor(np.array(arrays[name]),
                                        device=device)
                  for name in array_names}, **meta)


def scene_from_arrays(arrays: dict, meta: dict, device) -> Scene:
    """Build the port's Scene from `arrays_from_scene` output on `device`."""
    def t(name):
        return torch.as_tensor(np.array(arrays[name]), device=device)

    def group(prefix, names):
        return {name: t(f"{prefix}.{name}") for name in names
                if f"{prefix}.{name}" in arrays}

    if meta["accel"]["kind"] in ATTIC:
        raise NotImplementedError(
            f"accel kind {meta['accel']['kind']!r}: no scene holds an attic "
            f"accel; use accel_from_arrays")
    sensor_cfg = SensorConfig(**meta["sensor_config"])
    if sensor_cfg.type == "batch":
        sensor = tuple(SensorData(**group(f"sensor.{k}", SENSOR_ARRAYS))
                       for k in range(len(sensor_cfg.sub_types)))
    else:
        sensor = SensorData(**group("sensor", SENSOR_ARRAYS))
    leaves = {name: t(name) for name in SCENE_ARRAYS if name in arrays}
    for name in ("de_params", "face_colors", "face_medium", "em_sphere",
                 "analytic_prims", "sdf_rows", "em_spd", "bsdf_spd"):
        leaves.setdefault(name, None)
    for name in TUPLES:
        leaves[name] = tuple(t(f"{name}.{i}") for i in range(sum(
            a.startswith(f"{name}.") for a in arrays)))
    rows = np.asarray(arrays["bsdf_params"])
    n_tex = sum(name.startswith("textures.") for name in arrays)
    mips = tuple(tuple(t(f"texture_mips.{i}.{j}") for j in range(sum(
        name.startswith(f"texture_mips.{i}.") for name in arrays)))
        for i in range(n_tex))
    acc = {name[len("accel."):]: a for name, a in arrays.items()
           if name.startswith("accel.")}
    n_measured = sum(name.startswith("measured_tables.")
                     and name.endswith(".theta_i") for name in arrays)
    measured = tuple(
        {**group(f"measured_tables.{i}", MEASURED_ARRAYS),
         **{w: SlicedMarginal2D(**group(f"measured_tables.{i}.{w}",
                                        WARP_ARRAYS))
            for w in MEASURED_WARPS}} for i in range(n_measured))
    instances = (InstanceTable(**group("instances", INSTANCE_FIELDS))
                 if "instances.proto_of" in arrays else None)
    proto_accels = tuple(
        None if pm["kind"] == "dense" else accel_from_arrays(
            {name[len(f"proto_accels.{p}."):]: a
             for name, a in arrays.items()
             if name.startswith(f"proto_accels.{p}.")}, pm, device)
        for p, pm in enumerate(meta.get("proto_accels", ())))
    return Scene(
        **leaves,
        instances=instances,
        proto_accels=proto_accels,
        proto_ranges=tuple(meta.get("proto_ranges", ())),
        n_query_faces=meta.get("n_query_faces", 0),
        env_warp=SlicedMarginal2D(**group("env_warp", WARP_ARRAYS)),
        sensor=sensor,
        accel=(None if meta["accel"]["kind"] == "dense"
               else accel_from_arrays(acc, meta["accel"], device)),
        textures=tuple(t(f"textures.{i}") for i in range(n_tex)),
        texture_mips=mips,
        measured_tables=measured,
        **bsdfs.dispatch_tables(meta["bsdf_types"], rows, reached_slots(
            arrays["face_bsdf"], arrays["face_shape"],
            arrays.get("analytic_prims"), arrays.get("sdf_rows"))),
        **{name: meta[name] for name in SCENE_META},
        projector_textures=emitters.projector_textures(
            meta["delta_emitter_types"], np.asarray(arrays.get(
                "de_params", np.zeros((0, emitters.DE_ROW), np.float32)))),
        film=FilmConfig(**meta["film"]),
        sensor_config=sensor_cfg,
        integrator=config_from_dict(meta["integrator"]))
