"""Sensors — counterpart of ``mitsuba3_tpu/sensors/__init__.py``
(src/sensors/{perspective, thinlens, orthographic, radiancemeter,
irradiancemeter, distant, batch}.cpp).

Camera space follows the reference (transform.h look_at: X = left,
Y = up, Z = view direction): film x grows right, which maps to -X; film y
grows down, which maps to -Y.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..core import warp
from ..core.struct import struct
from ..core.transform import Transform4f, as_transform
from ..core.vec import Vec2, Vec3
from ..render.records import Ray

TYPES = ("perspective", "thinlens", "orthographic", "radiancemeter",
         "irradiancemeter", "distant")
BATCH_SUB_TYPES = ("perspective", "thinlens", "orthographic")


@dataclasses.dataclass(frozen=True)
class SensorConfig:
    fov_axis: str = "x"
    near_clip: float = 1e-2
    far_clip: float = 1e4
    type: str = "perspective"   # one of TYPES, or "batch"
    sub_types: tuple = ()       # batch sensor: each sub-sensor's type


@struct
class SensorData:
    """tan_half_* double as the film half-extents of the orthographic and
    distant sensors; aperture and focus drive the thin lens."""
    origin: torch.Tensor      # [3]
    axis_x: torch.Tensor      # [3] camera X (left)
    axis_y: torch.Tensor      # [3] camera Y (up)
    axis_z: torch.Tensor      # [3] camera Z (view direction)
    tan_half_x: torch.Tensor  # scalar
    tan_half_y: torch.Tensor  # scalar
    aperture_radius: torch.Tensor | None = None  # scalar (thinlens.cpp)
    focus_distance: torch.Tensor | None = None   # scalar (thinlens.cpp)


def resolve_fov(fov_deg: float, fov_axis: str, width: int, height: int):
    """Return fov_x in degrees (sensor fov_axis semantics)."""
    aspect = width / height
    if fov_axis == "x":
        return fov_deg
    if fov_axis == "y":
        return np.rad2deg(2 * np.arctan(np.tan(np.deg2rad(fov_deg) / 2) * aspect))
    if fov_axis == "smaller":
        return fov_deg if aspect >= 1 else np.rad2deg(
            2 * np.arctan(np.tan(np.deg2rad(fov_deg) / 2) * aspect))
    if fov_axis == "larger":
        return fov_deg if aspect <= 1 else np.rad2deg(
            2 * np.arctan(np.tan(np.deg2rad(fov_deg) / 2) * aspect))
    if fov_axis == "diagonal":
        diag = np.sqrt(1 + aspect * aspect)
        return np.rad2deg(2 * np.arctan(np.tan(np.deg2rad(fov_deg) / 2) * aspect / diag))
    raise ValueError(f"Unknown fov_axis {fov_axis!r}")


def build_perspective(spec: dict, width: int, height: int, device):
    """Lower a sensor spec of any type in TYPES to (SensorData,
    SensorConfig)."""
    stype = spec.get("type", "perspective")
    if stype not in TYPES:
        raise NotImplementedError(f"sensor type {stype!r} is not ported")
    mtx = as_transform(spec.get("to_world", Transform4f())).matrix
    fov_axis = spec.get("fov_axis", "x")
    fov_x = resolve_fov(float(spec.get("fov", 34.0)), fov_axis, width, height)
    aspect = width / height
    if stype in ("orthographic", "distant"):
        # film extents come from the to_world scale (orthographic.cpp):
        # the axis vectors carry it
        tan_half_x = 1.0
        tan_half_y = 1.0 / aspect
    else:
        tan_half_x = np.tan(np.deg2rad(fov_x) / 2)
        tan_half_y = tan_half_x / aspect

    def f32(a):
        return torch.as_tensor(np.asarray(a, np.float32), device=device)

    data = SensorData(origin=f32(mtx[:3, 3]), axis_x=f32(mtx[:3, 0]),
                      axis_y=f32(mtx[:3, 1]), axis_z=f32(mtx[:3, 2]),
                      tan_half_x=f32(tan_half_x), tan_half_y=f32(tan_half_y),
                      aperture_radius=f32(spec.get("aperture_radius", 0.1)),
                      focus_distance=f32(spec.get("focus_distance", 1.0)))
    cfg = SensorConfig(fov_axis=fov_axis,
                       near_clip=float(spec.get("near_clip", 1e-2)),
                       far_clip=float(spec.get("far_clip", 1e4)),
                       type=stype)
    return data, cfg


def batch_subs(spec: dict) -> list:
    """The nested sub-sensor specs of a batch sensor, in order."""
    return [v for v in spec.values() if isinstance(v, dict)
            and v.get("type") in BATCH_SUB_TYPES]


def build_batch(spec: dict, width: int, height: int, device):
    """Batch sensor (src/sensors/batch.cpp): the film's columns are split
    evenly among the nested sub-sensors, rendered in one wavefront.
    Returns (tuple of SensorData, SensorConfig)."""
    subs = batch_subs(spec)
    if not subs:
        raise ValueError("batch sensor needs nested sensors")
    sub_w = width // len(subs)
    built = [build_perspective(s, sub_w, height, device) for s in subs]
    first = built[0][1]
    cfg = SensorConfig(fov_axis=first.fov_axis, near_clip=first.near_clip,
                       far_clip=first.far_clip, type="batch",
                       sub_types=tuple(s.get("type", "perspective")
                                       for s in subs))
    return tuple(b[0] for b in built), cfg


def sample_ray(sensor: SensorData, pos01, stype: str = "perspective",
               aperture_sample=None) -> Ray:
    """pos01: Vec2 film position in [0,1]^2 (x right, y down). `stype`
    selects the sensor model; `aperture_sample` (Vec2) is the thin lens's
    sample on its aperture."""
    dx = (0.5 - pos01.x) * (2.0 * sensor.tan_half_x)
    dy = (0.5 - pos01.y) * (2.0 * sensor.tan_half_y)
    ax, ay, az = sensor.axis_x, sensor.axis_y, sensor.axis_z

    def world(vx, vy, vz):
        return Vec3(ax[0] * vx + ay[0] * vy + az[0] * vz,
                    ax[1] * vx + ay[1] * vy + az[1] * vz,
                    ax[2] * vx + ay[2] * vy + az[2] * vz)

    o = Vec3(sensor.origin[0].expand_as(dx), sensor.origin[1].expand_as(dx),
             sensor.origin[2].expand_as(dx))
    if stype == "perspective":
        return Ray.make(o, world(dx, dy, torch.ones_like(dx)).normalize())
    if stype == "thinlens":
        # thinlens.cpp: a point on the lens disk; the ray passes through
        # the pinhole ray's point on the focal plane (camera z = f)
        ap = warp.square_to_uniform_disk_concentric(aperture_sample)
        px = ap.x * sensor.aperture_radius
        py = ap.y * sensor.aperture_radius
        f = sensor.focus_distance
        d = world(dx * f - px, dy * f - py, f.expand_as(dx)).normalize()
        return Ray.make(o + world(px, py, torch.zeros_like(px)), d)
    zeros = torch.zeros_like(dx)
    if stype in ("orthographic", "distant"):
        # parallel rays along +z, origins spread over the film plane
        # scaled by the to_world axes (orthographic.cpp, distant.cpp)
        return Ray.make(o + world(dx, dy, zeros),
                        world(zeros, zeros, torch.ones_like(dx)).normalize())
    if stype == "radiancemeter":
        # every sample queries the same ray (radiancemeter.cpp)
        return Ray.make(o, world(zeros, zeros,
                                 torch.ones_like(dx)).normalize())
    if stype == "irradiancemeter":
        # cosine-weighted hemisphere around +z (irradiancemeter.cpp): the
        # film position is the warp sample, so mean(image) * pi estimates
        # the irradiance
        d = warp.square_to_cosine_hemisphere(pos01)
        return Ray.make(o, world(d.x, d.y, d.z).normalize())
    raise ValueError(f"Unknown sensor type {stype!r}")


def sample_ray_batch(sensors_data: tuple, pos01, sub_types: tuple = (),
                     aperture_sample=None) -> Ray:
    """Dispatch film columns to sub-sensors (batch.cpp:20-45): sub-sensor
    index floor(x * S), local film x frac(x * S); each sub-sensor keeps
    its own camera model."""
    s_count = len(sensors_data)
    sub_types = sub_types or ("perspective",) * s_count
    xs = pos01.x * s_count
    idx = torch.clamp(xs.to(torch.int32), 0, s_count - 1)
    x_local = xs - idx
    ray = None
    for k, sd in enumerate(sensors_data):
        rk = sample_ray(sd, Vec2(x_local, pos01.y), stype=sub_types[k],
                        aperture_sample=aperture_sample)
        if ray is None:
            ray = rk
        else:
            sel = idx == k
            ray = Ray(o=Vec3.where(sel, rk.o, ray.o),
                      d=Vec3.where(sel, rk.d, ray.d), maxt=ray.maxt)
    return ray
