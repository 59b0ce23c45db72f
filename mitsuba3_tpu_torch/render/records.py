"""Interaction/sample records — counterpart of
``mitsuba3_tpu/render/records.py``.

Records are dataclasses of SoA ``[N]`` tensors (vectors as ``Vec3``).
"""
from __future__ import annotations

import torch

from ..core import math as m
from ..core.frame import Frame
from ..core.struct import struct
from ..core.vec import Vec2, Vec3


@struct
class Ray:
    """o, d, maxt; `wl` the path's three wavelengths in the spectral
    variant (None in RGB)."""
    o: Vec3
    d: Vec3
    maxt: torch.Tensor
    wl: Vec3 | None = None

    @staticmethod
    def make(o: Vec3, d: Vec3, maxt=None, wl=None):
        if maxt is None:
            maxt = torch.full_like(o.x, float("inf"))
        return Ray(o=o, d=d, maxt=maxt, wl=wl)

    def at(self, t):
        return self.o + self.d * t


@struct
class PreliminaryIntersection:
    """Distance + primitive id + barycentrics; shape_index -1 = miss.
    instance_index: the instance of an instanced hit (-1 on other lanes),
    None in a scene without instances."""
    t: torch.Tensor
    prim_uv: Vec2
    prim_index: torch.Tensor
    shape_index: torch.Tensor
    instance_index: torch.Tensor | None = None

    def is_valid(self):
        return self.shape_index >= 0


@struct
class SurfaceInteraction:
    p: Vec3
    t: torch.Tensor
    n: Vec3                   # geometric normal
    sh_frame: Frame           # shading frame
    uv: Vec2
    wi: Vec3                  # incident direction, local shading frame
    shape_index: torch.Tensor
    prim_index: torch.Tensor
    wavelengths: Vec3 | None = None   # the path's three wavelengths
    #                                   (spectral variant); None in RGB
    vcolor: Vec3 | None = None        # interpolated vertex color
    #                                   (mesh_attribute.cpp); None unused
    duv_scale: torch.Tensor | None = None  # |duv|/|dp|, the mip LOD input;
    #                                   None without a mipmapped texture

    def is_valid(self):
        return self.shape_index >= 0

    def to_world(self, v: Vec3) -> Vec3:
        return self.sh_frame.to_world(v)

    def to_local(self, v: Vec3) -> Vec3:
        return self.sh_frame.to_local(v)

    def offset_p(self, d: Vec3) -> Vec3:
        """Spawned-ray origin: offset along the geometric normal by a
        scale-aware epsilon (si.spawn_ray / offset_ray)."""
        mag = 1.0 + self.p.abs().max_component()
        eps = m.RayEpsilon * mag
        sgn = torch.where(self.n.dot(d) >= 0.0, eps, -eps)
        return self.p + self.n * sgn

    def spawn_ray(self, d: Vec3) -> Ray:
        return Ray.make(self.offset_p(d), d)

    def spawn_ray_to(self, p: Vec3) -> Ray:
        """Shadow ray toward p with maxt short of the endpoint."""
        o = self.offset_p(p - self.p)
        d = p - o
        dist = d.norm()
        d = d * (1.0 / torch.clamp(dist, min=1e-20))
        maxt = dist * (1.0 - m.ShadowEpsilon)
        return Ray(o=o, d=d, maxt=maxt)


@struct
class DirectionSample:
    """Position + direction from a reference point, solid-angle pdf."""
    p: Vec3
    n: Vec3
    uv: Vec2
    pdf: torch.Tensor
    delta: torch.Tensor
    d: Vec3
    dist: torch.Tensor
    emitter_index: torch.Tensor
    prim_index: torch.Tensor


@struct
class BSDFSample:
    wo: Vec3                          # local frame
    pdf: torch.Tensor
    eta: torch.Tensor
    sampled_type: torch.Tensor        # int32 BSDFFlags of the sampled lobe
    sampled_component: torch.Tensor
