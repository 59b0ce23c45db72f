"""Warp library — counterpart of ``mitsuba3_tpu/core/warp.py`` (the
cosine-hemisphere warp the diffuse BSDF samples with, the uniform sphere
of the isotropic phase function, the uniform cone of a sphere light's
NEE).

Functions take and return SoA ``Vec2``/``Vec3`` of ``[N]`` tensors, like
the JAX package's ``*_v`` variants.
"""
from __future__ import annotations

import torch

from .math import InvPi, InvTwoPi, Pi, TwoPi, safe_div, safe_sqrt, sqr
from .vec import Vec2, Vec3


def square_to_uniform_disk_concentric(s: Vec2) -> Vec2:
    """Shirley-Chiu low-distortion concentric disk mapping (warp.h)."""
    x = 2.0 * s.x - 1.0
    y = 2.0 * s.y - 1.0
    is_zero = (x == 0.0) & (y == 0.0)
    q13 = x.abs() < y.abs()
    r = torch.where(q13, y, x)
    rp = torch.where(q13, x, y)
    phi = 0.25 * Pi * safe_div(rp, r)
    phi = torch.where(q13, 0.5 * Pi - phi, phi)
    phi = torch.where(is_zero, 0.0, phi)
    return Vec2(r * torch.cos(phi), r * torch.sin(phi))


def square_to_cosine_hemisphere(s: Vec2) -> Vec3:
    """Low-distortion cosine-weighted hemisphere via the concentric disk."""
    p = square_to_uniform_disk_concentric(s)
    z = safe_sqrt(1.0 - p.x * p.x - p.y * p.y)
    return Vec3(p.x, p.y, z)


def square_to_cosine_hemisphere_pdf(v: Vec3):
    return torch.clamp(v.z, min=0.0) * InvPi


def square_to_uniform_sphere(s: Vec2) -> Vec3:
    z = 1.0 - 2.0 * s.y
    r = safe_sqrt(1.0 - z * z)
    phi = TwoPi * s.x
    return Vec3(r * torch.cos(phi), r * torch.sin(phi), z)


def square_to_uniform_cone(s: Vec2, cos_cutoff) -> Vec3:
    """Uniform direction in the cone around +z with cos(theta) >=
    cos_cutoff (warp.h)."""
    cos_theta = 1.0 - (1.0 - cos_cutoff) * s.y
    sin_theta = safe_sqrt(1.0 - sqr(cos_theta))
    phi = TwoPi * s.x
    return Vec3(sin_theta * torch.cos(phi), sin_theta * torch.sin(phi),
                cos_theta)


def square_to_uniform_cone_pdf(v: Vec3, cos_cutoff):
    return torch.where(v.z >= cos_cutoff, InvTwoPi / (1.0 - cos_cutoff),
                       0.0)
