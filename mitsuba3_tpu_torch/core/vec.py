"""SoA 3-vectors/colors and 2-vectors — counterpart of ``mitsuba3_tpu/core/vec.py``.

A Vec3 is three independent ``[N]`` float32 tensors; Vec3 doubles as the
RGB spectrum type. Python scalars mix in directly (PyTorch casts them to
the tensor's float32 type, as JAX does with weak types).
"""
from __future__ import annotations

import torch

from .struct import struct

TINY = torch.finfo(torch.float32).tiny


@struct
class Vec3:
    x: torch.Tensor
    y: torch.Tensor
    z: torch.Tensor

    @staticmethod
    def zeros(n: int, device):
        z = torch.zeros(n, dtype=torch.float32, device=device)
        return Vec3(z, z, z)

    @staticmethod
    def ones(n: int, device):
        o = torch.ones(n, dtype=torch.float32, device=device)
        return Vec3(o, o, o)

    def to_array(self):
        return torch.stack([self.x, self.y, self.z], dim=-1)

    def detach(self):
        return Vec3(self.x.detach(), self.y.detach(), self.z.detach())

    def __add__(self, o):
        if isinstance(o, Vec3):
            return Vec3(self.x + o.x, self.y + o.y, self.z + o.z)
        return Vec3(self.x + o, self.y + o, self.z + o)

    __radd__ = __add__

    def __sub__(self, o):
        if isinstance(o, Vec3):
            return Vec3(self.x - o.x, self.y - o.y, self.z - o.z)
        return Vec3(self.x - o, self.y - o, self.z - o)

    def __rsub__(self, o):
        return Vec3(o - self.x, o - self.y, o - self.z)

    def __mul__(self, o):
        if isinstance(o, Vec3):
            return Vec3(self.x * o.x, self.y * o.y, self.z * o.z)
        return Vec3(self.x * o, self.y * o, self.z * o)

    __rmul__ = __mul__

    def __truediv__(self, o):
        if isinstance(o, Vec3):
            return Vec3(self.x / o.x, self.y / o.y, self.z / o.z)
        inv = 1.0 / o
        return Vec3(self.x * inv, self.y * inv, self.z * inv)

    def __neg__(self):
        return Vec3(-self.x, -self.y, -self.z)

    def dot(self, o):
        return self.x * o.x + self.y * o.y + self.z * o.z

    def cross(self, o):
        return Vec3(self.y * o.z - self.z * o.y,
                    self.z * o.x - self.x * o.z,
                    self.x * o.y - self.y * o.x)

    def squared_norm(self):
        return self.dot(self)

    def norm(self):
        return torch.sqrt(self.squared_norm())

    def normalize(self):
        return self * torch.rsqrt(torch.clamp(self.squared_norm(), min=TINY))

    def abs(self):
        return Vec3(self.x.abs(), self.y.abs(), self.z.abs())

    def max_component(self):
        return torch.maximum(self.x, torch.maximum(self.y, self.z))

    def min_component(self):
        return torch.minimum(self.x, torch.minimum(self.y, self.z))

    def mean(self):
        return (self.x + self.y + self.z) * (1.0 / 3.0)

    def maximum(self, v: float):
        return Vec3(torch.clamp(self.x, min=v), torch.clamp(self.y, min=v),
                    torch.clamp(self.z, min=v))

    def exp(self):
        return Vec3(torch.exp(self.x), torch.exp(self.y), torch.exp(self.z))

    def any_positive(self):
        return (self.x > 0.0) | (self.y > 0.0) | (self.z > 0.0)

    @staticmethod
    def where(mask, a: "Vec3", b):
        if not isinstance(b, Vec3):
            return Vec3(torch.where(mask, a.x, b), torch.where(mask, a.y, b),
                        torch.where(mask, a.z, b))
        return Vec3(torch.where(mask, a.x, b.x), torch.where(mask, a.y, b.y),
                    torch.where(mask, a.z, b.z))

    def mask(self, mask):
        """Zero out lanes where mask is False."""
        return Vec3(torch.where(mask, self.x, 0.0),
                    torch.where(mask, self.y, 0.0),
                    torch.where(mask, self.z, 0.0))


@struct
class Vec2:
    x: torch.Tensor
    y: torch.Tensor
