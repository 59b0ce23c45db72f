"""Moment integrator — counterpart of ``mitsuba3_tpu/integrators/moment.py``
(src/integrators/moment.cpp).

Wraps a nested integrator and writes, beside its RGB, the sample's CIE
XYZ color and the XYZ's square as extra channels: [R, G, B, X, Y, Z, m2X,
m2Y, m2Z]. The film's per-pixel mean of m2 less the squared mean of XYZ
is the sample variance that the Z-test image regression reads
(``tests/test_regression.py``).
"""
from __future__ import annotations

import dataclasses

import torch

from ..core.vec import Vec3


@dataclasses.dataclass(frozen=True)
class MomentConfig:
    type: str = "moment"
    nested: object = None   # nested integrator config


def config_from_dict(spec: dict):
    """The nested integrator is the spec's first dict value with a
    ``type`` (``path`` if it has none)."""
    from . import config_from_dict as cfd
    nested_spec = next((v for v in spec.values()
                        if isinstance(v, dict) and "type" in v),
                       {"type": "path"})
    return MomentConfig(type="moment", nested=cfd(nested_spec))


def n_channels(cfg: MomentConfig):
    return 9


def _srgb_to_xyz(c: Vec3) -> Vec3:
    """Linear sRGB -> CIE XYZ (srgb.cpp's conversion matrix)."""
    return Vec3(0.412453 * c.x + 0.357580 * c.y + 0.180423 * c.z,
                0.212671 * c.x + 0.715160 * c.y + 0.072169 * c.z,
                0.019334 * c.x + 0.119193 * c.y + 0.950227 * c.z)


def sample(scene, rng, ray, cfg: MomentConfig):
    """Returns ([N, 9] channels, valid [N], n_ray_queries)."""
    from . import get_integrator
    L, valid, n_rays = get_integrator(cfg.nested).sample(scene, rng, ray,
                                                         cfg.nested)
    rgb = L if isinstance(L, Vec3) else Vec3(L[:, 0], L[:, 1], L[:, 2])
    xyz = _srgb_to_xyz(rgb)
    m2 = xyz * xyz
    out = torch.stack([rgb.x, rgb.y, rgb.z, xyz.x, xyz.y, xyz.z,
                       m2.x, m2.y, m2.z], dim=-1)
    return out, valid, n_rays
