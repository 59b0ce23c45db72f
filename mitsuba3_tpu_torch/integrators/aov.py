"""AOV integrators — counterpart of ``mitsuba3_tpu/integrators/aov.py``
(src/integrators/{depth,aov}.cpp).

``depth``: the distance to the first hit, in three equal channels.
``aov``: arbitrary output variables (depth, position, uv, geometric and
shading normals, albedo, primitive and shape index), in the order the
``aovs`` string names them, followed by a nested integrator's RGB when
one is given; the film has one channel per value. Neither draws a random
number of its own: a nested integrator sees the stream it would see
alone.
"""
from __future__ import annotations

import dataclasses

import torch

from ..core.vec import Vec3
from ..render.records import Ray
from ..render.texture import eval_color


@dataclasses.dataclass(frozen=True)
class DepthConfig:
    type: str = "depth"


def depth_n_channels(cfg):
    return 3


def depth_sample(scene, rng, ray: Ray, cfg):
    """Returns (depth Vec3, valid [N], n_ray_queries)."""
    pi = scene.ray_intersect_preliminary(ray)
    valid = pi.is_valid()
    depth = torch.where(valid, pi.t, 0.0)
    return Vec3(depth, depth, depth), valid, ray.o.x.shape[0]


AOV_SIZES = {"depth": 1, "position": 3, "uv": 2, "geo_normal": 3,
             "sh_normal": 3, "albedo": 3, "prim_index": 1, "shape_index": 1}


@dataclasses.dataclass(frozen=True)
class AOVConfig:
    type: str = "aov"
    aovs: tuple = ("depth", "sh_normal")   # ordered channel groups
    inner: object = None                    # nested integrator config or None


def config_from_dict(spec):
    if spec.get("type") == "depth":
        return DepthConfig()
    aovs = spec.get("aovs", "depth:depth")
    if isinstance(aovs, str):
        names = tuple(a.split(":")[-1].strip() for a in aovs.split(","))
    else:
        names = tuple(aovs)
    unknown = [a for a in names if a not in AOV_SIZES]
    if unknown:
        raise ValueError(f"Unknown AOV {unknown[0]!r}")
    inner = None
    if spec.get("integrator") is not None:
        from . import config_from_dict as top_config
        inner = top_config(spec["integrator"])
    return AOVConfig(type="aov", aovs=names, inner=inner)


def n_channels(cfg: AOVConfig):
    return sum(AOV_SIZES[a] for a in cfg.aovs) + (3 if cfg.inner else 0)


def _albedo(scene, bsdf_idx, si) -> Vec3:
    """diffuse.reflectance read on every lane's row, whatever its type (as
    the JAX package reads it), with every texture a row can name."""
    params = scene.gather_bsdf_params(bsdf_idx)
    ids = tuple(range(1, len(scene.textures) + 1)) + (-1,)
    return eval_color(scene, Vec3(params[0], params[1], params[2]),
                      params[3], si, ids)


def sample(scene, rng, ray: Ray, cfg: AOVConfig):
    """Returns ([N, C] channels, valid [N], n_ray_queries)."""
    pi = scene.ray_intersect_preliminary(ray)
    si, attrs = scene.compute_surface_interaction(ray, pi)
    valid = si.is_valid()
    validf = valid.to(torch.float32)
    n_rays = ray.o.x.shape[0]

    chans = []
    for a in cfg.aovs:
        if a == "depth":
            chans.append(torch.where(valid, pi.t, 0.0)[:, None])
        elif a == "position":
            chans.append((si.p * validf).to_array())
        elif a == "uv":
            chans.append(torch.stack([si.uv.x * validf, si.uv.y * validf],
                                     -1))
        elif a == "geo_normal":
            chans.append((si.n * validf).to_array())
        elif a == "sh_normal":
            chans.append((si.sh_frame.n * validf).to_array())
        elif a == "albedo":
            chans.append((_albedo(scene, attrs["bsdf"], si)
                          * validf).to_array())
        elif a == "prim_index":
            chans.append(si.prim_index.to(torch.float32)[:, None])
        else:   # shape_index
            chans.append(si.shape_index.to(torch.float32)[:, None])

    if cfg.inner is not None:
        from . import get_integrator
        L, ivalid, ir = get_integrator(cfg.inner).sample(scene, rng, ray,
                                                          cfg.inner)
        chans.append(L.to_array() if isinstance(L, Vec3) else L)
        n_rays = n_rays + ir
        valid = valid | ivalid
    return torch.cat(chans, dim=-1), valid, n_rays
