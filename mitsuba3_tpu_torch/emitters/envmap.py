"""Environment emitter — counterpart of ``mitsuba3_tpu/emitters/envmap.py``
(the port loads the ``constant`` environment, a small uniform map).

Direction convention (envmap.cpp eval, Y-up): world dir d ->
  u = atan2(d_x, -d_z) / 2pi (+wrap), v = acos(d_y) / pi.
"""
from __future__ import annotations

import numpy as np
import torch

from ..core import math as m
from ..core.distr2d import SlicedMarginal2D
from ..core.gather import take_rows
from ..core.spectrum import LUMINANCE_WEIGHTS
from ..core.vec import Vec2, Vec3


def build_tables(data: np.ndarray, device) -> SlicedMarginal2D:
    """Host-side: [He, We, 3] radiance -> warp over the sin(theta)-weighted
    luminance (solid-angle measure)."""
    he = data.shape[0]
    lum = np.asarray(data)[..., :3] @ LUMINANCE_WEIGHTS
    theta = (np.arange(he) + 0.5) / he * np.pi
    w = np.maximum(lum * np.sin(theta)[:, None], 0.0)
    if w.sum() <= 0:
        w = np.ones_like(w)
    return SlicedMarginal2D.from_data(w[None], device)


def dir_to_uv(d: Vec3) -> Vec2:
    u = torch.atan2(d.x, -d.z) * m.InvTwoPi
    u = torch.where(u < 0.0, u + 1.0, u)
    v = m.safe_acos(d.y) * m.InvPi
    return Vec2(u, v)


def uv_to_dir(uv: Vec2) -> Vec3:
    phi = uv.x * m.TwoPi
    theta = uv.y * m.Pi
    st = torch.sin(theta)
    return Vec3(st * torch.sin(phi), torch.cos(theta), -st * torch.cos(phi))


def eval_env(scene, d: Vec3) -> Vec3:
    """Radiance arriving from direction d (bilinear over env_data)."""
    if scene.env_emitter < 0:
        return Vec3.zeros(d.x.shape[0], d.x.device)
    data = scene.env_data
    he, we = data.shape[0], data.shape[1]
    uv = dir_to_uv(d)
    x = uv.x * we - 0.5
    y = uv.y * he - 0.5
    x0f = torch.floor(x)
    y0f = torch.floor(y)
    fx = x - x0f
    fy = y - y0f
    x0 = x0f.to(torch.int32) % we
    x1 = (x0f.to(torch.int32) + 1) % we
    y0 = torch.clamp(y0f.to(torch.int32), 0, he - 1)
    y1 = torch.clamp(y0f.to(torch.int32) + 1, 0, he - 1)
    flat = data.reshape(he * we, 3)

    def fetch(iy, ix):
        r = take_rows(flat, iy * we + ix)
        return Vec3(r[:, 0], r[:, 1], r[:, 2])

    out = (fetch(y0, x0) * ((1 - fx) * (1 - fy))
           + fetch(y0, x1) * (fx * (1 - fy))
           + fetch(y1, x0) * ((1 - fx) * fy)
           + fetch(y1, x1) * (fx * fy))
    return out * scene.env_scale


def pdf_env_dir(scene, d: Vec3):
    """Solid-angle pdf of sample_env_dir for direction d: unit-square
    density / (2 pi^2 sin(theta))."""
    uv = dir_to_uv(d)
    k = torch.zeros_like(uv.x, dtype=torch.int64)
    dens = scene.env_warp.eval(k, uv)
    sin_theta = torch.clamp(torch.sin(uv.y * m.Pi), min=1e-8)
    return dens / (2.0 * m.Pi * m.Pi * sin_theta)


def sample_env_dir(scene, s1, s2: Vec2):
    """Importance-sample a direction from the environment.
    Returns (d Vec3, pdf [N], radiance Vec3)."""
    k = torch.zeros_like(s1, dtype=torch.int64)
    pos, dens = scene.env_warp.sample(k, Vec2(s2.x, s1))
    d = uv_to_dir(pos)
    sin_theta = torch.clamp(torch.sin(pos.y * m.Pi), min=1e-8)
    pdf = dens / (2.0 * m.Pi * m.Pi * sin_theta)
    return d, pdf, eval_env(scene, d)
