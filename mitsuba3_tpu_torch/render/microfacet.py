"""Microfacet distributions — counterpart of
``mitsuba3_tpu/render/microfacet.py``.

GGX and Beckmann NDFs with Smith shadowing-masking and visible-normal
sampling (GGX by Heitz 2018; Beckmann samples its full NDF). Directions
are Vec3, roughnesses ``[N]`` tensors. ``dist_type`` is a Python int:
callers that pick the distribution per lane evaluate both and select.
"""
from __future__ import annotations

import torch

from ..core import math as m
from ..core.vec import Vec2, Vec3

GGX = 0
BECKMANN = 1


def _select(is_beckmann, ggx, bek):
    if isinstance(ggx, tuple):
        return tuple(_select(is_beckmann, a, b) for a, b in zip(ggx, bek))
    if isinstance(ggx, Vec3):
        return Vec3.where(is_beckmann, bek, ggx)
    return torch.where(is_beckmann, bek, ggx)


def per_lane(is_beckmann, fn, *args):
    """`fn(dist_type, *args)` for GGX and for Beckmann, picked per lane
    (`is_beckmann` [N] bool); outputs are tensors, Vec3 or tuples of them."""
    return _select(is_beckmann, fn(GGX, *args), fn(BECKMANN, *args))


def eval_ndf(dist_type: int, mn: Vec3, alpha_u, alpha_v):
    """D(m)."""
    ct2 = mn.z * mn.z
    x2 = mn.x * mn.x
    y2 = mn.y * mn.y
    au2 = alpha_u * alpha_u
    av2 = alpha_v * alpha_v
    if dist_type == GGX:
        tmp = x2 / au2 + y2 / av2 + ct2
        d = m.safe_div(1.0, m.Pi * alpha_u * alpha_v * tmp * tmp)
    else:
        d = m.safe_div(
            torch.exp(-(x2 / au2 + y2 / av2) / torch.clamp(ct2, min=1e-12)),
            m.Pi * alpha_u * alpha_v * ct2 * ct2)
    return torch.where(ct2 > 0.0, d, 0.0)


def smith_g1(dist_type: int, v: Vec3, mn: Vec3, alpha_u, alpha_v):
    """Monodirectional Smith shadowing G1."""
    ax = alpha_u * v.x
    ay = alpha_v * v.y
    xy_alpha_2 = ax * ax + ay * ay
    tan2 = m.safe_div(xy_alpha_2, v.z * v.z, fallback=float("inf"))
    if dist_type == GGX:
        g = 2.0 / (1.0 + torch.sqrt(1.0 + tan2))
    else:
        a = m.safe_rsqrt(tan2)
        g_low = (3.535 * a + 2.181 * a * a) / (1.0 + 2.276 * a
                                               + 2.577 * a * a)
        g = torch.where(a >= 1.6, 1.0, g_low)
    same_side = v.dot(mn) * v.z > 0.0
    g = torch.where(xy_alpha_2 == 0.0, 1.0, g)
    return torch.where(same_side, g, 0.0)


def G(dist_type: int, wi, wo, mn, alpha_u, alpha_v):
    return (smith_g1(dist_type, wi, mn, alpha_u, alpha_v)
            * smith_g1(dist_type, wo, mn, alpha_u, alpha_v))


def sample_visible(dist_type: int, wi: Vec3, sample2: Vec2, alpha_u,
                   alpha_v):
    """Sample the distribution of visible normals -> (m, pdf)."""
    # stretch wi and flip it to the upper hemisphere
    wi_p = Vec3(alpha_u * wi.x, alpha_v * wi.y, wi.z).normalize()
    sign_z = torch.where(wi_p.z >= 0.0, 1.0, -1.0)
    wi_p = wi_p * sign_z

    if dist_type == GGX:
        lensq = wi_p.x * wi_p.x + wi_p.y * wi_p.y
        safe = lensq > 1e-14
        inv_len = torch.rsqrt(torch.clamp(lensq, min=1e-14))
        t1 = Vec3(torch.where(safe, -wi_p.y * inv_len, 1.0),
                  torch.where(safe, wi_p.x * inv_len, 0.0),
                  torch.zeros_like(lensq))
        t2 = wi_p.cross(t1)
        r = m.safe_sqrt(sample2.x)
        phi = 2.0 * m.Pi * sample2.y
        p1 = r * torch.cos(phi)
        p2 = r * torch.sin(phi)
        s = 0.5 * (1.0 + wi_p.z)
        p2 = (1.0 - s) * m.safe_sqrt(1.0 - p1 * p1) + s * p2
        p3 = m.safe_sqrt(1.0 - p1 * p1 - p2 * p2)
        mn_p = t1 * p1 + t2 * p2 + wi_p * p3
    else:
        # Beckmann: the full NDF sampled, reweighted by pdf_visible
        phi = 2.0 * m.Pi * sample2.x
        tt2 = -torch.log(1.0 - torch.clamp(sample2.y, 0.0, 1.0 - 1e-7))
        ct = 1.0 / torch.sqrt(1.0 + tt2)
        st = m.safe_sqrt(1.0 - ct * ct)
        mn_p = Vec3(st * torch.cos(phi), st * torch.sin(phi), ct)

    # unstretch
    mn = Vec3(alpha_u * mn_p.x, alpha_v * mn_p.y,
              torch.clamp(mn_p.z, min=1e-6)).normalize()
    pdf = pdf_visible(dist_type, wi, mn, alpha_u, alpha_v)
    return mn, pdf


def pdf_visible(dist_type: int, wi: Vec3, mn: Vec3, alpha_u, alpha_v):
    """pdf of sample_visible: D(m) G1(wi) |wi.m| / |cos(wi)|."""
    d = eval_ndf(dist_type, mn, alpha_u, alpha_v)
    g1 = smith_g1(dist_type, wi, mn, alpha_u, alpha_v)
    return m.safe_div(d * g1 * wi.dot(mn).abs(), wi.z.abs())
