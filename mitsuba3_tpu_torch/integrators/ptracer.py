"""Adjoint particle tracer — counterpart of ``mitsuba3_tpu/integrators/ptracer.py``
(src/integrators/ptracer.cpp): paths start on the area emitters and every
vertex is connected to the perspective sensor and splatted onto the film.

A pass traces at most ``max_wavefront`` light paths; its streams are
seeded by lane index (``sampler.seed_lanes``), its pass seed wraps to 32
bits (``render/integrator.py:pass_seed``). Where JAX computes the seed
``seed ^ (i * 0x9E3779B9)`` unmasked, its third pass already raises
(ROADMAP queue 3); passes 0 and 1 are seeded alike in both packages.

The splat is a scatter-add of the in-range lanes into the flat film
(``index_add_``), JAX's ``image.at[flat].add(..., mode="drop")``. On the
card it is atomic, so its order of summation is not fixed: two runs on
the card agree to float32 rounding, not bit for bit. Lanes whose path has
ended are dropped after each bounce: they splat nothing more.
"""
from __future__ import annotations

import dataclasses

import torch

from .. import bsdfs
from ..core import math as m
from ..core.distr import pick
from ..core.frame import Frame
from ..core.struct import struct, take_lanes
from ..core.vec import Vec2, Vec3
from ..core.warp import square_to_cosine_hemisphere
from ..render import sampler as sampler_mod
from ..render.film import film_full
from ..render.records import Ray
from ..render.sampler import Sampler


@dataclasses.dataclass(frozen=True)
class PTracerConfig:
    type: str = "ptracer"
    max_depth: int = 8
    rr_depth: int = 5
    hide_emitters: bool = False


def config_from_dict(spec):
    return PTracerConfig(type="ptracer",
                         max_depth=int(spec.get("max_depth", 8)),
                         rr_depth=int(spec.get("rr_depth", 5)))


def sensor_direction(scene, p: Vec3):
    """Project world points onto the film: (uv on the full film, unit
    direction sensor -> p, distance, importance weight W = 1 / (A cos^3
    theta dist^2) on the film, on-film mask) (perspective.cpp
    sample_direction)."""
    sd = scene.sensor
    dx, dy, dz = p.x - sd.origin[0], p.y - sd.origin[1], p.z - sd.origin[2]
    ax, ay, az = sd.axis_x, sd.axis_y, sd.axis_z
    cx = ax[0] * dx + ax[1] * dy + ax[2] * dz
    cy = ay[0] * dx + ay[1] * dy + ay[2] * dz
    cz = az[0] * dx + az[1] * dy + az[2] * dz
    in_front = cz > 1e-6
    czs = torch.where(in_front, cz, 1.0)
    # film coordinates: the inverse of the sensor's ray mapping
    u = 0.5 - (cx / czs) / (2.0 * sd.tan_half_x)
    v = 0.5 - (cy / czs) / (2.0 * sd.tan_half_y)
    on_film = in_front & (u >= 0) & (u < 1) & (v >= 0) & (v < 1)
    dist2 = dx * dx + dy * dy + dz * dz
    dist = torch.sqrt(torch.clamp(dist2, min=1e-20))
    inv_dist = 1.0 / dist
    d = Vec3(dx * inv_dist, dy * inv_dist, dz * inv_dist)
    cos_theta = cz * inv_dist
    area = 4.0 * sd.tan_half_x * sd.tan_half_y
    weight = m.safe_div(1.0, area * (cos_theta * cos_theta * cos_theta)
                        * dist2)
    return Vec2(u, v), d, dist, torch.where(on_film, weight, 0.0), on_film


def sample_emitter_ray(scene, rng):
    """A position and direction from the area emitters
    (scene.cpp sample_emitter_ray): an emissive triangle by the area CDF,
    a uniform point on it, a cosine-weighted direction (the normal for a
    directionalarea emitter). Returns (ray, weight Vec3, p, n, radiance,
    positional pdf, rng)."""
    rng, s_sel = sampler_mod.next_1d(rng)
    rng, s_pos = sampler_mod.next_2d(rng)
    rng, s_dir = sampler_mod.next_2d(rng)
    if scene.ef_face.shape[0] == 0:
        raise NotImplementedError(
            "ptracer needs an area emitter (an environment-only scene is "
            "not traced by the JAX package either)")
    e_total = max(scene.n_emitters, 1)
    cdf = scene.ef_cdf / torch.clamp(scene.ef_cdf[-1], min=1e-9)
    face = scene.ef_face[pick(cdf, s_sel).long()]
    a = scene.gather_face_attrs(face)
    fp0 = Vec3(a[0], a[1], a[2])
    fe1 = Vec3(a[3], a[4], a[5])
    fe2 = Vec3(a[6], a[7], a[8])
    tsq = m.safe_sqrt(1.0 - s_pos.x)
    b1 = 1.0 - tsq
    b2 = tsq * s_pos.y
    p = fp0 + fe1 * b1 + fe2 * b2
    ng = fe1.cross(fe2).normalize()
    # (1/E)(1/A_em), renormalised over the area emitters (the environment
    # is not sampled here)
    pdf_area = a[15] / e_total
    pdf_area = pdf_area / torch.clamp(scene.ef_cdf[-1], min=1e-9) * 1.0
    d = Frame.from_normal(ng).to_world(square_to_cosine_hemisphere(s_dir))
    em_idx = torch.round(a[16]).to(torch.int32)
    radiance = scene.gather_em_radiance(em_idx)
    # Le cos / (pdf_pos pdf_dir), pdf_dir = cos / pi
    weight = radiance * (m.Pi * m.safe_div(1.0, pdf_area))
    if scene.em_directional:
        # directionalarea.cpp sample_ray: d = n, no direction pdf
        is_dir = torch.zeros_like(em_idx, dtype=torch.bool)
        for slot in scene.em_directional:
            is_dir = is_dir | (em_idx == slot)
        d = Vec3.where(is_dir, ng, d)
        weight = Vec3.where(is_dir, radiance * m.safe_div(1.0, pdf_area),
                            weight)
    eps = m.RayEpsilon * (1.0 + p.abs().max_component())
    return Ray.make(p + ng * eps, d), weight, p, ng, radiance, pdf_area, rng


def sample(scene, rng, ray_unused, cfg: PTracerConfig):
    raise NotImplementedError(
        "ptracer splats to the film directly; use render_ptracer()")


@struct
class _LightPath:
    o: Vec3
    d: Vec3
    beta: Vec3
    rng: Sampler


def _splat(scene, image, uv: Vec2, contrib: Vec3, ok):
    """Add the lanes' contributions at film position uv (on the full film;
    the raster is the crop) into the flat image, dropping lanes outside
    the crop."""
    w, h = scene.film.width, scene.film.height
    fw, fh, cox, coy = film_full(scene.film)
    px = (uv.x * fw).to(torch.int32) - cox
    py = (uv.y * fh).to(torch.int32) - coy
    ok = ok & (px >= 0) & (px < w) & (py >= 0) & (py < h)
    lanes = torch.nonzero(ok).squeeze(1)
    flat = (py * w + px)[lanes].long()
    image.index_add_(0, flat, contrib.to_array()[lanes])


def _trace_pass(scene, seed_value: int, n: int, cfg):
    """One pass of `n` light paths -> the flat film [h * w, 3] of its
    splats."""
    dev = scene.device
    w, h = scene.film.width, scene.film.height
    image = torch.zeros((h * w, 3), dtype=torch.float32, device=dev)
    rng = sampler_mod.seed_lanes(seed_value, n, dev)
    ray, beta0, p0, ng0, radiance, pdf_area, rng = sample_emitter_ray(
        scene, rng)

    # connect the emitter vertex itself to the sensor
    uv, d_to_cam, dist, wgt, on_film = sensor_direction(scene, p0)
    cos_em = ng0.dot(-d_to_cam)
    vis_ray = Ray(o=p0 + ng0 * 1e-4, d=-d_to_cam,
                  maxt=dist * (1.0 - m.ShadowEpsilon))
    occluded = scene.ray_test(vis_ray, active=on_film)
    contrib0 = radiance * (torch.where(cos_em > 0, cos_em, 0.0) * wgt
                           * m.safe_div(1.0, pdf_area))
    _splat(scene, image, uv, contrib0, on_film & ~occluded & (cos_em > 0))

    origin = scene.sensor.origin
    st = _LightPath(o=ray.o, d=ray.d, beta=beta0, rng=rng)
    for k in range(cfg.max_depth):
        r = Ray.make(st.o, st.d)
        pi = scene.ray_intersect_preliminary(r)
        si, attrs = scene.compute_surface_interaction(r, pi)
        alive = si.is_valid()

        # connect to the sensor through the BSDF
        uv, d_cam, dist, wgt, on_film = sensor_direction(scene, si.p)
        bsdf_val, _ = bsdfs.eval_pdf(scene, attrs["bsdf"], si,
                                     si.to_local(-d_cam))
        zero = torch.zeros_like(si.p.x)
        vray = si.spawn_ray_to(Vec3(origin[0] + zero, origin[1] + zero,
                                    origin[2] + zero))
        occ = scene.ray_test(vray, active=alive & on_film)
        _splat(scene, image, uv, st.beta * bsdf_val * wgt,
               alive & on_film & ~occ)

        # continue the path
        rng, s1 = sampler_mod.next_1d(st.rng)
        rng, s2 = sampler_mod.next_2d(rng)
        bs, bw = bsdfs.sample(scene, attrs["bsdf"], si, s1, s2)
        beta = Vec3.where(alive, st.beta * bw, st.beta)
        wo = si.to_world(bs.wo)
        o = Vec3.where(alive, si.offset_p(wo), st.o)
        d = Vec3.where(alive, wo, st.d)
        rng, rr = sampler_mod.next_1d(rng)
        bmax = beta.max_component()
        rr_p = torch.clamp(bmax, max=0.95)
        cont = (k < cfg.rr_depth) | (rr < rr_p)
        if k >= cfg.rr_depth:
            beta = Vec3.where(alive, beta * m.safe_div(1.0, rr_p), beta)
        keep = torch.nonzero(alive & cont & (bmax > 0)
                             & (bs.pdf > 0)).squeeze(1)
        st = take_lanes(_LightPath(o=o, d=d, beta=beta, rng=rng), keep,
                        o.x.shape[0])
        if keep.shape[0] == 0:
            break
    return image


def render_ptracer(scene, seed=0, spp=None, max_wavefront=1 << 19):
    """The particle-traced image [H, W, 3] (film measure): fw * fh * spp
    light paths over the full film (a crop keeps the full film's path
    density), in passes of at most `max_wavefront` paths."""
    from ..render.integrator import pass_seed
    w, h = scene.film.width, scene.film.height
    fw, fh, _, _ = film_full(scene.film)
    spp = spp if spp is not None else scene.spp
    n_total = fw * fh * spp
    n = min(n_total, max_wavefront)
    n_passes = max(1, n_total // n)
    image = torch.zeros((h * w, 3), dtype=torch.float32, device=scene.device)
    for i in range(n_passes):
        image = image + _trace_pass(scene, pass_seed(seed, i), n,
                                    scene.integrator)
    # per-pixel radiance: the importance W is normalised over the full
    # film, a pixel's solid angle is 1 / (fw fh) of it
    return (image / (n_passes * n) * (fw * fh)).reshape(h, w, 3)
