"""Volumetric path tracer — counterpart of
``mitsuba3_tpu/integrators/volpath.py`` (src/integrators/volpath.cpp;
``volpathmis`` is the same module with spectral MIS, volpathmis.cpp).

Null collisions inside media are fused into the free-flight sampler
(``media.sample_real_interaction``), so each bounce advances one *real*
event: a medium scatter, a surface scatter or a null-surface crossing.
NEE shadow rays alternate medium transmittance and null-surface crossings
for ``shadow_segments`` closest-hit queries (volpath.cpp:400-556); a scene
without media and without null BSDFs tests them with one any-hit query.
The draw order per bounce is JAX's (free flight, NEE, shadow tracking,
scatter, Russian roulette). As in the path integrator, lanes whose path
has ended are dropped after every bounce; the loop runs at most
``max_depth`` bounces, plus ``max_null_events`` with media or null-capable
BSDFs (null crossings do not count as depth). In the spectral variant the
state carries the path's wavelengths through every bounce and into NEE,
as ``path`` does (JAX's loop drops them: ROADMAP queue 3).
"""
from __future__ import annotations

import dataclasses

import torch

from .. import bsdfs, media, phase
from ..core import math as m
from ..core.struct import struct, take_lanes
from ..core.vec import Vec3
from ..render import sampler as sampler_mod
from ..render.records import Ray
from ..render.sampler import Sampler
from .path import collapse_wavelengths, mis_weight

NO_TRANSITION = -2   # face_medium: crossing the face keeps the medium
NULL_CAPABLE = (bsdfs.NULL, bsdfs.MASK)


@dataclasses.dataclass(frozen=True)
class VolPathConfig:
    type: str = "volpath"
    max_depth: int = 8
    rr_depth: int = 5
    hide_emitters: bool = False
    max_null_events: int = 6    # bounce slack for null crossings
    shadow_segments: int = 4    # null/medium segments per NEE shadow ray


def config_from_dict(spec: dict, cls=VolPathConfig):
    return cls(type=spec.get("type", cls.type),
               max_depth=int(spec.get("max_depth", 8)),
               rr_depth=int(spec.get("rr_depth", 5)),
               hide_emitters=bool(spec.get("hide_emitters", False)),
               max_null_events=int(spec.get("max_null_events", 6)),
               shadow_segments=int(spec.get("shadow_segments", 4)))


def n_bounces(scene, cfg) -> int:
    """The bounce budget: null crossings (media boundaries, null and mask
    BSDFs) take bounces without adding depth."""
    slack = scene.has_media or bool(set(NULL_CAPABLE)
                                    & set(scene.bsdf_types))
    return cfg.max_depth + (cfg.max_null_events if slack else 0)


def update_medium(scene, si, attrs, d: Vec3, cur_medium):
    """The medium after crossing a transition face along d."""
    if not scene.has_media:
        return cur_medium
    interior = attrs["medium_interior"]
    exterior = attrs["medium_exterior"]
    is_transition = (interior != NO_TRANSITION) | (exterior != NO_TRANSITION)
    tgt = torch.clamp(scene.target_medium(si, attrs, d), min=-1)
    return torch.where(is_transition & si.is_valid(), tgt, cur_medium)


def attenuated_visibility(scene, origin: Vec3, ds, medium0, rng, channel,
                          active, n_segments: int,
                          spectral_mis: bool = False):
    """Transmittance along an NEE shadow ray: medium tracking segments
    alternating with null-surface crossings (volpath.cpp sample_emitter).
    Returns (Tr Vec3, rng, n_queries).

    Each segment runs on the lanes still open only (a lane leaves when its
    segment hits nothing, an opaque surface, or its end); every lane's
    stream advances by the draws of all segments, as JAX's does, so the
    values are JAX's. Lanes still open after the budget are occluded."""
    n = origin.x.shape[0]
    dev = origin.x.device
    remaining = ds.dist * (1.0 - m.ShadowEpsilon)
    if not scene.has_media and bsdfs.NULL not in scene.bsdf_types:
        occluded = scene.ray_test(Ray(o=origin, d=ds.d, maxt=remaining),
                                  active=active)
        return (Vec3.ones(n, dev).mask(~occluded | ~active), rng,
                int(active.sum()))
    lanes = torch.nonzero(active).squeeze(1)
    seg = take_lanes(_Segment(o=origin, d=ds.d, remaining=remaining,
                              med=medium0, channel=channel, rng=rng,
                              tr=Vec3.ones(n, dev)), lanes, n)
    n_queries = 0
    out_lanes, out_tr = [], []
    for _ in range(n_segments):
        k = lanes.shape[0]
        if k == 0:
            break
        ray = Ray(o=seg.o, d=seg.d, maxt=seg.remaining)
        si, attrs = scene.compute_surface_interaction(
            ray, scene.ray_intersect_preliminary(ray))
        n_queries += k
        hit = si.is_valid() & (si.t < seg.remaining)
        tr, sub_rng = seg.tr, seg.rng
        if scene.has_media:
            in_med = seg.med >= 0
            tr_seg, sub_rng = media.transmittance(
                scene, seg.med, seg.o, seg.d,
                torch.where(hit, si.t, seg.remaining), sub_rng, seg.channel,
                in_med, spectral_mis=spectral_mis)
            tr = tr * Vec3.where(in_med, tr_seg, 1.0)
        # a surface crossing transmits only through a null-like BSDF
        tr = Vec3.where(hit, tr * bsdfs.eval_null_transmission(
            scene, attrs["bsdf"], si), tr)
        eps = m.RayEpsilon * (1.0 + si.p.abs().max_component())
        seg = _Segment(
            o=Vec3.where(hit, si.p + seg.d * eps, seg.o), d=seg.d,
            remaining=torch.where(hit, seg.remaining - si.t - eps,
                                  seg.remaining),
            med=torch.where(hit, update_medium(scene, si, attrs, seg.d,
                                               seg.med), seg.med),
            channel=seg.channel, rng=sub_rng, tr=tr)
        go_on = hit & tr.any_positive() & (seg.remaining > 0.0)
        out_lanes.append(lanes[~go_on])
        out_tr.append(tr.to_array()[~go_on])
        keep = torch.nonzero(go_on).squeeze(1)
        seg = take_lanes(seg, keep, k)
        lanes = lanes[keep]
    # lanes never active see 1; lanes still open after the budget, 0
    full = torch.where(active, 0.0, 1.0)[:, None].expand(n, 3)
    if out_lanes:
        full = full.index_put((torch.cat(out_lanes),), torch.cat(out_tr))
    draws = media.track_steps(scene) if media.has_heterogeneous(scene) else 0
    return (Vec3(full[:, 0], full[:, 1], full[:, 2]),
            sampler_mod.advance(rng, draws * n_segments), n_queries)


@struct
class _Segment:
    """The open lanes of a shadow ray: segment origin, direction, distance
    left, medium, channel, sampler and transmittance so far."""
    o: Vec3
    d: Vec3
    remaining: torch.Tensor
    med: torch.Tensor
    channel: torch.Tensor
    rng: Sampler
    tr: Vec3


@struct
class VolPathState:
    ray_o: Vec3
    ray_d: Vec3
    wl: Vec3 | None               # the path's wavelengths (spectral variant)
    throughput: Vec3
    result: Vec3
    eta: torch.Tensor
    depth: torch.Tensor           # [N] int32
    valid_ray: torch.Tensor       # [N] bool
    medium: torch.Tensor          # [N] int32, -1 = vacuum
    channel: torch.Tensor         # [N] int32 channel of distance sampling
    prev_p: Vec3
    prev_scatter_pdf: torch.Tensor
    prev_delta: torch.Tensor      # [N] bool
    active: torch.Tensor          # [N] bool
    rng: Sampler


def sample_channel(rng):
    """The per-path RGB channel of distance sampling (volpath.cpp:118)."""
    rng, ch_u = sampler_mod.next_1d(rng)
    return rng, torch.clamp((ch_u * 3.0).to(torch.int32), max=2)


def make_bounce(scene, cfg: VolPathConfig):
    """The per-bounce body: state -> (new state, closest + shadow ray
    queries issued)."""
    has_media = scene.has_media
    mis = cfg.type == "volpathmis"

    def bounce(s: VolPathState):
        n = s.ray_o.x.shape[0]
        cur_ray = Ray.make(s.ray_o, s.ray_d, wl=s.wl)
        pi = scene.ray_intersect_preliminary(cur_ray, active=s.active)
        si, attrs = scene.compute_surface_interaction(cur_ray, pi)
        t_surf = torch.where(si.is_valid(), si.t, float("inf"))
        rng = s.rng

        # ---------------- free flight inside media ------------------
        if has_media:
            in_medium = s.active & (s.medium >= 0)
            mei, med_w, rng = media.sample_real_interaction(
                scene, s.medium, cur_ray, t_surf, rng, s.channel, in_medium,
                spectral_mis=mis)
            medium_scatter = in_medium & mei.is_valid()
            throughput = Vec3.where(in_medium, s.throughput * med_w,
                                    s.throughput)
        else:
            medium_scatter = torch.zeros_like(s.active)
            throughput = s.throughput
        on_surface = s.active & ~medium_scatter & si.is_valid()

        # ---------------- emission ----------------------------------
        emitted = scene.eval_emitter(si, attrs).mask(~medium_scatter)
        ds_pdf = torch.where(medium_scatter, 0.0,
                             scene.pdf_emitter_direction_hit(s.prev_p, si,
                                                             attrs))
        if scene.env_emitter >= 0:
            miss = ~si.is_valid() & ~medium_scatter
            emitted = Vec3.where(miss, scene.eval_env(cur_ray.d, s.wl),
                                 emitted)
            ds_pdf = torch.where(
                miss, scene.pdf_emitter_direction_miss(cur_ray.d), ds_pdf)
        em_pdf = torch.where(s.prev_delta, 0.0, ds_pdf)
        hit_emitter = emitted.any_positive()
        result = s.result + (throughput * emitted * mis_weight(
            s.prev_scatter_pdf, em_pdf)).mask(s.active & hit_emitter)
        depth_ok = (s.depth + 1) < cfg.max_depth
        valid_ray = (s.valid_ray if cfg.hide_emitters
                     else s.valid_ray | (s.active & hit_emitter))
        bsdf_idx = attrs["bsdf"]
        flags = bsdfs.lane_flags(scene.bsdf_types, bsdf_idx, scene.bsdf_flags)
        smooth = (flags & bsdfs.SMOOTH) != 0

        # ---------------- NEE ---------------------------------------
        if has_media:
            mparams = scene.gather_medium_params(s.medium)
            sample_em_med = medium_scatter & (mparams[10] > 0.5) & depth_ok
            ref_p = Vec3.where(medium_scatter, mei.p, si.p)
        else:
            sample_em_med = medium_scatter
            ref_p = si.p
        active_em = (on_surface & smooth & depth_ok) | sample_em_med
        rng, s1_em = sampler_mod.next_1d(rng)
        rng, s2_em = sampler_mod.next_2d(rng)
        ds, em_weight = scene.sample_emitter_direction_from(
            ref_p, s1_em, s2_em, wavelengths=s.wl)
        active_em = active_em & (ds.pdf > 0.0)
        # shadow origin: offset along the normal on surfaces
        origin = Vec3.where(medium_scatter, ref_p, si.offset_p(ds.d))
        med_nee = torch.where(medium_scatter, s.medium, update_medium(
            scene, si, attrs, ds.d, s.medium))
        tr_nee, rng, vis_queries = attenuated_visibility(
            scene, origin, ds, med_nee, rng, s.channel, active_em,
            cfg.shadow_segments, spectral_mis=mis)
        em_weight = em_weight * tr_nee
        bsdf_val_em, bsdf_pdf_em = bsdfs.eval_pdf(scene, bsdf_idx, si,
                                                  si.to_local(ds.d))
        if has_media:
            ph_val, ph_pdf = phase.eval_pdf(scene, s.medium, -cur_ray.d,
                                            ds.d)
            nee_val = Vec3.where(medium_scatter, Vec3(ph_val, ph_val, ph_val),
                                 bsdf_val_em)
            nee_pdf = torch.where(medium_scatter, ph_pdf, bsdf_pdf_em)
        else:
            nee_val, nee_pdf = bsdf_val_em, bsdf_pdf_em
        mis_em = torch.where(ds.delta, 1.0, mis_weight(ds.pdf, nee_pdf))
        result = result + (throughput * nee_val * em_weight * mis_em).mask(
            active_em)

        # ---------------- direction sampling ------------------------
        rng, s1_b = sampler_mod.next_1d(rng)
        rng, s2_b = sampler_mod.next_2d(rng)
        bs, bsdf_weight = bsdfs.sample(scene, bsdf_idx, si, s1_b, s2_b)
        wo_surf = si.to_world(bs.wo)
        if has_media:
            ph_wo, ph_w, ph_pdf_s = phase.sample(scene, s.medium, -cur_ray.d,
                                                 s1_b, s2_b)
            new_d = Vec3.where(medium_scatter, ph_wo, wo_surf)
            scatter_w = Vec3.where(medium_scatter, Vec3(ph_w, ph_w, ph_w),
                                   bsdf_weight)
            scatter_pdf = torch.where(medium_scatter, ph_pdf_s, bs.pdf)
        else:
            new_d, scatter_w, scatter_pdf = wo_surf, bsdf_weight, bs.pdf
        sampled_null = on_surface & ((bs.sampled_type & bsdfs.NULL_FLAG) != 0)
        real_scatter = medium_scatter | (on_surface & ~sampled_null)
        # the depth cap counts real scatters only
        cont = (s.active & (medium_scatter | on_surface)
                & (~real_scatter | depth_ok) & (scatter_pdf > 0.0))
        new_o = Vec3.where(medium_scatter, ref_p, si.offset_p(new_d))
        new_o = Vec3.where(cont, new_o, s.ray_o)
        throughput2 = Vec3.where(cont, throughput * scatter_w, throughput)
        eta = torch.where(cont & on_surface, s.eta * bs.eta, s.eta)
        wl = collapse_wavelengths(s.wl, cont & on_surface, bs, bsdf_weight)
        depth = torch.where(cont & real_scatter, s.depth + 1, s.depth)
        valid_ray = valid_ray | (cont & real_scatter)
        new_medium = torch.where(cont & on_surface, update_medium(
            scene, si, attrs, new_d, s.medium), s.medium)

        # ---------------- Russian roulette --------------------------
        tmax = throughput2.max_component()
        rr_prob = torch.clamp(tmax * m.sqr(eta), max=0.95)
        rr_active = (depth >= cfg.rr_depth) & real_scatter
        rng, rr_u = sampler_mod.next_1d(rng)
        throughput2 = Vec3.where(rr_active & cont,
                                 throughput2 * m.safe_div(1.0, rr_prob),
                                 throughput2)
        new_active = cont & (~rr_active | (rr_u < rr_prob)) & (tmax > 0.0)
        is_delta = on_surface & ((bs.sampled_type & bsdfs.DELTA) != 0)
        upd_prev = cont & real_scatter
        new_state = VolPathState(
            ray_o=new_o, ray_d=Vec3.where(cont, new_d, s.ray_d), wl=wl,
            throughput=throughput2, result=result, eta=eta, depth=depth,
            valid_ray=valid_ray, medium=new_medium, channel=s.channel,
            prev_p=Vec3.where(upd_prev, ref_p, s.prev_p),
            prev_scatter_pdf=torch.where(upd_prev, scatter_pdf,
                                         s.prev_scatter_pdf),
            prev_delta=torch.where(upd_prev, is_delta, s.prev_delta),
            active=new_active, rng=rng)
        return new_state, int(s.active.sum()) + vis_queries

    return bounce


def sample(scene, rng, ray: Ray, cfg: VolPathConfig):
    """Trace one wavefront of volumetric paths. Returns (L Vec3, valid [N],
    n_ray_queries)."""
    n = ray.o.x.shape[0]
    dev = ray.o.x.device
    L = torch.zeros((n, 3), dtype=torch.float32, device=dev)
    valid = torch.zeros(n, dtype=torch.bool, device=dev)
    if cfg.max_depth == 0:
        return Vec3(L[:, 0], L[:, 1], L[:, 2]), valid, 0
    rng, channel = sample_channel(rng)
    ones = torch.ones(n, dtype=torch.float32, device=dev)
    state = VolPathState(
        ray_o=ray.o, ray_d=ray.d, wl=ray.wl, throughput=Vec3.ones(n, dev),
        result=Vec3.zeros(n, dev), eta=ones,
        depth=torch.zeros(n, dtype=torch.int32, device=dev),
        valid_ray=torch.full((n,), scene.env_emitter >= 0
                             and not cfg.hide_emitters, device=dev),
        medium=torch.full((n,), scene.sensor_medium, dtype=torch.int32,
                          device=dev),
        channel=channel, prev_p=ray.o, prev_scatter_pdf=ones,
        prev_delta=torch.ones(n, dtype=torch.bool, device=dev),
        active=torch.ones(n, dtype=torch.bool, device=dev), rng=rng)
    lanes = torch.arange(n, device=dev)
    bounce = make_bounce(scene, cfg)
    n_rays = 0

    def retire(st, lanes_done):
        L[lanes_done] = st.result.mask(st.valid_ray).to_array()
        valid[lanes_done] = st.valid_ray

    for _ in range(n_bounces(scene, cfg)):
        state, k = bounce(state)
        n_rays += k
        # drop lanes that finished: their result no longer changes
        done = ~state.active
        if bool(done.any()):
            retire(take_lanes(state, done, lanes.shape[0]), lanes[done])
            keep = torch.nonzero(state.active).squeeze(1)
            state = take_lanes(state, keep, lanes.shape[0])
            lanes = lanes[keep]
        if lanes.shape[0] == 0:
            break
    retire(state, lanes)
    return Vec3(L[:, 0], L[:, 1], L[:, 2]), valid, n_rays
