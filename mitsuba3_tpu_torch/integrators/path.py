"""MIS path tracer — counterpart of ``mitsuba3_tpu/integrators/path.py``.

The bounce body is the JAX package's (intersect -> direct emission with
MIS -> NEE with a deferred shadow test -> BSDF sample -> Russian
roulette) as eager tensor code. Instead of masking finished lanes for a
static bounce count, `sample` drops them after every bounce: lanes are
independent and every lane draws the same sampler dimensions each bounce,
so the estimate is unchanged. Under plain autograd the Monte Carlo
decisions are detached where JAX's (and the reference's) are: the MIS
weights, the sampled direction, the Russian-roulette probability and the
BSDF pdf carried to the next bounce.
"""
from __future__ import annotations

import dataclasses

import torch

from .. import bsdfs
from ..core import math as m
from ..core.struct import struct, take_lanes
from ..core.vec import Vec3
from ..render import sampler as sampler_mod
from ..render.records import Ray
from ..render.sampler import Sampler


@dataclasses.dataclass(frozen=True)
class PathConfig:
    type: str = "path"
    max_depth: int = 8
    rr_depth: int = 5
    hide_emitters: bool = False


def mis_weight(pdf_a, pdf_b):
    """Power heuristic (beta = 2), detached."""
    pdf_a = pdf_a * pdf_a
    pdf_b = pdf_b * pdf_b
    w = m.safe_div(pdf_a, pdf_a + pdf_b)
    return torch.where(torch.isfinite(w), w, 0.0).detach()


def collapse_wavelengths(wl, active_next, bs, bsdf_weight):
    """The path's wavelengths after a bounce: where a dispersive dielectric
    transmitted (delta transmission, the secondary channels' weight zeroed)
    the path goes on at its hero wavelength alone (None stays None)."""
    if wl is None:
        return None
    collapsed = (active_next
                 & ((bs.sampled_type & bsdfs.DELTA_TRANSMISSION) != 0)
                 & (bsdf_weight.x > 0.0) & (bsdf_weight.y == 0.0)
                 & (bsdf_weight.z == 0.0))
    return Vec3.where(collapsed, Vec3(wl.x, wl.x, wl.x), wl)


@struct
class PathState:
    ray_o: Vec3
    ray_d: Vec3
    wl: Vec3 | None              # the path's wavelengths (spectral variant)
    throughput: Vec3
    result: Vec3
    eta: torch.Tensor
    depth: torch.Tensor          # [N] int32
    valid_ray: torch.Tensor      # [N] bool
    prev_p: Vec3
    prev_bsdf_pdf: torch.Tensor
    prev_bsdf_delta: torch.Tensor  # [N] bool
    active: torch.Tensor         # [N] bool
    rng: Sampler


def init_state(scene, rng, ray: Ray, cfg: PathConfig) -> PathState:
    n = ray.o.x.shape[0]
    dev = ray.o.x.device
    return PathState(
        ray_o=ray.o, ray_d=ray.d, wl=ray.wl,
        throughput=Vec3.ones(n, dev),
        result=Vec3.zeros(n, dev),
        eta=torch.ones(n, dtype=torch.float32, device=dev),
        depth=torch.zeros(n, dtype=torch.int32, device=dev),
        valid_ray=torch.full((n,), scene.env_emitter >= 0
                             and not cfg.hide_emitters, device=dev),
        prev_p=ray.o,
        prev_bsdf_pdf=torch.ones(n, dtype=torch.float32, device=dev),
        prev_bsdf_delta=torch.ones(n, dtype=torch.bool, device=dev),
        active=torch.ones(n, dtype=torch.bool, device=dev),
        rng=rng)


def make_bounce(scene, cfg: PathConfig):
    """The per-bounce body: state -> (new state, closest + shadow ray
    queries issued)."""
    def bounce(s: PathState):
        cur_ray = Ray.make(s.ray_o, s.ray_d, wl=s.wl)
        pi = scene.ray_intersect_preliminary(cur_ray, active=s.active)
        si, attrs = scene.compute_surface_interaction(cur_ray, pi)

        # ---------------------- direct emission ----------------------
        emitted = scene.eval_emitter(si, attrs)
        ds_pdf = scene.pdf_emitter_direction_hit(s.prev_p, si, attrs)
        if scene.env_emitter >= 0:
            miss = ~si.is_valid()
            emitted = Vec3.where(miss, scene.eval_env(cur_ray.d, s.wl),
                                 emitted)
            ds_pdf = torch.where(
                miss, scene.pdf_emitter_direction_miss(cur_ray.d), ds_pdf)
        em_pdf = torch.where(s.prev_bsdf_delta, 0.0, ds_pdf)
        mis_bsdf = mis_weight(s.prev_bsdf_pdf, em_pdf)
        hit_emitter = emitted.any_positive()
        result = s.result + (s.throughput * emitted * mis_bsdf).mask(
            s.active & hit_emitter)

        active_next = (s.active & ((s.depth + 1) < cfg.max_depth)
                       & si.is_valid())
        if cfg.hide_emitters:
            valid_ray = s.valid_ray
        else:
            valid_ray = s.valid_ray | (s.active & hit_emitter)

        bsdf_idx = attrs["bsdf"]
        flags = bsdfs.lane_flags(scene.bsdf_types, bsdf_idx, scene.bsdf_flags)
        smooth = (flags & bsdfs.SMOOTH) != 0

        # ---------------------- emitter sampling (NEE) ----------------
        active_em = active_next & smooth
        rng, s1_em = sampler_mod.next_1d(s.rng)
        rng, s2_em = sampler_mod.next_2d(rng)
        ds, em_weight = scene.sample_emitter_direction(
            si, s1_em, s2_em, active=active_em, test_visibility=False)
        active_em = active_em & (ds.pdf != 0.0)
        wo_em = si.to_local(ds.d)

        # ------ BSDF * cos at the NEE direction; sample the next one ---
        rng, s1_b = sampler_mod.next_1d(rng)
        rng, s2_b = sampler_mod.next_2d(rng)
        bsdf_val_em, bsdf_pdf_em = bsdfs.eval_pdf(scene, bsdf_idx, si, wo_em)
        bs, bsdf_weight = bsdfs.sample(scene, bsdf_idx, si, s1_b, s2_b)

        # deferred shadow test: a lane whose BSDF value or emitter weight
        # is exactly zero contributes nothing and needs no query
        n_shadow = 0
        if scene.has_nee_emitters():
            vis_needed = (active_em & bsdf_val_em.any_positive()
                          & em_weight.any_positive())
            occluded = scene.ray_test(si.spawn_ray_to(ds.p),
                                      active=vis_needed)
            active_em = vis_needed & ~occluded
            n_shadow = int(vis_needed.sum())

        mis_em = torch.where(ds.delta, 1.0, mis_weight(ds.pdf, bsdf_pdf_em))
        result = result + (s.throughput * bsdf_val_em * em_weight
                           * mis_em).mask(active_em)

        # ---------------------- BSDF sampling -------------------------
        wo_world = si.to_world(bs.wo)
        wo_world = Vec3(wo_world.x.detach(), wo_world.y.detach(),
                        wo_world.z.detach())
        new_o = Vec3.where(active_next, si.offset_p(wo_world), s.ray_o)
        new_d = Vec3.where(active_next, wo_world, s.ray_d)
        throughput = Vec3.where(active_next, s.throughput * bsdf_weight,
                                s.throughput)
        wl = collapse_wavelengths(s.wl, active_next, bs, bsdf_weight)
        eta = torch.where(active_next, s.eta * bs.eta, s.eta)
        sampled_null = (bs.sampled_type & bsdfs.NULL_FLAG) != 0
        valid_ray = valid_ray | (active_next & si.is_valid() & ~sampled_null)
        depth = torch.where(si.is_valid() & s.active, s.depth + 1, s.depth)

        # ---------------------- Russian roulette -----------------------
        throughput_max = throughput.max_component()
        rr_prob = torch.clamp(throughput_max * m.sqr(eta), max=0.95).detach()
        rr_active = depth >= cfg.rr_depth
        rng, rr_sample = sampler_mod.next_1d(rng)
        rr_continue = rr_sample < rr_prob
        throughput = Vec3.where(rr_active & active_next,
                                throughput * m.safe_div(1.0, rr_prob),
                                throughput)
        new_active = (active_next & (~rr_active | rr_continue)
                      & (throughput_max != 0.0) & (bs.pdf > 0.0))

        new_state = PathState(
            ray_o=new_o, ray_d=new_d, wl=wl, throughput=throughput,
            result=result,
            eta=eta, depth=depth, valid_ray=valid_ray,
            prev_p=Vec3.where(active_next, si.p, s.prev_p),
            prev_bsdf_pdf=torch.where(active_next, bs.pdf.detach(),
                                      s.prev_bsdf_pdf),
            prev_bsdf_delta=torch.where(
                active_next, (bs.sampled_type & bsdfs.DELTA) != 0,
                s.prev_bsdf_delta),
            active=new_active, rng=rng)
        n_rays = int(s.active.sum()) + n_shadow
        return new_state, n_rays

    return bounce


def sample(scene, rng, ray: Ray, cfg: PathConfig):
    """Trace one wavefront of paths.

    Returns (L Vec3, valid [N], n_ray_queries): the last counts the
    closest-hit and shadow-ray queries issued, as the JAX package counts
    them for Mrays/s."""
    n = ray.o.x.shape[0]
    dev = ray.o.x.device
    L = torch.zeros((n, 3), dtype=torch.float32, device=dev)
    valid = torch.zeros(n, dtype=torch.bool, device=dev)
    if cfg.max_depth == 0:
        return Vec3(L[:, 0], L[:, 1], L[:, 2]), valid, 0
    state = init_state(scene, rng, ray, cfg)
    lanes = torch.arange(n, device=dev)
    bounce = make_bounce(scene, cfg)
    n_rays = 0

    def retire(st, lanes_done):
        L[lanes_done] = st.result.mask(st.valid_ray).to_array()
        valid[lanes_done] = st.valid_ray

    for _ in range(cfg.max_depth):
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
