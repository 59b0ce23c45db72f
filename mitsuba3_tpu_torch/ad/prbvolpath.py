"""Volumetric path replay backpropagation — counterpart of
``mitsuba3_tpu/ad/prbvolpath.py`` (src/python/python/ad/integrators/
prbvolpath.py: PRB through participating media, detached sampling).

The two passes of ``ad/prb.py``: a primal records each sample's radiance
L with every decision detached; the backward replays the same path (the
same PCG32 stream: every tracking loop draws a fixed number of samples per
bounce on every lane, so the streams stay aligned) and per bounce takes a
local gradient of

    Lo(θ) = med_rel(θ) · (Le(θ) + Lr_dir(θ) + L_rem · scatter_rel(θ))

where ``med_rel`` is the relative free-flight weight of the bounce's
medium events (attached numerators over detached decisions,
``media.sample_real_interaction``), ``Lr_dir`` carries the ratio-tracked
NEE transmittance attached to θ, and ``scatter_rel`` is the phase, BSDF or
null-transmission value over its detached value.

θ is ``DIFF_PARAM_NAMES``: BSDF rows, textures, emitter and environment
radiance, medium rows (sigma_t, albedo, HG g, ...) and density grids. A
grid's lookups read its cell table (``media.cell_table``); the replay
builds the table once per pass as a leaf that every bounce shares and
sends its summed gradient back through the table's build at the end of
the pass, as it does for the textures' quad tables. Like the other
integrators, the loop drops lanes whose path has ended; in the spectral
variant it carries the path's wavelengths (JAX's drops them: ROADMAP
queue 3).
"""
from __future__ import annotations

import dataclasses

import torch

from .. import bsdfs, media, phase
from ..core import math as m
from ..core.struct import struct, take_lanes
from ..core.vec import Vec3
from ..integrators.path import collapse_wavelengths, mis_weight
from ..integrators.volpath import (attenuated_visibility, n_bounces,
                                   sample_channel, update_medium)
from ..render import sampler as sampler_mod
from ..render import texture as tex_mod
from ..render.records import Ray
from ..render.sampler import Sampler
from . import prb


@dataclasses.dataclass(frozen=True)
class PRBVolpathConfig:
    type: str = "prbvolpath"
    max_depth: int = 8
    rr_depth: int = 5
    hide_emitters: bool = False
    max_null_events: int = 6
    shadow_segments: int = 4


DIFF_PARAM_NAMES = ("bsdf_params", "em_radiance", "textures", "env_data",
                    "medium_params", "medium_grids")


@struct
class VPState:
    ray_o: Vec3
    ray_d: Vec3
    wl: Vec3 | None          # the path's wavelengths (spectral variant)
    L: Vec3                  # primal: accumulates up; backward: counts down
    beta: Vec3
    eta: torch.Tensor
    depth: torch.Tensor      # [N] int32
    medium: torch.Tensor     # [N] int32
    channel: torch.Tensor    # [N] int32
    active: torch.Tensor     # [N] bool
    prev_p: Vec3
    prev_pdf: torch.Tensor
    prev_delta: torch.Tensor
    rng: Sampler
    dL: Vec3 | None          # backward: the adjoint of each lane's L


def _cell_leaves(grids):
    """For each density-grid leaf read through a cell table: (grid, a
    cell-table leaf registered as its table)."""
    out = []
    for g in grids:
        if min(g.shape) >= 2:
            cells = media.build_cells(g.detach()).requires_grad_(True)
            media.register_cells(g, cells)
            out.append((g, cells))
    return out


def _rel3(a: Vec3, det: Vec3, fallback: float) -> Vec3:
    return Vec3(m.safe_div(a.x, det.x, fallback=fallback),
                m.safe_div(a.y, det.y, fallback=fallback),
                m.safe_div(a.z, det.z, fallback=fallback))


def _loop(scene, rng, ray, cfg: PRBVolpathConfig, mode: str, dL=None,
          L_in=None, theta=None):
    """The shared primal / backward bounce loop (``ad/prb.py:_loop``'s
    contract). Returns (L Vec3 [N], valid [N], n_rays, grads)."""
    primal = mode == "primal"
    has_media = scene.has_media
    n = ray.o.x.shape[0]
    dev = ray.o.x.device
    rng, channel = sample_channel(rng)
    ones = torch.ones(n, dtype=torch.float32, device=dev)
    state = VPState(
        ray_o=ray.o, ray_d=ray.d, wl=ray.wl,
        L=Vec3.zeros(n, dev) if primal else L_in,
        beta=Vec3.ones(n, dev), eta=ones,
        depth=torch.zeros(n, dtype=torch.int32, device=dev),
        medium=torch.full((n,), scene.sensor_medium, dtype=torch.int32,
                          device=dev),
        channel=channel,
        active=torch.ones(n, dtype=torch.bool, device=dev),
        prev_p=ray.o, prev_pdf=ones,
        prev_delta=torch.ones(n, dtype=torch.bool, device=dev),
        rng=rng, dL=None if primal else dL)
    leaves, flat = prb._theta_leaves(theta or {})
    quads = prb._quad_leaves(scene, leaves.get("textures", ()))
    cells = _cell_leaves(leaves.get("medium_grids", ()))
    diff = flat + [q for _, _, q in quads] + [c for _, c in cells]
    grad_acc = [torch.zeros_like(leaf) for leaf in diff]
    L_out = torch.zeros((n, 3), dtype=torch.float32, device=dev)
    valid = torch.zeros(n, dtype=torch.bool, device=dev)
    lanes = torch.arange(n, device=dev)
    n_rays = 0

    def bounce(s: VPState):
        n = s.ray_o.x.shape[0]
        cur_ray = Ray.make(s.ray_o, s.ray_d, wl=s.wl)
        pi = scene.ray_intersect_preliminary(cur_ray, active=s.active)
        si, attrs = scene.compute_surface_interaction(cur_ray, pi)
        t_surf = torch.where(si.is_valid(), si.t, float("inf"))

        # ---------------- medium free flight (detached) -------------
        rng_med = s.rng     # replayed attached in local_contrib
        rng = rng_med
        in_medium = s.active & (s.medium >= 0)
        if has_media:
            mei, med_w_det, rng = media.sample_real_interaction(
                scene, s.medium, cur_ray, t_surf, rng, s.channel, in_medium)
            medium_scatter = in_medium & mei.is_valid()
            beta_med = Vec3.where(in_medium, s.beta * med_w_det, s.beta)
        else:
            medium_scatter = torch.zeros_like(s.active)
            beta_med = s.beta
        on_surface = s.active & ~medium_scatter & si.is_valid()

        # ---------------- emission (detached) -----------------------
        miss = ~si.is_valid() & ~medium_scatter
        emitted_det = scene.eval_emitter(si, attrs).mask(~medium_scatter)
        ds_pdf = torch.where(medium_scatter, 0.0,
                             scene.pdf_emitter_direction_hit(s.prev_p, si,
                                                             attrs))
        if scene.env_emitter >= 0:
            emitted_det = Vec3.where(miss, scene.eval_env(cur_ray.d, s.wl),
                                     emitted_det)
            ds_pdf = torch.where(
                miss, scene.pdf_emitter_direction_miss(cur_ray.d), ds_pdf)
        mis = mis_weight(s.prev_pdf, torch.where(s.prev_delta, 0.0, ds_pdf))
        Le_det = (beta_med * emitted_det * mis).mask(s.active)
        depth_ok = (s.depth + 1) < cfg.max_depth
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
        ds, em_weight_det = scene.sample_emitter_direction_from(
            ref_p, s1_em, s2_em, wavelengths=s.wl)
        active_em = active_em & (ds.pdf > 0.0)
        origin = Vec3.where(medium_scatter, ref_p, si.offset_p(ds.d))
        med_nee = torch.where(medium_scatter, s.medium, update_medium(
            scene, si, attrs, ds.d, s.medium))
        rng_vis = rng       # replayed attached in local_contrib
        tr_det, rng, vis_q = attenuated_visibility(
            scene, origin, ds, med_nee, rng, s.channel, active_em,
            cfg.shadow_segments)
        wo_em = si.to_local(ds.d)
        bsdf_val_em_det, bsdf_pdf_em = bsdfs.eval_pdf(scene, bsdf_idx, si,
                                                      wo_em)
        if has_media:
            ph_val_det, ph_pdf = phase.eval_pdf(scene, s.medium, -cur_ray.d,
                                                ds.d)
            nee_val_det = Vec3.where(medium_scatter, Vec3(
                ph_val_det, ph_val_det, ph_val_det), bsdf_val_em_det)
            nee_pdf = torch.where(medium_scatter, ph_pdf, bsdf_pdf_em)
        else:
            nee_val_det, nee_pdf = bsdf_val_em_det, bsdf_pdf_em
        mis_em = torch.where(ds.delta, 1.0, mis_weight(ds.pdf, nee_pdf))
        Lr_dir_det = (beta_med * nee_val_det * em_weight_det * tr_det
                      * mis_em).mask(active_em)

        # ---------------- scatter sampling --------------------------
        rng, s1_b = sampler_mod.next_1d(rng)
        rng, s2_b = sampler_mod.next_2d(rng)
        bs, bsdf_weight_det = bsdfs.sample(scene, bsdf_idx, si, s1_b, s2_b)
        wo_surf = si.to_world(bs.wo)
        if has_media:
            ph_wo, ph_w, ph_pdf_s = phase.sample(scene, s.medium, -cur_ray.d,
                                                 s1_b, s2_b)
            new_d = Vec3.where(medium_scatter, ph_wo, wo_surf)
            scatter_w_det = Vec3.where(medium_scatter, Vec3(ph_w, ph_w, ph_w),
                                       bsdf_weight_det)
            scatter_pdf = torch.where(medium_scatter, ph_pdf_s, bs.pdf)
        else:
            new_d, scatter_w_det, scatter_pdf = (wo_surf, bsdf_weight_det,
                                                 bs.pdf)
        sampled_null = on_surface & ((bs.sampled_type & bsdfs.NULL_FLAG) != 0)
        real_scatter = medium_scatter | (on_surface & ~sampled_null)
        cont = (s.active & (medium_scatter | on_surface)
                & (~real_scatter | depth_ok) & (scatter_pdf > 0.0))

        if primal:
            L = s.L + Le_det + Lr_dir_det
        else:
            L = s.L - Le_det - Lr_dir_det        # the remaining radiance
            # detached values of the relative-gradient denominators
            bsdf_val_next_det = bsdfs.eval_pdf(scene, bsdf_idx, si,
                                               bs.wo)[0]
            if has_media:
                ph_val_next_det = phase.eval_pdf(scene, s.medium, -cur_ray.d,
                                                 new_d)[0]
            null_trans_det = bsdfs.eval_null_transmission(scene, bsdf_idx, si)

            def local_contrib():
                scene_t = prb.substitute_theta(scene, leaves)
                # the free-flight weight attached (same decisions)
                med_rel = Vec3.ones(n, dev)
                if has_media:
                    med_w_a = media.sample_real_interaction(
                        scene_t, s.medium, cur_ray, t_surf, rng_med,
                        s.channel, in_medium)[1]
                    med_rel = Vec3.where(in_medium,
                                         _rel3(med_w_a, med_w_det, 1.0), 1.0)
                emitted_a = scene_t.eval_emitter(si, attrs).mask(
                    ~medium_scatter)
                if scene.env_emitter >= 0:
                    emitted_a = Vec3.where(
                        miss, scene_t.eval_env(cur_ray.d, s.wl), emitted_a)
                Le_a = (beta_med * emitted_a * mis).mask(s.active)
                # NEE attached: radiance, transmittance, BSDF/phase value
                em_weight_a = prb._attached_em_weight(
                    scene_t, ds, s.wl).mask(em_weight_det.any_positive())
                tr_a = attenuated_visibility(
                    scene_t, origin, ds, med_nee, rng_vis, s.channel,
                    active_em, cfg.shadow_segments)[0]
                nee_val_a = bsdfs.eval_pdf(scene_t, bsdf_idx, si, wo_em)[0]
                if has_media:
                    ph_val_a = phase.eval_pdf(scene_t, s.medium, -cur_ray.d,
                                              ds.d)[0]
                    nee_val_a = Vec3.where(medium_scatter, Vec3(
                        ph_val_a, ph_val_a, ph_val_a), nee_val_a)
                Lr_dir_a = (beta_med * nee_val_a * em_weight_a * tr_a
                            * mis_em).mask(active_em)
                # indirect: the relative scatter factor
                bsdf_val_a = bsdfs.eval_pdf(scene_t, bsdf_idx, si, bs.wo)[0]
                srel = Vec3(prb._relative(bsdf_val_a.x, bsdf_val_next_det.x),
                            prb._relative(bsdf_val_a.y, bsdf_val_next_det.y),
                            prb._relative(bsdf_val_a.z, bsdf_val_next_det.z))
                if has_media:
                    ph_rel = m.safe_div(phase.eval_pdf(
                        scene_t, s.medium, -cur_ray.d, new_d)[0],
                        ph_val_next_det)
                    srel = Vec3.where(medium_scatter,
                                      Vec3(ph_rel, ph_rel, ph_rel), srel)
                null_a = bsdfs.eval_null_transmission(scene_t, bsdf_idx, si)
                srel = Vec3.where(sampled_null,
                                  _rel3(null_a, null_trans_det, 1.0), srel)
                Lo = med_rel * (Le_a + Lr_dir_a + (L * srel).mask(cont))
                return (s.dL * Lo).to_array().sum()

            if flat:
                with torch.enable_grad():
                    obj = local_contrib()
                    if obj.requires_grad:
                        g = torch.autograd.grad(obj, diff, allow_unused=True)
                        for acc, gi in zip(grad_acc, g):
                            if gi is not None:
                                acc += gi

        # ---------------- loop variables, Russian roulette ----------
        new_o = Vec3.where(medium_scatter, ref_p, si.offset_p(new_d))
        beta = Vec3.where(cont, beta_med * scatter_w_det, beta_med)
        eta = torch.where(cont & on_surface, s.eta * bs.eta, s.eta)
        wl = collapse_wavelengths(s.wl, cont & on_surface, bs,
                                  bsdf_weight_det)
        depth = torch.where(cont & real_scatter, s.depth + 1, s.depth)
        new_medium = torch.where(cont & on_surface, update_medium(
            scene, si, attrs, new_d, s.medium), s.medium)
        beta_max = beta.max_component()
        rr_prob = torch.clamp(beta_max * m.sqr(eta), max=0.95)
        rr_active = (depth >= cfg.rr_depth) & real_scatter
        rng, rr_u = sampler_mod.next_1d(rng)
        beta = Vec3.where(rr_active & cont, beta * m.safe_div(1.0, rr_prob),
                          beta)
        new_active = cont & (~rr_active | (rr_u < rr_prob)) & (beta_max > 0.0)
        is_delta = on_surface & ((bs.sampled_type & bsdfs.DELTA) != 0)
        upd_prev = cont & real_scatter
        new_state = VPState(
            ray_o=Vec3.where(cont, new_o, s.ray_o),
            ray_d=Vec3.where(cont, new_d, s.ray_d), wl=wl, L=L, beta=beta,
            eta=eta,
            depth=depth, medium=new_medium, channel=s.channel,
            active=new_active, prev_p=Vec3.where(upd_prev, ref_p, s.prev_p),
            prev_pdf=torch.where(upd_prev, scatter_pdf, s.prev_pdf),
            prev_delta=torch.where(upd_prev, is_delta, s.prev_delta),
            rng=rng, dL=s.dL)
        return new_state, int(s.active.sum()) + vis_q

    def retire(st, lanes_done):
        L_out[lanes_done] = st.L.to_array()
        valid[lanes_done] = st.depth != 0

    with torch.no_grad():
        for _ in range(n_bounces(scene, cfg)):
            state, k = bounce(state)
            n_rays += k
            done = ~state.active
            if bool(done.any()):
                retire(take_lanes(state, done, lanes.shape[0]), lanes[done])
                keep = torch.nonzero(state.active).squeeze(1)
                state = take_lanes(state, keep, lanes.shape[0])
                lanes = lanes[keep]
            if lanes.shape[0] == 0:
                break
        retire(state, lanes)

    # the tables' gradients back to their textures and grids, once a pass
    tables = ([(tex, lambda x, w=wrap: tex_mod.build_quad(x, w))
               for tex, wrap, _ in quads]
              + [(g, media.build_cells) for g, _ in cells])
    for (src, build), g_tab in zip(tables, grad_acc[len(flat):]):
        with torch.enable_grad():
            g_src, = torch.autograd.grad(build(src), src, g_tab)
        grad_acc[next(i for i, x in enumerate(flat) if x is src)] += g_src
    grads, it = {}, iter(grad_acc)
    for name, value in leaves.items():
        grads[name] = (tuple(next(it) for _ in value)
                       if isinstance(value, tuple) else next(it))
    return Vec3(L_out[:, 0], L_out[:, 1], L_out[:, 2]), valid, n_rays, grads


def sample(scene, rng, ray, cfg: PRBVolpathConfig):
    """Integrator-registry entry point: (L Vec3, valid [N], n_rays); L is
    differentiable in the scene's θ tables (``DIFF_PARAM_NAMES``) through
    ``prb._PRBFunction`` with this module's loop."""
    keys, tensors = prb._flatten_theta(scene, DIFF_PARAM_NAMES)
    run = prb._Replay(scene, rng, ray, cfg, keys, loop=_loop)
    L, valid = prb._PRBFunction.apply(run, *tensors)
    return Vec3(L[:, 0], L[:, 1], L[:, 2]), valid, run.n_rays
