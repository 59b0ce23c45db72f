"""Direct illumination integrator with MIS — counterpart of
``mitsuba3_tpu/integrators/direct.py`` (src/integrators/direct.cpp):
``emitter_samples`` emitter strategies and ``bsdf_samples`` BSDF
strategies at the first hit, combined by the power heuristic.

As in the path tracer, the shadow test is deferred: a lane whose BSDF
value or emitter weight is exactly zero needs no query. Ray queries are
counted as the JAX package counts them: every lane's primary query,
each issued shadow ray and each lane that traces a BSDF ray.
"""
from __future__ import annotations

import dataclasses

import torch

from .. import bsdfs
from ..core.vec import Vec3
from ..render import sampler as sampler_mod
from ..render.records import Ray
from .path import mis_weight


@dataclasses.dataclass(frozen=True)
class DirectConfig:
    type: str = "direct"
    emitter_samples: int = 1
    bsdf_samples: int = 1
    hide_emitters: bool = False


def config_from_dict(spec):
    shading = int(spec.get("shading_samples", 1))
    return DirectConfig(
        type="direct",
        emitter_samples=int(spec.get("emitter_samples", shading)),
        bsdf_samples=int(spec.get("bsdf_samples", shading)),
        hide_emitters=bool(spec.get("hide_emitters", False)))


def sample(scene, rng, ray: Ray, cfg: DirectConfig):
    """Returns (L Vec3, valid [N], n_ray_queries)."""
    n = ray.o.x.shape[0]
    frac_lum = cfg.emitter_samples / (cfg.emitter_samples + cfg.bsdf_samples)
    frac_bsdf = 1.0 - frac_lum

    pi = scene.ray_intersect_preliminary(ray)
    si, attrs = scene.compute_surface_interaction(ray, pi)
    n_rays = n

    # visible emitters and the environment
    emitted = scene.eval_emitter(si, attrs)
    if scene.env_emitter >= 0:
        # the environment in RGB in the spectral variant too, as JAX's
        # direct reads it
        emitted = Vec3.where(si.is_valid(), emitted, scene.eval_env(ray.d))
    result = Vec3.zeros(n, ray.o.x.device)
    if not cfg.hide_emitters:
        result = result + emitted

    active_surf = si.is_valid()
    bsdf_idx = attrs["bsdf"]

    # ---- emitter sampling strategies ----
    for _ in range(cfg.emitter_samples):
        rng, s1 = sampler_mod.next_1d(rng)
        rng, s2 = sampler_mod.next_2d(rng)
        ds, em_weight = scene.sample_emitter_direction(
            si, s1, s2, active=active_surf, test_visibility=False)
        ok = active_surf & (ds.pdf > 0.0)
        bsdf_val, bsdf_pdf = bsdfs.eval_pdf(scene, bsdf_idx, si,
                                            si.to_local(ds.d))
        if scene.has_nee_emitters():
            vis_needed = (ok & bsdf_val.any_positive()
                          & em_weight.any_positive())
            occluded = scene.ray_test(si.spawn_ray_to(ds.p),
                                      active=vis_needed)
            ok = vis_needed & ~occluded
            n_rays += int(vis_needed.sum())
        mis = torch.where(ds.delta, 1.0,
                          mis_weight(ds.pdf * frac_lum, bsdf_pdf * frac_bsdf)
                          ) / cfg.emitter_samples
        result = result + (bsdf_val * em_weight * mis).mask(ok)

    # ---- BSDF sampling strategies ----
    for _ in range(cfg.bsdf_samples):
        rng, s1 = sampler_mod.next_1d(rng)
        rng, s2 = sampler_mod.next_2d(rng)
        bs, bsdf_weight = bsdfs.sample(scene, bsdf_idx, si, s1, s2)
        ok = active_surf & (bs.pdf > 0.0)
        ray2 = si.spawn_ray(si.to_world(bs.wo))
        pi2 = scene.ray_intersect_preliminary(ray2, active=ok)
        si2, attrs2 = scene.compute_surface_interaction(ray2, pi2)
        emitted2 = scene.eval_emitter(si2, attrs2)
        ds_pdf = scene.pdf_emitter_direction_hit(si.p, si2, attrs2)
        if scene.env_emitter >= 0:
            miss2 = ~si2.is_valid()
            emitted2 = Vec3.where(miss2, scene.eval_env(ray2.d), emitted2)
            ds_pdf = torch.where(
                miss2, scene.pdf_emitter_direction_miss(ray2.d), ds_pdf)
        delta = (bs.sampled_type & bsdfs.DELTA) != 0
        mis = torch.where(delta, 1.0,
                          mis_weight(bs.pdf * frac_bsdf, ds_pdf * frac_lum)
                          ) / cfg.bsdf_samples
        result = result + (bsdf_weight * emitted2 * mis).mask(ok)
        n_rays += int(ok.sum())

    valid = si.is_valid() | emitted.any_positive()
    return result, valid, n_rays
