"""Path Replay Backpropagation (PRB) — counterpart of ``mitsuba3_tpu/ad/prb.py``
(detached-sampling PRB, src/python/python/ad/integrators/prb.py).

A primal pass computes each sample's radiance L with every random choice
detached; the backward pass *replays* the identical light path (the same
PCG32 stream, drawn in the same order: ``next_1d`` and ``next_2d`` for
NEE, ``next_1d`` and ``next_2d`` for the BSDF, ``next_1d`` for Russian
roulette, per bounce) and re-evaluates each vertex's local shading
attached to the scene parameters θ, injecting the adjoint δL at every
bounce. Memory stays O(1) in the path depth.

``sample`` is a ``torch.autograd.Function`` (JAX's ``custom_vjp``):
- its forward runs the detached primal loop under ``torch.no_grad()`` and
  keeps only (θ, sampler state, rays, L);
- its backward replays the loop and, at each bounce, takes one local
  ``torch.autograd.grad`` of (δL · Lo) over the θ tensors that require
  grad, where Lo = Le + Lr_dir + L_remaining · bsdf_val / detach(bsdf_val)
  (the relative-gradient trick, prb.py:294), adds it to the accumulator
  and frees that bounce's graph.

θ is ``DIFF_PARAM_NAMES``: BSDF rows, emitter radiance, textures,
environment map, vertices (positions, normals and frames re-attached from
the detached barycentrics, and the NEE sample re-attached to moving
emitter geometry) and delta-emitter rows. In the spectral variant the
loop carries the path's wavelengths through every bounce, as ``path``
does (JAX's ``prb`` loop drops them: ROADMAP queue 3). Intersections stay
detached, so
the accels' kernels run in both passes and need no backward. Like the
path integrator, the loop drops lanes whose path has ended: they add
nothing more to L or to the gradients.

A texture's bilinear lookups read its quad table (``render/texture.py``).
The replay builds that table once per pass as a leaf of its own, which
every bounce's lookups share; the table's gradient, summed over the
bounces, goes back to the texture through the table's build once, at the
end of the pass.
"""
from __future__ import annotations

import dataclasses

import torch

from .. import bsdfs
from ..core import math as m
from ..core.struct import struct, take_lanes
from ..core.vec import Vec3
from ..integrators.path import collapse_wavelengths, mis_weight
from ..render import sampler as sampler_mod
from ..render import texture as tex_mod
from ..render.records import Ray
from ..render.scene import _RefPoint
from ..render.sampler import Sampler


@dataclasses.dataclass(frozen=True)
class PRBConfig:
    type: str = "prb"
    max_depth: int = 8
    rr_depth: int = 5
    hide_emitters: bool = False


DIFF_PARAM_NAMES = ("bsdf_params", "em_radiance", "textures", "env_data",
                    "vertices", "de_params")


def extract_theta(scene):
    return {k: getattr(scene, k) for k in DIFF_PARAM_NAMES}


def substitute_theta(scene, theta):
    return scene.replace(**theta)


def _attached_em_weight(scene_t, ds, wl=None) -> Vec3:
    """The NEE emitter weight re-evaluated attached to θ, over the
    detached pdf (prb.py:207-210 em_val_diff * detach(rcp(pdf))), at the
    path's wavelengths `wl` in the spectral variant."""
    ok = ds.pdf > 0.0
    inv_pdf = torch.where(ok, 1.0 / torch.clamp(ds.pdf, min=1e-20), 0.0)
    radiance = scene_t.gather_em_radiance(
        torch.clamp(ds.emitter_index, min=0)).mask(ds.emitter_index >= 0)
    if scene_t.env_emitter >= 0:
        radiance = Vec3.where(ds.emitter_index == scene_t.env_emitter,
                              scene_t.eval_env(ds.d), radiance)
    if scene_t.de_params is not None:
        # delta emitters: the attached irradiance at the sampled direction
        n_area = scene_t.n_area_emitters
        n_delta = scene_t.de_params.shape[0]
        is_delta = ((ds.emitter_index >= n_area)
                    & (ds.emitter_index < n_area + n_delta))
        k = torch.clamp(ds.emitter_index - n_area, 0, n_delta - 1)
        ref_p = ds.p - ds.d * ds.dist
        rad_d = scene_t._eval_delta_emitter(_RefPoint(p=ref_p, t=ds.dist),
                                             k)[3]
        radiance = Vec3.where(is_delta, rad_d, radiance)
    radiance = scene_t.spectral_radiance(radiance, ds.emitter_index, wl)
    return radiance * inv_pdf.detach()


def _attached_nee_geometry(scene_t, ds, ref_p_a):
    """Re-attach the NEE sample to moving emitter geometry: the sample
    position from (prim, barycentrics), the direction from the attached
    reference point, and the solid-angle pdf ratio pdf_det / pdf(θ), which
    is 1 in value and carries d(pdf)/d(vertices) (prb.py:201-210).

    Returns (d_attached Vec3, jacobian [N])."""
    area_lane = ds.prim_index >= 0
    a = scene_t.gather_face_attrs(torch.clamp(ds.prim_index, min=0))
    fp0 = Vec3(a[0], a[1], a[2])
    fe1 = Vec3(a[3], a[4], a[5])
    fe2 = Vec3(a[6], a[7], a[8])
    p_a = fp0 + fe1 * ds.uv.x + fe2 * ds.uv.y
    p_a = Vec3.where(area_lane, p_a, ds.p)
    d_un = p_a - ref_p_a
    dist2 = torch.clamp(d_un.squared_norm(), min=1e-30)
    d_a = Vec3.where(area_lane, d_un * torch.rsqrt(dist2), ds.d)
    ng_a = fe1.cross(fe2)
    ng_a = ng_a * (1.0 / torch.clamp(ng_a.norm(), min=1e-20))
    cos_em = torch.clamp(-ng_a.dot(d_a), min=1e-6)
    # the NEE pdf(θ) = dist²(θ) / (E · A_total(θ) · cos θ_em), A_total the
    # summed area of every emissive face (the global area CDF)
    p_all = scene_t.vertices[scene_t.faces[scene_t.ef_face.long()].long()]
    cr = torch.linalg.cross(p_all[:, 1] - p_all[:, 0],
                            p_all[:, 2] - p_all[:, 0], dim=-1)
    a_total = 0.5 * torch.linalg.norm(cr, dim=-1).sum()
    pdf_shape_a = m.safe_div(dist2, a_total * cos_em)
    ratio = m.safe_div(pdf_shape_a.detach(), pdf_shape_a, fallback=1.0)
    return d_a, torch.where(area_lane, ratio, 1.0)


# below this, a continuation's detached BSDF value gives its lane no
# Lr_ind gradient: d(a / det) = da / det overflows float32 there (a
# Beckmann lobe sampled far in its tail: value and pdf ~1e-42, weight ~1)
REL_MIN = 1e-30


def _relative(a, det):
    """a / det, and 0 where |det| <= REL_MIN (the relative-gradient trick's
    ratio, whose value is 1 and whose gradient is da / det)."""
    ok = det.abs() > REL_MIN
    return torch.where(ok, a / torch.where(ok, det, 1.0), 0.0)


@struct
class PRBState:
    ray_o: Vec3
    ray_d: Vec3
    wl: Vec3 | None          # the path's wavelengths (spectral variant)
    L: Vec3                  # primal: accumulates up; backward: counts down
    beta: Vec3
    eta: torch.Tensor
    depth: torch.Tensor      # [N] int32
    active: torch.Tensor     # [N] bool
    prev_p: Vec3
    prev_bsdf_pdf: torch.Tensor
    prev_bsdf_delta: torch.Tensor
    rng: Sampler
    dL: Vec3 | None          # backward: the adjoint of each lane's L


def _theta_leaves(theta: dict):
    """Fresh leaves requiring grad for the θ entries of `theta` (a tuple
    entry, the textures, gets one leaf per tensor). Returns (leaf dict,
    flat leaf list)."""
    leaves, flat = {}, []
    for name, value in theta.items():
        if isinstance(value, tuple):
            leaves[name] = tuple(v.detach().requires_grad_(True)
                                 for v in value)
            flat.extend(leaves[name])
        else:
            leaves[name] = value.detach().requires_grad_(True)
            flat.append(leaves[name])
    return leaves, flat


def _quad_leaves(scene, textures):
    """For each texture leaf whose lookups read a quad table (bilinear,
    repeat or clamp): (texture, wrap, a quad-table leaf registered as its
    table)."""
    quads = []
    for tex, (wrap, filt, _, _) in zip(textures, scene.texture_meta):
        if filt == "bilinear" and wrap in ("repeat", "clamp"):
            quad = tex_mod.build_quad(tex.detach(), wrap).requires_grad_(True)
            tex_mod.register_quad(tex, wrap, quad)
            quads.append((tex, wrap, quad))
    return quads


def _loop(scene, rng, ray, cfg: PRBConfig, mode: str, dL=None, L_in=None,
          theta=None):
    """The shared primal / backward bounce loop on the detached `scene`;
    `mode` is "primal" or "backward". The draw order is identical in both
    modes: the replay invariant.

    backward: `dL` and `L_in` are Vec3 of [N]; `theta` maps the names of
    the θ entries to differentiate to their values.
    Returns (L Vec3 [N], valid [N], n_rays, grads): n_rays counts the
    active lanes' closest-hit queries plus the issued shadow rays of every
    bounce; grads maps each name of `theta` to its gradient (a tuple for
    the textures), {} in the primal."""
    primal = mode == "primal"
    n = ray.o.x.shape[0]
    dev = ray.o.x.device
    ones = torch.ones(n, dtype=torch.float32, device=dev)
    state = PRBState(
        ray_o=ray.o, ray_d=ray.d, wl=ray.wl,
        L=Vec3.zeros(n, dev) if primal else L_in,
        beta=Vec3.ones(n, dev), eta=ones,
        depth=torch.zeros(n, dtype=torch.int32, device=dev),
        active=torch.ones(n, dtype=torch.bool, device=dev),
        prev_p=ray.o, prev_bsdf_pdf=ones,
        prev_bsdf_delta=torch.ones(n, dtype=torch.bool, device=dev),
        rng=rng, dL=None if primal else dL)
    leaves, flat = _theta_leaves(theta or {})
    quads = _quad_leaves(scene, leaves.get("textures", ()))
    diff = flat + [quad for _, _, quad in quads]
    grad_acc = [torch.zeros_like(leaf) for leaf in diff]
    L_out = torch.zeros((n, 3), dtype=torch.float32, device=dev)
    valid = torch.zeros(n, dtype=torch.bool, device=dev)
    lanes = torch.arange(n, device=dev)
    n_rays = 0

    def bounce(s: PRBState):
        cur_ray = Ray.make(s.ray_o, s.ray_d, wl=s.wl)
        pi = scene.ray_intersect_preliminary(cur_ray, active=s.active)
        si, attrs = scene.compute_surface_interaction(cur_ray, pi)

        # ---------------- direct emission (detached numbers) ------------
        miss = ~si.is_valid()
        emitted_det = scene.eval_emitter(si, attrs)
        ds_pdf = scene.pdf_emitter_direction_hit(s.prev_p, si, attrs)
        if scene.env_emitter >= 0:
            emitted_det = Vec3.where(miss, scene.eval_env(cur_ray.d, s.wl),
                                     emitted_det)
            ds_pdf = torch.where(
                miss, scene.pdf_emitter_direction_miss(cur_ray.d), ds_pdf)
        em_pdf = torch.where(s.prev_bsdf_delta, 0.0, ds_pdf)
        mis = mis_weight(s.prev_bsdf_pdf, em_pdf)
        Le_det = (s.beta * emitted_det * mis).mask(s.active)

        active_next = (s.active & ((s.depth + 1) < cfg.max_depth)
                       & si.is_valid())
        bsdf_idx = attrs["bsdf"]
        flags = bsdfs.lane_flags(scene.bsdf_types, bsdf_idx, scene.bsdf_flags)
        smooth = (flags & bsdfs.SMOOTH) != 0

        # ---------------- emitter sampling (detached) -------------------
        active_em = active_next & smooth
        rng, s1_em = sampler_mod.next_1d(s.rng)
        rng, s2_em = sampler_mod.next_2d(rng)
        ds, em_weight_det = scene.sample_emitter_direction(
            si, s1_em, s2_em, active=active_em, test_visibility=False)
        active_em = active_em & (ds.pdf != 0.0)
        wo_em = si.to_local(ds.d)

        # ---------------- detached BSDF sampling ------------------------
        rng, s1_b = sampler_mod.next_1d(rng)
        rng, s2_b = sampler_mod.next_2d(rng)
        bsdf_val_em_det, bsdf_pdf_em = bsdfs.eval_pdf(scene, bsdf_idx, si,
                                                      wo_em)
        bs, bsdf_weight_det = bsdfs.sample(scene, bsdf_idx, si, s1_b, s2_b)

        # deferred shadow test (the path integrator's rule): only lanes
        # whose detached f * Le is nonzero pay a query; visibility stays
        # detached
        n_shadow = 0
        if scene.has_nee_emitters():
            vis_needed = (active_em & bsdf_val_em_det.any_positive()
                          & em_weight_det.any_positive())
            occluded = scene.ray_test(si.spawn_ray_to(ds.p),
                                      active=vis_needed)
            active_em = vis_needed & ~occluded
            n_shadow = int(vis_needed.sum())

        mis_em = torch.where(ds.delta, 1.0, mis_weight(ds.pdf, bsdf_pdf_em))
        Lr_dir_det = (s.beta * bsdf_val_em_det * em_weight_det
                      * mis_em).mask(active_em)
        wo_world = si.to_world(bs.wo)
        new_o = Vec3.where(active_next, si.offset_p(wo_world), s.ray_o)
        new_d = Vec3.where(active_next, wo_world, s.ray_d)

        if primal:
            L = s.L + Le_det + Lr_dir_det
        else:
            L = s.L - Le_det - Lr_dir_det        # the remaining radiance
            bsdf_val_next_det = bsdfs.eval_pdf(scene, bsdf_idx, si,
                                               bs.wo)[0]

            def local_contrib():
                scene_t = substitute_theta(scene, leaves)
                # attached hit recompute from the detached (prim, bary):
                # positions, normals and frames follow the vertices
                si_a = scene_t.compute_surface_interaction(cur_ray, pi)[0]
                emitted_a = scene_t.eval_emitter(si_a, attrs)
                if scene.env_emitter >= 0:
                    emitted_a = Vec3.where(
                        miss, scene_t.eval_env(cur_ray.d, s.wl), emitted_a)
                Le_a = (s.beta * emitted_a * mis).mask(s.active)
                # Lr_dir(θ): detached visibility; attached radiance, BSDF
                # and emitter-sample geometry
                d_a, jac = _attached_nee_geometry(scene_t, ds, si_a.p)
                em_weight_a = (_attached_em_weight(scene_t, ds, s.wl)
                               * jac).mask(em_weight_det.any_positive())
                bsdf_val_em_a = bsdfs.eval_pdf(scene_t, bsdf_idx, si_a,
                                               si_a.to_local(d_a))[0]
                Lr_dir_a = (s.beta * bsdf_val_em_a * em_weight_a
                            * mis_em).mask(active_em)
                # Lr_ind(θ) = L_remaining * bsdf_val(θ) / detach(bsdf_val);
                # the continuation direction is fixed in world space, so
                # its local coordinates turn with the attached frame
                bsdf_val_a = bsdfs.eval_pdf(scene_t, bsdf_idx, si_a,
                                            si_a.to_local(wo_world))[0]
                rel = Vec3(_relative(bsdf_val_a.x, bsdf_val_next_det.x),
                           _relative(bsdf_val_a.y, bsdf_val_next_det.y),
                           _relative(bsdf_val_a.z, bsdf_val_next_det.z))
                Lo = Le_a + Lr_dir_a + (L * rel).mask(active_next)
                return (s.dL * Lo).to_array().sum()

            if flat:
                with torch.enable_grad():
                    obj = local_contrib()
                    if obj.requires_grad:
                        g = torch.autograd.grad(obj, diff, allow_unused=True)
                        for acc, gi in zip(grad_acc, g):
                            if gi is not None:
                                acc += gi

        # ---------------- loop variables, Russian roulette --------------
        beta = Vec3.where(active_next, s.beta * bsdf_weight_det, s.beta)
        wl = collapse_wavelengths(s.wl, active_next, bs, bsdf_weight_det)
        eta = torch.where(active_next, s.eta * bs.eta, s.eta)
        depth = torch.where(si.is_valid() & s.active, s.depth + 1, s.depth)
        beta_max = beta.max_component()
        rr_prob = torch.clamp(beta_max * m.sqr(eta), max=0.95)
        rr_active = depth >= cfg.rr_depth
        rng, rr_sample = sampler_mod.next_1d(rng)
        rr_continue = rr_sample < rr_prob
        beta = Vec3.where(rr_active & active_next,
                          beta * m.safe_div(1.0, rr_prob), beta)
        new_active = (active_next & (~rr_active | rr_continue)
                      & (beta_max != 0.0))
        new_state = PRBState(
            ray_o=new_o, ray_d=new_d, wl=wl, L=L, beta=beta, eta=eta,
            depth=depth,
            active=new_active,
            prev_p=Vec3.where(active_next, si.p, s.prev_p),
            prev_bsdf_pdf=torch.where(active_next, bs.pdf, s.prev_bsdf_pdf),
            prev_bsdf_delta=torch.where(
                active_next, (bs.sampled_type & bsdfs.DELTA) != 0,
                s.prev_bsdf_delta),
            rng=rng, dL=s.dL)
        return new_state, int(s.active.sum()) + n_shadow

    def retire(st, lanes_done):
        L_out[lanes_done] = st.L.to_array()
        valid[lanes_done] = st.depth != 0

    with torch.no_grad():
        for _ in range(cfg.max_depth):
            state, k = bounce(state)
            n_rays += k
            # drop lanes whose path ended: L and the gradients no longer
            # change for them
            done = ~state.active
            if bool(done.any()):
                retire(take_lanes(state, done, lanes.shape[0]), lanes[done])
                keep = torch.nonzero(state.active).squeeze(1)
                state = take_lanes(state, keep, lanes.shape[0])
                lanes = lanes[keep]
            if lanes.shape[0] == 0:
                break
        retire(state, lanes)

    # the quad tables' gradients back to their textures
    for (tex, wrap, _), g_quad in zip(quads, grad_acc[len(flat):]):
        with torch.enable_grad():
            g_tex, = torch.autograd.grad(tex_mod.build_quad(tex, wrap), tex,
                                         g_quad)
        grad_acc[next(i for i, x in enumerate(flat) if x is tex)] += g_tex
    grads, it = {}, iter(grad_acc)
    for name, value in leaves.items():
        grads[name] = (tuple(next(it) for _ in value)
                       if isinstance(value, tuple) else next(it))
    return Vec3(L_out[:, 0], L_out[:, 1], L_out[:, 2]), valid, n_rays, grads


def _flatten_theta(scene, names=DIFF_PARAM_NAMES):
    """The scene's θ (its tables `names`) as ((name, tuple index or None)
    keys, tensors), skipping entries that are None."""
    keys, tensors = [], []
    for name in names:
        value = getattr(scene, name)
        if isinstance(value, tuple):
            for i, v in enumerate(value):
                keys.append((name, i))
                tensors.append(v)
        elif value is not None:
            keys.append((name, None))
            tensors.append(value)
    return keys, tensors


def _unflatten_theta(keys, tensors) -> dict:
    theta = {}
    for (name, i), t in zip(keys, tensors):
        if i is None:
            theta[name] = t
        else:
            theta[name] = theta.get(name, ()) + (t,)
    return theta


class _Replay:
    """What one wavefront's PRB call needs besides θ: the scene, the
    sampler state, the rays, the config, θ's keys, the bounce loop
    (``_loop`` here, ``prbvolpath._loop`` for volumes) and (after the
    forward) its ray count."""

    def __init__(self, scene, rng, ray, cfg, keys, loop=None):
        self.scene, self.rng, self.ray, self.cfg = scene, rng, ray, cfg
        self.keys = keys
        self.loop = loop or _loop
        self.n_rays = 0


class _PRBFunction(torch.autograd.Function):
    """L = PRB primal(θ); its backward is the replay (O(1) residuals:
    θ, sampler state, rays and L)."""

    @staticmethod
    def forward(ctx, run: _Replay, *tensors):
        theta = _unflatten_theta(run.keys, [t.detach() for t in tensors])
        L, valid, run.n_rays, _ = run.loop(
            substitute_theta(run.scene, theta), run.rng, run.ray, run.cfg,
            "primal")
        L = torch.stack([L.x, L.y, L.z], dim=1)
        ctx.run = run
        ctx.save_for_backward(L, *tensors)
        ctx.mark_non_differentiable(valid)
        return L, valid

    @staticmethod
    def backward(ctx, dL, _dvalid):
        run = ctx.run
        L, *tensors = ctx.saved_tensors
        tensors = [t.detach() for t in tensors]
        want = ctx.needs_input_grad[1:]
        theta = _unflatten_theta(run.keys, tensors)
        # a tuple entry (textures, grids) is differentiated whole when any of
        # its tensors is wanted: the replay's scene keeps every texture
        wanted = {name: theta[name] for (name, _), w in zip(run.keys, want)
                  if w}
        dL = dL.detach()
        grads = run.loop(substitute_theta(run.scene, theta), run.rng,
                         run.ray, run.cfg, "backward",
                         dL=Vec3(dL[:, 0], dL[:, 1], dL[:, 2]),
                         L_in=Vec3(L[:, 0], L[:, 1], L[:, 2]),
                         theta=wanted)[3]
        out = [None if not w else grads[name] if i is None
               else grads[name][i]
               for (name, i), w in zip(run.keys, want)]
        return (None, *out)


def sample(scene, rng, ray, cfg: PRBConfig):
    """Integrator-registry entry point: (L Vec3, valid [N], n_rays).

    L is differentiable w.r.t. the scene's θ tables (``DIFF_PARAM_NAMES``)
    through the PRB autograd.Function (replay-based, O(1) memory in path
    depth)."""
    keys, tensors = _flatten_theta(scene)
    run = _Replay(scene, rng, ray, cfg, keys)
    L, valid = _PRBFunction.apply(run, *tensors)
    return Vec3(L[:, 0], L[:, 1], L[:, 2]), valid, run.n_rays
