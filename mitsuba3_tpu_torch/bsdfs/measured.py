"""Measured (data-driven) BSDF — counterpart of
``mitsuba3_tpu/bsdfs/measured.py``: the RGL adaptive-parameterization
model (Dupuy & Jakob 2018) read from ``.bsdf`` tensor files (RGB only).

The half vector m is drawn by two warps conditioned on the incident
direction, uniform --lum--> sample --vndf--> u_m = (theta2u(theta_m),
phi2u(phi_m [- phi_i])); eval and pdf invert the vndf warp to find where
the reflectance table lives, with the change-of-variables factors of the
reference. Isotropic tables (at most two phi_i entries) use the relative
azimuth; anisotropic ones condition on (phi_i, theta_i) and fold wi into
the stored phi_i range when it covers only 2 pi / reduction.

The JAX package's deviations from the reference are copied exactly:
- sampling picks the lower or upper theta_i (and phi_i) slice at random
  with the interpolation weight, which consumes `s1`;
- eval and pdf take the 2-slice (isotropic) or 4-slice (anisotropic)
  mixture, so the sampled density equals the reported pdf;
- the sample weight is eval / pdf at the sampled direction.

Each table (``scene.measured_tables``, a dict of tensors and two
``SlicedMarginal2D``) is evaluated on every lane and selected by the
row's slot, as in the JAX package.

Param row: [0] the slot into scene.measured_tables.
"""
from __future__ import annotations

import torch

from ..core import math as m
from ..core.distr2d import eval_bilinear_sliced
from ..core.vec import Vec2, Vec3
from ..render.records import BSDFSample

GLOSSY_REFLECTION = 0x0008
FRONT_SIDE = 0x2000
FLAGS = GLOSSY_REFLECTION | FRONT_SIDE


def _elevation(v: Vec3):
    """The numerically stable elevation angle (measured.cpp:237)."""
    dz = v.z - 1.0
    dist = torch.sqrt(v.x * v.x + v.y * v.y + dz * dz)
    return 2.0 * torch.asin(torch.clamp(0.5 * dist, -1.0, 1.0))


def _theta2u(theta):
    return torch.sqrt(torch.clamp(theta * (2.0 / m.Pi), min=0.0))


def _u2theta(u):
    return u * u * (m.Pi / 2.0)


def _phi2u(phi):
    return (phi + m.Pi) * (0.5 / m.Pi)


def _u2phi(u):
    return (2.0 * u - 1.0) * m.Pi


def _fold_signs(tbl, wi: Vec3):
    """Per-axis signs folding wi into the stored phi_i range
    (measured.cpp:258-263): reduction >= 2 folds y, 4 folds x too; they
    fold wi in and the sampled wo back out."""
    red = tbl["reduction"]
    sy = torch.where(red >= 1.5, wi.y, -1.0)
    sx = torch.where(red >= 3.5, wi.x, sy)
    return (torch.where(sx >= 0.0, -1.0, 1.0),
            torch.where(sy >= 0.0, -1.0, 1.0))


def _apply_fold(v: Vec3, fx, fy):
    return Vec3(v.x * fx, v.y * fy, v.z)


def _slice_weights(grid, x):
    """The lower slice j and fraction w of x in the sorted grid."""
    t_count = grid.shape[0]
    if t_count == 1:
        return torch.zeros_like(x, dtype=torch.int32), torch.zeros_like(x)
    below = torch.searchsorted(grid, x.contiguous(), right=True)
    j = torch.clamp(below - 1, 0, t_count - 2)
    tj = grid[j]
    w = torch.clamp(m.safe_div(x - tj, grid[j + 1] - tj), 0.0, 1.0)
    return j.to(torch.int32), w


def _cond_slices(tbl, wi_f: Vec3):
    """Conditioning on the folded incident direction: (phi_i, u_wi, the
    theta_i cell (j, wt), the phi_i cell (p, wp))."""
    theta_i = _elevation(wi_f)
    phi_i = torch.atan2(wi_f.y, wi_f.x)
    u_wi = Vec2(_theta2u(theta_i), _phi2u(phi_i))
    j, wt = _slice_weights(tbl["theta_i"], theta_i)
    if tbl["phi_i"].shape[0] == 1:
        p, wp = torch.zeros_like(j), torch.zeros_like(wt)
    else:
        p, wp = _slice_weights(tbl["phi_i"], phi_i)
    return phi_i, u_wi, j, wt, p, wp


def _iso(tbl) -> bool:
    return tbl["phi_i"].shape[0] <= 2


def _halfvec_coords(wi: Vec3, wo: Vec3, phi_i, iso: bool):
    mvec = (wi + wo).normalize()
    phi_m = torch.atan2(mvec.y, mvec.x)
    um_y = _phi2u(phi_m - phi_i if iso else phi_m)   # measured.cpp:378
    um_y = um_y - torch.floor(um_y)
    u_m = Vec2(_theta2u(_elevation(mvec)), um_y)
    sin_m = torch.sqrt(torch.clamp(1.0 - mvec.z * mvec.z, min=0.0))
    return mvec, u_m, sin_m


def _spectra_at(tbl, sample: Vec2, k):
    return Vec3(*(eval_bilinear_sliced(tbl["spectra"], k * 3 + c, sample)
                  for c in range(3)))


def _jac_factor(tbl, u_m: Vec2, u_wi: Vec2):
    zero = torch.zeros_like(u_m.x, dtype=torch.int32)
    ndf_v = eval_bilinear_sliced(tbl["ndf"], zero, u_m)
    sig_v = eval_bilinear_sliced(tbl["sigma"], zero, u_wi)
    return m.safe_div(ndf_v, 4.0 * sig_v)


def _pdf_slice(tbl, k, u_m: Vec2, sin_m, wi_dot_m):
    """(pdf, luminance-space sample) of one conditioning slice."""
    sample, vndf_pdf = tbl["vndf"].invert(k, u_m)
    lum_pdf = tbl["lum"].eval(k, sample)
    jac = torch.clamp(2.0 * m.Pi ** 2 * u_m.x * sin_m, min=1e-6) \
        * 4.0 * wi_dot_m
    return m.safe_div(vndf_pdf * lum_pdf, jac), sample


def _eval_pdf_one(tbl, wi: Vec3, wo: Vec3):
    """(value, pdf) of one table: the mixture over the enclosing slices."""
    t_count = tbl["theta_i"].shape[0]
    fx, fy = _fold_signs(tbl, wi)
    wi_f = _apply_fold(wi, fx, fy)
    phi_i, u_wi, j, wt, p, wp = _cond_slices(tbl, wi_f)
    mvec, u_m, sin_m = _halfvec_coords(wi_f, _apply_fold(wo, fx, fy), phi_i,
                                       _iso(tbl))
    wi_dot_m = wi_f.dot(mvec)
    jac = _jac_factor(tbl, u_m, u_wi)

    phi_terms = (((p, None),) if tbl["phi_i"].shape[0] == 1
                 else ((p, 1.0 - wp), (p + 1, wp)))
    value = Vec3.zeros(wi.x.shape[0], wi.x.device)
    pdf = torch.zeros_like(wi.x)
    for p_idx, w_phi in phi_terms:
        for j_idx, w_th in ((j, 1.0 - wt), (j + 1, wt)):
            k = p_idx * t_count + j_idx
            wgt = w_th if w_phi is None else w_phi * w_th
            pk, sk = _pdf_slice(tbl, k, u_m, sin_m, wi_dot_m)
            value = value + _spectra_at(tbl, sk, k) * jac * wgt
            pdf = pdf + pk * wgt
    ok = (wi.z > 0) & (wo.z > 0) & (pdf > 0)
    return value.mask(ok), torch.where(ok, pdf, 0.0)


def _sample_one(tbl, wi: Vec3, s1, s2: Vec2):
    """(wo, pdf, weight, ok) of one table."""
    t_count = tbl["theta_i"].shape[0]
    fx, fy = _fold_signs(tbl, wi)
    wi_f = _apply_fold(wi, fx, fy)
    phi_i, _, j, wt, p, wp = _cond_slices(tbl, wi_f)

    # the stochastic slice choice: theta_i by s1, then phi_i by the
    # rescaled remainder
    pick_t = s1 < wt
    kt = j + pick_t.to(torch.int32)
    s1b = torch.where(pick_t, m.safe_div(s1, wt),
                      m.safe_div(s1 - wt, 1.0 - wt))
    k = (p + (s1b < wp).to(torch.int32)) * t_count + kt

    pos_l = tbl["lum"].sample(k, Vec2(s2.y, s2.x))[0]   # measured.cpp:273
    u_m = tbl["vndf"].sample(k, pos_l)[0]
    phi_m = _u2phi(u_m.y) + (phi_i if _iso(tbl) else 0.0)
    theta_m = _u2theta(u_m.x)
    sin_t, cos_t = torch.sin(theta_m), torch.cos(theta_m)
    mvec = Vec3(torch.cos(phi_m) * sin_t, torch.sin(phi_m) * sin_t, cos_t)
    wo = _apply_fold(mvec * (2.0 * mvec.dot(wi_f)) - wi_f, fx, fy)

    value, pdf = _eval_pdf_one(tbl, wi, wo)
    ok = (wi.z > 0) & (wo.z > 0) & (pdf > 0)
    inv_pdf = torch.where(ok, m.safe_div(1.0, pdf), 0.0)
    return wo, pdf, (value * inv_pdf).mask(ok), ok


def _tables(scene, bsdf_idx):
    slot = torch.round(scene.gather_bsdf_params(bsdf_idx)[0]).to(torch.int32)
    return [(slot == k, tbl) for k, tbl in enumerate(scene.measured_tables)]


def sample(scene, bsdf_idx, si, s1, s2: Vec2):
    n = si.t.shape[0]
    dev = si.t.device
    zero = torch.zeros(n, dtype=torch.float32, device=dev)
    wo = Vec3(zero, zero, torch.ones_like(zero))
    pdf = zero
    weight = Vec3.zeros(n, dev)
    valid = torch.zeros(n, dtype=torch.bool, device=dev)
    for mask, tbl in _tables(scene, bsdf_idx):
        wo_k, pdf_k, w_k, ok_k = _sample_one(tbl, si.wi, s1, s2)
        wo = Vec3.where(mask, wo_k, wo)
        pdf = torch.where(mask, pdf_k, pdf)
        weight = Vec3.where(mask, w_k, weight)
        valid = torch.where(mask, ok_k, valid)
    bs = BSDFSample(
        wo=wo, pdf=torch.where(valid, pdf, 0.0), eta=torch.ones_like(zero),
        sampled_type=torch.full((n,), GLOSSY_REFLECTION, dtype=torch.int32,
                                device=dev),
        sampled_component=torch.zeros(n, dtype=torch.int32, device=dev))
    return bs, weight.mask(valid)


def eval_pdf(scene, bsdf_idx, si, wo: Vec3):
    n = si.t.shape[0]
    value = Vec3.zeros(n, si.t.device)
    pdf = torch.zeros(n, dtype=torch.float32, device=si.t.device)
    for mask, tbl in _tables(scene, bsdf_idx):
        v_k, p_k = _eval_pdf_one(tbl, si.wi, wo)
        value = Vec3.where(mask, v_k, value)
        pdf = torch.where(mask, p_k, pdf)
    return value, pdf
