"""SGGX microflake phase function — counterpart of
``mitsuba3_tpu/phase/sggx.py``
(src/phase/sggx.cpp, include/mitsuba/render/microflake.h; Heitz et al.
2015, specular variant). The row's [12:18] hold S as (Sxx, Syy, Szz, Sxy,
Sxz, Syz); sampling draws a visible microflake normal and mirrors wi about
it; pdf = D_visible(wh) / (4 sigma(wi))."""
from __future__ import annotations

import torch

from ..core import math as m
from ..core.frame import Frame
from ..core.vec import Vec3
from ..core.warp import square_to_cosine_hemisphere

FLAGS = 0x02 | 0x04


def _s_of(params):
    return (params[12], params[13], params[14],
            params[15], params[16], params[17])


def projected_area(s, wi: Vec3):
    """sqrt(wi^T S wi) (microflake.h:154-166)."""
    sxx, syy, szz, sxy, sxz, syz = s
    sigma2 = (wi.x * wi.x * sxx + wi.y * wi.y * syy + wi.z * wi.z * szz
              + 2.0 * (wi.x * wi.y * sxy + wi.x * wi.z * sxz
                       + wi.y * wi.z * syz))
    return m.safe_sqrt(sigma2)


def ndf_pdf(s, wm: Vec3):
    """Visible-normal density of the SGGX NDF (microflake.h:123-137)."""
    sxx, syy, szz, sxy, sxz, syz = s
    det_s = torch.abs(sxx * syy * szz - sxx * syz * syz - syy * sxz * sxz
                      - szz * sxy * sxy + 2.0 * sxy * sxz * syz)
    den = (wm.x * wm.x * (syy * szz - syz * syz)
           + wm.y * wm.y * (sxx * szz - sxz * sxz)
           + wm.z * wm.z * (sxx * syy - sxy * sxy)
           + 2.0 * (wm.x * wm.y * (sxz * syz - szz * sxy)
                    + wm.x * wm.z * (sxy * syz - syy * sxz)
                    + wm.y * wm.z * (sxy * sxz - sxx * syz)))
    return m.safe_div(torch.clamp(det_s, min=0.0) * m.safe_sqrt(det_s),
                      m.Pi * den * den)


def sample_normal(s, wi: Vec3, s2):
    """Visible-normal sampling in the frame of wi (microflake.h:74-97)."""
    frame = Frame.from_normal(wi)
    sxx, syy, szz, sxy, sxz, syz = s

    def smat_dot(v: Vec3) -> Vec3:
        return Vec3(sxx * v.x + sxy * v.y + sxz * v.z,
                    sxy * v.x + syy * v.y + syz * v.z,
                    sxz * v.x + syz * v.y + szz * v.z)

    # S' = M S M^T with M's rows the (s, t, n) of wi's frame
    rs, rt, rn = frame.s, frame.t, frame.n
    ss, st, sn = smat_dot(rs), smat_dot(rt), smat_dot(rn)
    s_kk, s_kj, s_ki = rs.dot(ss), rs.dot(st), rs.dot(sn)
    s_jj, s_ji, s_ii = rt.dot(st), rt.dot(sn), rn.dot(sn)
    det = (s_kk * s_jj * s_ii - s_kk * s_ji * s_ji - s_jj * s_ki * s_ki
           - s_ii * s_kj * s_kj + 2.0 * s_kj * s_ki * s_ji)
    inv_sqrt_s_ii = m.safe_rsqrt(torch.clamp(s_ii, min=1e-12))
    tmp = m.safe_sqrt(torch.clamp(s_jj * s_ii - s_ji * s_ji, min=1e-20))
    zero = torch.zeros_like(tmp)
    m_k = Vec3(m.safe_sqrt(det.abs()) / tmp, zero, zero)
    m_j = Vec3(-inv_sqrt_s_ii * (s_ki * s_ji - s_kj * s_ii) / tmp,
               inv_sqrt_s_ii * tmp, zero)
    m_i = Vec3(inv_sqrt_s_ii * s_ki, inv_sqrt_s_ii * s_ji,
               inv_sqrt_s_ii * s_ii)
    uvw = square_to_cosine_hemisphere(s2)
    local = (m_k * uvw.x + m_j * uvw.y + m_i * uvw.z).normalize()
    return frame.to_world(local)


def sample(scene, med_idx, wi, s1, s2):
    s = _s_of(scene.gather_medium_params(med_idx))
    wm = sample_normal(s, wi, s2)
    wo = (wm * (2.0 * wi.dot(wm)) - wi).normalize()
    pdf = 0.25 * m.safe_div(ndf_pdf(s, wm), projected_area(s, wi))
    return wo, torch.ones_like(s1), pdf


def eval_pdf(scene, med_idx, wi, wo):
    s = _s_of(scene.gather_medium_params(med_idx))
    wh = (wi + wo).normalize()
    pdf = 0.25 * m.safe_div(ndf_pdf(s, wh), projected_area(s, wi))
    return pdf, pdf
