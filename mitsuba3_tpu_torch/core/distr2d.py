"""Piecewise-constant 2D warp — counterpart of ``SlicedMarginal2D`` and
``eval_bilinear_sliced`` in ``mitsuba3_tpu/core/distr2d.py`` (the
environment emitter's sampling tables, one slice, and the measured BSDF's
conditioned warps and tables, a slice per incident direction).

The tables are built on the host in NumPy, exactly as the JAX package
builds them. Sampling inverts the marginal and the conditional CDF by
counting the entries below the sample, as the JAX package does; the
count is a binary search (``_count_below``), not a compare over a row
gathered per lane, which at an environment map's 2048 columns and a
million lanes would take gigabytes. One table slice per condition; the
environment uses a single slice (S = 1). Lookups of one entry per lane
(``_at``) gather that entry alone, where the JAX package selects it from a
row gathered per lane: the selected values are the same.
"""
from __future__ import annotations

import numpy as np
import torch

from .math import safe_div
from .struct import struct
from .vec import Vec2


@struct
class SlicedMarginal2D:
    density: torch.Tensor   # [S, H, W]; each slice integrates to 1 on [0,1]^2
    marg_cdf: torch.Tensor  # [S, H] row CDF (ends at 1)
    cond_cdf: torch.Tensor  # [S*H, W] per-row column CDF (ends at 1)

    @staticmethod
    def from_data(data, device) -> "SlicedMarginal2D":
        d = np.maximum(np.asarray(data, np.float32), 0.0)
        s, h, w = d.shape
        total = np.maximum(d.sum(axis=(1, 2), keepdims=True), 1e-20)
        density = d / total * (h * w)
        rows = density.sum(axis=2)
        marg_cdf = np.cumsum(rows / np.maximum(
            rows.sum(axis=1, keepdims=True), 1e-20), axis=1)
        cond = density / np.maximum(density.sum(axis=2, keepdims=True),
                                    1e-20)
        cond_cdf = np.cumsum(cond, axis=2).reshape(s * h, w)
        return SlicedMarginal2D(
            density=torch.as_tensor(density, device=device),
            marg_cdf=torch.as_tensor(marg_cdf, device=device),
            cond_cdf=torch.as_tensor(cond_cdf, device=device))

    def sample(self, k, s: Vec2):
        """k [N] slice index, s uniform -> (pos Vec2 in [0,1]^2, pdf [N])."""
        h = self.marg_cdf.shape[1]
        w = self.cond_cdf.shape[1]
        iy = torch.clamp(_count_below(self.marg_cdf, k, s.y), max=h - 1)
        cy = _at(self.marg_cdf, k, iy)
        py = _at(self.marg_cdf, k, iy - 1)
        fy = safe_div(s.y - py, cy - py)

        row = k * h + iy
        ix = torch.clamp(_count_below(self.cond_cdf, row, s.x), max=w - 1)
        cx = _at(self.cond_cdf, row, ix)
        px = _at(self.cond_cdf, row, ix - 1)
        fx = safe_div(s.x - px, cx - px)

        pos = Vec2((ix + fx.clamp(0.0, 1.0)) / w,
                   (iy + fy.clamp(0.0, 1.0)) / h)
        return pos, self.eval(k, pos)

    def invert(self, k, pos: Vec2):
        """pos -> (the uniform sample that maps to it, pdf [N])
        (Marginal2D::invert)."""
        h = self.marg_cdf.shape[1]
        w = self.cond_cdf.shape[1]
        iy = torch.clamp((pos.y * h).to(torch.int32), 0, h - 1)
        fy = pos.y * h - iy
        cy = _at(self.marg_cdf, k, iy)
        py = _at(self.marg_cdf, k, iy - 1)
        sy = py + fy * (cy - py)

        ix = torch.clamp((pos.x * w).to(torch.int32), 0, w - 1)
        fx = pos.x * w - ix
        row = k * h + iy
        cx = _at(self.cond_cdf, row, ix)
        px = _at(self.cond_cdf, row, ix - 1)
        sx = px + fx * (cx - px)
        return Vec2(sx, sy), self.eval(k, pos)

    def eval(self, k, pos: Vec2):
        """Density at pos (pdf on the unit square)."""
        s_count, h = self.marg_cdf.shape
        w = self.cond_cdf.shape[1]
        iy = torch.clamp((pos.y * h).to(torch.int32), 0, h - 1)
        ix = torch.clamp((pos.x * w).to(torch.int32), 0, w - 1)
        return _at(self.density.reshape(s_count * h, w), k * h + iy, ix)


def eval_bilinear_sliced(tbl, k, pos: Vec2):
    """Bilinear lookup in the sliced table tbl [S, H, W] at pos in [0,1]^2,
    slice k per lane (the measured BSDF's spectra, ndf and sigma)."""
    s_count, h, w = tbl.shape
    flat = tbl.reshape(s_count * h, w)
    x = torch.clamp(pos.x * (w - 1), 0.0, w - 1.0)
    y = torch.clamp(pos.y * (h - 1), 0.0, h - 1.0)
    x0 = torch.clamp(torch.floor(x).to(torch.int32), 0, w - 2)
    y0 = torch.clamp(torch.floor(y).to(torch.int32), 0, h - 2)
    fx = x - x0
    fy = y - y0
    r0 = k * h + y0
    v00 = _at(flat, r0, x0)
    v01 = _at(flat, r0, x0 + 1)
    v10 = _at(flat, r0 + 1, x0)
    v11 = _at(flat, r0 + 1, x0 + 1)
    return ((v00 * (1 - fx) + v01 * fx) * (1 - fy)
            + (v10 * (1 - fx) + v11 * fx) * fy)


def _count_below(table, row, x):
    """The number of entries of table[row[i]] below x[i] per lane (each
    row is non-decreasing), without a [N, C] row per lane: one search of
    the rows laid end to end, row r's entries raised by r in float64,
    where r + entry is exact, so each comparison is the float32 one."""
    c = table.shape[1]
    keys = (torch.arange(table.shape[0], device=table.device,
                         dtype=torch.float64)[:, None]
            + table.to(torch.float64)).reshape(-1)
    r = row.to(torch.int64)
    below = torch.searchsorted(keys, r.to(torch.float64) + x.to(
        torch.float64))
    return torch.clamp(below - r * c, min=0).to(torch.int32)


def _at(table, row, col):
    """table[row[i], col[i]] per lane, 0 where col is out of range (col ==
    -1)."""
    c = table.shape[1]
    ok = (col >= 0) & (col < c)
    idx = row.to(torch.int64) * c + torch.clamp(col, 0, c - 1).to(torch.int64)
    return torch.where(ok, table.reshape(-1)[idx], 0.0)
