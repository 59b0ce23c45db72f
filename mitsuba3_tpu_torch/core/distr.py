"""1D distributions — counterpart of ``DiscreteDistribution`` and
``ContinuousDistribution`` in ``mitsuba3_tpu/core/distr.py`` (the
sampling the area-light NEE and the tabulated phase function need).

``pick`` is the inverse-CDF lookup of a sample against an inclusive
cumulative table, ``searchsorted(cdf, xi, side="right")`` clipped to the
table; the scene uses it on ``ef_cdf``, whose last entry is the area
emitters' share of the unit interval, with the sample unscaled.
"""
from __future__ import annotations

import numpy as np
import torch

from .math import safe_div
from .struct import struct


def pick(cdf, xi):
    """Index i with cdf[i-1] <= xi < cdf[i] (searchsorted side="right"),
    clipped to [0, len(cdf) - 1]; int32 like `xi`'s lanes."""
    idx = torch.searchsorted(cdf, xi.contiguous(), right=True)
    return torch.clamp(idx, 0, cdf.shape[0] - 1).to(torch.int32)


@struct
class DiscreteDistribution:
    pmf: torch.Tensor   # [N] unnormalized
    cdf: torch.Tensor   # [N] inclusive cumulative sum (unnormalized)

    @staticmethod
    def from_pmf(pmf):
        pmf = torch.as_tensor(pmf, dtype=torch.float32)
        return DiscreteDistribution(pmf=pmf, cdf=torch.cumsum(pmf, 0))

    @property
    def total(self):
        return self.cdf[-1]

    def eval_pmf_normalized(self, index):
        return self.pmf[index.long()] * safe_div(1.0, self.total)

    def sample(self, xi):
        """xi in [0, 1) -> index."""
        return pick(self.cdf, xi * self.total)


@struct
class ContinuousDistribution:
    """Piecewise-linear pdf on [range_min, range_max] (distr_1d.h:292)."""
    pdf: torch.Tensor    # [N] unnormalized values at the nodes
    cdf: torch.Tensor    # [N-1] integrated segments, cumulative
    range_min: float
    range_max: float

    @staticmethod
    def from_pdf(pdf, range_min: float, range_max: float):
        n = pdf.shape[0]
        interval = (range_max - range_min) / (n - 1)
        segments = 0.5 * (pdf[:-1] + pdf[1:]) * interval
        return ContinuousDistribution(pdf=pdf, cdf=torch.cumsum(segments, 0),
                                      range_min=range_min,
                                      range_max=range_max)

    @property
    def integral(self):
        return self.cdf[-1]

    def _interval(self) -> float:
        """The node spacing, rounded to float32 as JAX computes it."""
        return float(np.float32(np.float32(self.range_max)
                                - np.float32(self.range_min))
                     / np.float32(self.pdf.shape[0] - 1))

    def sample(self, xi):
        """Positions distributed by the pdf, for xi in [0, 1)."""
        n = self.pdf.shape[0]
        value = xi * self.integral
        idx = torch.clamp(torch.searchsorted(self.cdf, value.contiguous(),
                                             right=True), 0, n - 2)
        cdf_prev = torch.where(idx > 0, self.cdf[torch.clamp(idx - 1, min=0)],
                               0.0)
        interval = self._interval()
        v0 = self.pdf[idx]
        v1 = self.pdf[idx + 1]
        # invert v0 t + (v1 - v0) t^2 / 2 = rem on the segment
        rem = (value - cdf_prev) / interval
        a = 0.5 * (v1 - v0)
        disc = torch.clamp(v0 * v0 + 4.0 * a * rem, min=0.0)
        t_lin = safe_div(rem, v0)
        t_quad = safe_div(-v0 + torch.sqrt(disc), 2.0 * a)
        t = torch.where(a.abs() < 1e-6 * (v0 + v1 + 1e-12), t_lin, t_quad)
        t = torch.clamp(t, 0.0, 1.0)
        return self.range_min + (idx + t) * interval

    def eval_pdf_normalized(self, x):
        n = self.pdf.shape[0]
        interval = self._interval()
        t = (x - self.range_min) / interval
        idx = torch.clamp(t.to(torch.int32), 0, n - 2)
        frac = t - idx
        v0 = self.pdf[idx]
        v1 = self.pdf[idx + 1]
        inside = (x >= self.range_min) & (x <= self.range_max)
        return torch.where(inside, (v0 + (v1 - v0) * frac)
                           * safe_div(1.0, self.integral), 0.0)
