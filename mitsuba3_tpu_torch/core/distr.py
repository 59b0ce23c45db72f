"""1D discrete distribution — counterpart of ``DiscreteDistribution`` in
``mitsuba3_tpu/core/distr.py`` (the sampling the area-light NEE needs).

``pick`` is the inverse-CDF lookup of a sample against an inclusive
cumulative table, ``searchsorted(cdf, xi, side="right")`` clipped to the
table; the scene uses it on ``ef_cdf``, whose last entry is the area
emitters' share of the unit interval, with the sample unscaled.
"""
from __future__ import annotations

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
