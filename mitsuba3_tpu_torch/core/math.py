"""Math helpers — counterpart of ``mitsuba3_tpu/core/math.py`` (the subset
the port's path reaches)."""
from __future__ import annotations

import numpy as np
import torch

Pi = 3.141592653589793
InvPi = 1.0 / Pi
InvTwoPi = 1.0 / (2.0 * Pi)
InvFourPi = 1.0 / (4.0 * Pi)
TwoPi = 2.0 * Pi
Epsilon = float(np.finfo(np.float32).eps) / 2
RayEpsilon = Epsilon * 1500.0          # mirrors math::RayEpsilon (math.h)
ShadowEpsilon = RayEpsilon * 10.0


def sqr(x):
    return x * x


def safe_sqrt(x):
    """sqrt(max(x, 0)), whose gradient is 0 (not inf or NaN) where x <= 0:
    a BSDF's branch not taken (total internal reflection, a grazing
    cosine) must not turn the replay's local gradient into NaN."""
    pos = x > 0.0
    return torch.where(pos, torch.sqrt(torch.where(pos, x, 1.0)), 0.0)


def safe_rsqrt(x):
    return torch.rsqrt(torch.clamp(x, min=torch.finfo(torch.float32).tiny))


def safe_acos(x):
    return torch.acos(torch.clamp(x, -1.0, 1.0))


def safe_asin(x):
    return torch.asin(torch.clamp(x, -1.0, 1.0))


def sign(x):
    return torch.where(x >= 0.0, 1.0, -1.0)


def safe_div(a, b, fallback=0.0):
    """a / b with `fallback` where b == 0 (avoids NaN poisoning masked lanes)."""
    b_ok = b != 0.0
    denom = torch.where(b_ok, b, 1.0)
    return torch.where(b_ok, a / denom, fallback)
