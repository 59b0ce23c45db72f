"""Film — counterpart of ``mitsuba3_tpu/render/film.py`` (hdrfilm with its
default Gaussian reconstruction filter).

Samples are generated sppc-per-pixel in linear pixel order, so the splat
is a per-pixel segment sum for each static filter tap followed by a
shifted dense add: deterministic, with no atomics.
"""
from __future__ import annotations

import dataclasses
import math

import torch


@dataclasses.dataclass(frozen=True)
class FilmConfig:
    width: int = 256
    height: int = 256
    rfilter: str = "gaussian"
    rfilter_radius: float = 2.0
    rfilter_std: float = 0.5


def gaussian_weight(x, std, radius):
    """gaussian.cpp: exp(-x^2/(2 s^2)) - exp(-r^2/(2 s^2)), clamped >= 0."""
    alpha = -1.0 / (2.0 * std * std)
    return torch.clamp(torch.exp(alpha * x * x)
                       - math.exp(alpha * radius * radius), min=0.0)


def rfilter_eval(name: str, x, radius, std=0.5):
    """Evaluate the reconstruction filter at offsets x (pixels)."""
    if name == "gaussian":
        return gaussian_weight(x, std, radius)
    raise NotImplementedError(f"rfilter {name!r} is not ported")


def halo_rows(film: FilmConfig) -> int:
    """Vertical halo (rows) a splat canvas needs beyond its pixels."""
    return int(math.ceil(film.rfilter_radius))


def _shifted(img, ha: int, dy: int, dx: int):
    """`img` [Hi, W, ...] placed at static offset (dy, dx) on a zero canvas
    of `ha` rows, clipped to its bounds (out of place, so autograd follows
    every tap)."""
    hi, w = img.shape[0], img.shape[1]
    sy0, sy1 = max(0, -dy), min(hi, ha - dy)
    sx0, sx1 = max(0, -dx), min(w, w - dx)
    if sy0 >= sy1 or sx0 >= sx1:
        return None
    ty0, tx0 = sy0 + dy, sx0 + dx
    part = img[sy0:sy1, sx0:sx1]
    # F.pad pads the last dimension first: (..., x before, x after, y
    # before, y after) with the channel dimension, if any, left alone
    chan = (0, 0) * (img.dim() - 2)
    pads = chan + (tx0, w - tx0 - (sx1 - sx0), ty0, ha - ty0 - (sy1 - sy0))
    return torch.nn.functional.pad(part, pads)


def splat_ordered(film: FilmConfig, jitter, values, sppc: int, h_local: int,
                  w: int):
    """Splat pixel-ordered samples.

    jitter: Vec2 sample offset within its pixel, in [0, 1).
    values: [N, C]; N = h_local * w * sppc, pixel-major.
    Returns (image [h_local + 2*halo, w, C], weight [h_local + 2*halo, w]).
    Horizontal spill is clipped (border discard, like the reference's
    film border). Differentiable in `values`: each filter tap is a
    per-pixel sum placed on the canvas by an out-of-place pad."""
    def per_pixel(x):
        return x.reshape(h_local, w, sppc, -1).sum(dim=2)

    nch = values.shape[-1]
    radius = film.rfilter_radius
    r_int = int(math.ceil(radius))
    ha = h_local + 2 * r_int
    dev = values.device
    image = torch.zeros((ha, w, nch), dtype=torch.float32, device=dev)
    weight = torch.zeros((ha, w), dtype=torch.float32, device=dev)
    for dy in range(-r_int, r_int + 1):
        wy = rfilter_eval(film.rfilter, dy + 0.5 - jitter.y, radius,
                          film.rfilter_std)
        for dx in range(-r_int, r_int + 1):
            wx = rfilter_eval(film.rfilter, dx + 0.5 - jitter.x, radius,
                              film.rfilter_std)
            tw = wx * wy
            tap = _shifted(per_pixel(tw[:, None] * values), ha,
                           dy + r_int, dx)
            if tap is not None:
                image = image + tap
                weight = weight + _shifted(per_pixel(tw[:, None])[..., 0],
                                           ha, dy + r_int, dx)
    return image, weight


def develop(image, weight):
    """Weight division (hdrfilm.cpp develop)."""
    w = torch.clamp(weight, min=1e-20)[..., None]
    return torch.where(weight[..., None] > 0.0, image / w, 0.0)
