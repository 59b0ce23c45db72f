"""Film — counterpart of ``mitsuba3_tpu/render/film.py`` (hdrfilm with the
box, tent, gaussian, mitchell, catmullrom and lanczos reconstruction
filters, and the film's crop window).

Samples are generated sppc-per-pixel in linear pixel order, so the splat
is a per-pixel segment sum for each static filter tap followed by a
shifted dense add: deterministic, with no atomics. The box filter puts
each sample in its own pixel: a per-pixel sum with weight sppc.
"""
from __future__ import annotations

import dataclasses
import math

import torch


RFILTERS = ("box", "tent", "gaussian", "mitchell", "catmullrom", "lanczos")


@dataclasses.dataclass(frozen=True)
class FilmConfig:
    width: int = 256
    height: int = 256
    rfilter: str = "gaussian"
    rfilter_radius: float = 2.0   # the Gaussian's; the others' are fixed
    rfilter_std: float = 0.5
    # film.h crop window: width/height above are the crop (the rendered
    # raster); the sensor maps the full film plane of full_width x
    # full_height with the crop at (crop_ox, crop_oy). full_* == 0 means
    # no crop.
    full_width: int = 0
    full_height: int = 0
    crop_ox: int = 0
    crop_oy: int = 0
    # a specfilm's channels: one response function per channel, SPD_N
    # values on the spectral grid each (read by the spectral variant);
    # () for an hdrfilm
    srfs: tuple = ()


def film_full(film: FilmConfig):
    """(full_w, full_h, crop_ox, crop_oy) with the no-crop default."""
    return (film.full_width or film.width, film.full_height or film.height,
            film.crop_ox, film.crop_oy)


def gaussian_weight(x, std, radius):
    """gaussian.cpp: exp(-x^2/(2 s^2)) - exp(-r^2/(2 s^2)), clamped >= 0."""
    alpha = -1.0 / (2.0 * std * std)
    return torch.clamp(torch.exp(alpha * x * x)
                       - math.exp(alpha * radius * radius), min=0.0)


def _mitchell_1d(x, b, c):
    """mitchell.cpp / catmullrom via the (B, C) parameterization."""
    x = x.abs()
    x2 = x * x
    x3 = x2 * x
    p1 = ((12 - 9 * b - 6 * c) * x3 + (-18 + 12 * b + 6 * c) * x2
          + (6 - 2 * b)) * (1.0 / 6.0)
    p2 = ((-b - 6 * c) * x3 + (6 * b + 30 * c) * x2
          + (-12 * b - 48 * c) * x + (8 * b + 24 * c)) * (1.0 / 6.0)
    return torch.where(x < 1.0, p1, torch.where(x < 2.0, p2, 0.0))


def _lanczos_1d(x, tau=3.0):
    """lanczos.cpp: sinc(x) sinc(x/tau) windowed to |x| < tau."""
    x = x.abs()
    pix = math.pi * torch.clamp(x, min=1e-6)
    sinc = torch.where(x < 1e-6, 1.0, torch.sin(pix) / pix)
    pixt = math.pi * torch.clamp(x, min=1e-6) / tau
    winc = torch.where(x < 1e-6, 1.0, torch.sin(pixt) / pixt)
    return torch.where(x < tau, sinc * winc, 0.0)


def rfilter_eval(name: str, x, radius, std=0.5):
    """Evaluate a reconstruction filter at offsets x (pixels)
    (src/rfilters/{box,tent,gaussian,mitchell,catmullrom,lanczos}.cpp)."""
    if name == "box":
        return torch.where(x.abs() <= 0.5, 1.0, 0.0)
    if name == "tent":
        return torch.clamp(1.0 - x.abs() / radius, min=0.0)
    if name == "gaussian":
        return gaussian_weight(x, std, radius)
    if name == "mitchell":
        return _mitchell_1d(x, 1.0 / 3.0, 1.0 / 3.0)
    if name == "catmullrom":
        return _mitchell_1d(x, 0.0, 0.5)
    if name == "lanczos":
        return _lanczos_1d(x, 3.0)
    raise ValueError(f"Unknown rfilter {name!r}")


def rfilter_radius(name: str) -> float:
    return {"box": 0.5, "tent": 1.0, "gaussian": 2.0, "mitchell": 2.0,
            "catmullrom": 2.0, "lanczos": 3.0}[name]


def _radius(film: FilmConfig) -> float:
    """The filter's radius: the Gaussian's is the film's, the others' are
    fixed."""
    return (film.rfilter_radius if film.rfilter == "gaussian"
            else rfilter_radius(film.rfilter))


def halo_rows(film: FilmConfig) -> int:
    """Vertical halo (rows) a splat canvas needs beyond its pixels."""
    if film.rfilter == "box":
        return 0
    return int(math.ceil(_radius(film)))


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
    per-pixel sum placed on the canvas by an out-of-place pad. A pixel's
    samples are added one by one in sample order, so a channel's sums do
    not depend on how many channels `values` has (a reduction kernel's
    order on the card does): aov's and moment's RGB equal path's."""
    def per_pixel(x):
        x = x.reshape(h_local, w, sppc, -1)
        out = x[:, :, 0]
        for k in range(1, sppc):
            out = out + x[:, :, k]
        return out

    if film.rfilter == "box":
        return per_pixel(values), torch.full(
            (h_local, w), float(sppc), dtype=torch.float32,
            device=values.device)
    nch = values.shape[-1]
    radius = _radius(film)
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
