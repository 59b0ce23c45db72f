"""Render orchestration — counterpart of ``mitsuba3_tpu/render/integrator.py``.

A render is a Python loop over passes of ``sppc`` samples per pixel:
seed -> camera rays -> path trace -> splat, then develop. The wavefront of
a pass is capped at ``max_wavefront`` lanes, as in the JAX package, so
both packages split a render into the same passes and draw the same
random numbers. There is no compiled program and no host-level
compaction: the integrators drop finished lanes after each bounce.

Under the ``prb`` integrator the image is differentiable in the scene's
parameter tables (``ad/prb.py``): each pass's samples come from a
``torch.autograd.Function`` and the film's splat and ``develop`` are
out-of-place ops that autograd follows.
"""
from __future__ import annotations

import functools

import torch

from .. import sensors
from ..core import spectral, spectrum
from ..core.random import M32
from ..core.vec import Vec2, Vec3
from ..integrators import get_integrator, n_channels
from . import film as film_mod
from . import sampler as sampler_mod

GOLDEN = 0x9E3779B9  # pass-seed stride


def pass_seed(seed: int, i: int) -> int:
    """uint32 ``seed ^ (i * 0x9E3779B9)`` of pass i."""
    return (int(seed) & M32) ^ ((int(i) * GOLDEN) & M32)


def _gen_camera_rays(scene, seed_value: int, sppc: int, pass_idx: int,
                     spp_total: int, base_seed: int = 0):
    """Seed the sampler and generate one pass's primary rays, sppc per
    pixel in linear pixel order. Returns (rng, ray, jitter).

    A crop window (film.h) keeps the full film's pixel ids and positions:
    a crop render is sample for sample the same region of the full
    render."""
    w, h = scene.film.width, scene.film.height
    fw, fh, cox, coy = film_mod.film_full(scene.film)
    dev = scene.device
    n = w * h * sppc
    idx = torch.arange(n, dtype=torch.int64, device=dev)
    pixel = idx // sppc
    sample_idx = (idx % sppc + pass_idx * sppc) & M32
    pix_x = pixel % w
    pix_y = pixel // w
    if cox or coy:
        pix_x = pix_x + cox
        pix_y = pix_y + coy
    rng = sampler_mod.seed(seed_value, sample_idx, pix_y * fw + pix_x,
                           spp_total, stype=scene.sampler_type,
                           base_seed=base_seed)
    rng, jitter = sampler_mod.next_2d(rng)
    pos01 = Vec2((pix_x.to(torch.float32) + jitter.x) / fw,
                 (pix_y.to(torch.float32) + jitter.y) / fh)
    rng, ray = sample_camera_ray(scene, rng, pos01)
    return rng, ray, jitter


def sample_camera_ray(scene, rng, pos01: Vec2):
    """The sensor's rays through film positions `pos01` in [0, 1]^2: the
    thin lens's aperture sample, then in the spectral variant the hero
    wavelength (``ray.wl``), drawn from `rng`. Returns (rng, ray)."""
    cfg = scene.sensor_config
    ap = None
    if cfg.type == "thinlens" or (cfg.type == "batch"
                                  and "thinlens" in cfg.sub_types):
        rng, ap = sampler_mod.next_2d(rng)
    if cfg.type == "batch":
        ray = sensors.sample_ray_batch(scene.sensor, pos01, cfg.sub_types,
                                       aperture_sample=ap)
    else:
        ray = sensors.sample_ray(scene.sensor, pos01, stype=cfg.type,
                                 aperture_sample=ap)
    if scene.spectral:
        rng, u_wl = sampler_mod.next_1d(rng)
        ray = ray.replace(wl=spectral.sample_wavelengths(u_wl)[0])
    return rng, ray


def film_values(scene, L, wl):
    """The film's channels of one sample: L itself in RGB; in the spectral
    variant XYZ, or with a specfilm one channel per response function
    (the estimate of its integral against L), both at the primary ray's
    wavelengths `wl`. L is a Vec3 or an [N, C] tensor (aov, moment)."""
    if not isinstance(L, Vec3):
        return L
    if scene.spectral and scene.film.srfs:
        return torch.stack([
            L.dot(spectral.eval_spd(srf, wl)) * (spectral.LAMBDA_RANGE / 3.0)
            for srf in _srf_tables(scene.film.srfs, L.x.device)], dim=-1)
    if scene.spectral:
        L = spectral.spectral_to_xyz(L, wl)
    return L.to_array()


@functools.lru_cache(maxsize=8)
def _srf_tables(srfs: tuple, device: torch.device) -> torch.Tensor:
    """A specfilm's response functions (``FilmConfig.srfs``) as one
    [C, SPD_N] tensor on `device`, copied there once."""
    return torch.tensor(srfs, dtype=torch.float32, device=device)


def n_film_channels(scene) -> int:
    """The film's channel count: a specfilm's response functions in the
    spectral variant, else the integrator's."""
    if scene.spectral and scene.film.srfs:
        return len(scene.film.srfs)
    return n_channels(scene.integrator)


def develop(scene, image, weight):
    """The developed image; the spectral variant's XYZ film turned into
    linear sRGB (a specfilm's channels stay as they are)."""
    out = film_mod.develop(image, weight)
    if scene.spectral and not scene.film.srfs:
        if out.shape[-1] not in (1, 3):
            # the JAX package's einsum over the channels fails here too (it
            # broadcasts one channel)
            raise ValueError(
                f"the {scene.integrator.type} integrator's {out.shape[-1]} "
                f"film channels in the spectral variant: its film develops "
                f"3 channels of XYZ to sRGB")
        out = spectrum.xyz_to_srgb(out.expand(*out.shape[:-1], 3))
    return out


def _finalize_splat(scene, L, wl, jitter, sppc: int):
    """Splat one pass onto the film. Returns (image [H, W, C], weight
    [H, W]); L is a Vec3 or an [N, C] tensor (aov, moment), `wl` the
    primary rays' wavelengths (spectral variant)."""
    w, h = scene.film.width, scene.film.height
    halo = film_mod.halo_rows(scene.film)
    values = film_values(scene, L, wl)
    image, weight = film_mod.splat_ordered(scene.film, jitter, values,
                                           sppc, h, w)
    return image[halo:halo + h], weight[halo:halo + h]


def render_pass(scene, seed_value: int, sppc: int, pass_idx: int = 0,
                spp_total: int | None = None, base_seed: int = 0):
    """Trace one pass of `sppc` samples per pixel. Returns (image, weight,
    n_rays): n_rays counts the primary rays plus every closest-hit and
    shadow query the integrator issued."""
    rng, ray, jitter = _gen_camera_rays(scene, seed_value, sppc, pass_idx,
                                        spp_total or sppc, base_seed)
    n = ray.o.x.shape[0]
    L, _, n_rays = get_integrator(scene.integrator).sample(
        scene, rng, ray, scene.integrator)
    image, weight = _finalize_splat(scene, L, ray.wl, jitter, sppc)
    return image, weight, n_rays + n


def plan_passes(scene, spp=None, max_wavefront=1 << 19):
    spp = spp if spp is not None else scene.spp
    n_pixels = scene.film.width * scene.film.height
    sppc = max(1, min(spp, max_wavefront // n_pixels))
    while spp % sppc != 0:
        sppc -= 1
    return sppc, spp // sppc


def render_with_stats(scene, seed=0, spp=None, max_wavefront=1 << 19):
    """Forward render -> (image [H, W, C] on the scene's device, C = 3 but
    under aov and moment and with a specfilm, total ray-query count as an
    int). Under ``prb``
    the image carries autograd history to any parameter table of `scene`
    that requires grad."""
    sppc, n_passes = plan_passes(scene, spp, max_wavefront)
    w, h = scene.film.width, scene.film.height
    image = torch.zeros((h, w, n_film_channels(scene)),
                        dtype=torch.float32, device=scene.device)
    weight = torch.zeros((h, w), dtype=torch.float32, device=scene.device)
    rays = 0
    for i in range(n_passes):
        img_i, wgt_i, rays_i = render_pass(scene, pass_seed(seed, i), sppc,
                                           pass_idx=i,
                                           spp_total=sppc * n_passes,
                                           base_seed=seed)
        image = image + img_i
        weight = weight + wgt_i
        rays += rays_i
    return develop(scene, image, weight), rays


def render(scene, seed=0, spp=None, max_wavefront=1 << 19):
    """Forward render -> developed image [H, W, C] (mi.render). The light
    tracer splats to the film itself (``ptracer.render_ptracer``), at
    `spp` or 16 light paths per pixel of the full film, as the JAX
    package's ``render`` sends it."""
    if scene.integrator.type == "ptracer":
        from ..integrators.ptracer import render_ptracer
        return render_ptracer(scene, seed=seed, spp=spp or 16)
    return render_with_stats(scene, seed, spp, max_wavefront)[0]
