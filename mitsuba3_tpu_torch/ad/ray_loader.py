"""Streaming pixel mini-batches for inverse rendering — counterpart of
``mitsuba3_tpu/ad/ray_loader.py`` (the reference's RayDataLoader and
FlatSensor, src/python/python/ad/loaders/ray_loader.py).

``RayDataLoader`` yields (pixel ids, reference values) batches drawn from
a numpy generator, the JAX package's draws in its order, so the batches
equal its own bit for bit; ``render_batch`` traces exactly those pixels
through the scene's integrator, differentiable as a render is.
"""
from __future__ import annotations

import numpy as np
import torch

from ..core import spectral
from ..core.vec import Vec2, Vec3
from ..integrators import get_integrator
from ..render import sampler as sampler_mod
from ..render.integrator import sample_camera_ray


class RayDataLoader:
    """Iterate random pixel mini-batches against reference images.

    references: [S, H, W, 3] (or [H, W, 3]) target images, one per sensor
    viewpoint. For S > 1 the scene is loaded with a ``batch`` sensor of the
    S viewpoints (film width S * W): a batch mixes pixels of every view and
    its pixel ids index the batch film. `device` is where the batches'
    tensors live (the card unless the caller asks for another)."""

    def __init__(self, references, batch_size: int = 4096, seed: int = 0,
                 spp: int = 4, device=None):
        refs = np.asarray(references, np.float32)
        if refs.ndim == 3:
            refs = refs[None]
        self.references = refs
        self.n_sensors, self.height, self.width = refs.shape[:3]
        self.batch_size = batch_size
        self.spp = spp
        self.device = torch.device("cuda" if device is None else device)
        self._rng = np.random.default_rng(seed)
        self._flat = refs.reshape(self.n_sensors, self.height * self.width,
                                  3)

    def __iter__(self):
        return self

    def batch_film_ids(self, sensor, pix):
        """(sensor, per-view pixel id) -> the pixel id in the batch film
        whose columns put the S views side by side."""
        row = pix // self.width
        col = pix % self.width
        return row * (self.width * self.n_sensors) + sensor * self.width \
            + col

    def __next__(self):
        """(batch-film pixel ids [B] int32, reference values [B, 3])."""
        sensor = self._rng.integers(self.n_sensors, size=self.batch_size)
        pix = self._rng.integers(0, self.height * self.width,
                                 self.batch_size)
        target = self._flat[sensor, pix]
        ids = self.batch_film_ids(sensor, pix) if self.n_sensors > 1 \
            else pix
        return (torch.as_tensor(ids.astype(np.int32), device=self.device),
                torch.as_tensor(target, device=self.device))


def render_batch(scene, pixel_ids, seed: int = 0, spp: int = 4):
    """Trace `spp` samples of each pixel of `pixel_ids` (the FlatSensor's
    role): the per-pixel mean radiance [B, 3] (XYZ in the spectral
    variant), differentiable through the scene's integrator."""
    w, h = scene.film.width, scene.film.height
    dev = scene.device
    pixel_ids = torch.as_tensor(pixel_ids, device=dev).to(torch.int64)
    b = pixel_ids.shape[0]
    pix = pixel_ids.repeat_interleave(spp)
    sample_idx = torch.arange(spp, dtype=torch.int64, device=dev).repeat(b)
    rng = sampler_mod.seed(seed, sample_idx, pix, spp,
                           stype=scene.sampler_type, base_seed=seed)
    rng, jitter = sampler_mod.next_2d(rng)
    pos01 = Vec2(((pix % w).to(torch.float32) + jitter.x) / w,
                 ((pix // w).to(torch.float32) + jitter.y) / h)
    rng, ray = sample_camera_ray(scene, rng, pos01)
    L = get_integrator(scene.integrator).sample(scene, rng, ray,
                                                scene.integrator)[0]
    if isinstance(L, Vec3):
        if scene.spectral:
            L = spectral.spectral_to_xyz(L, ray.wl)
        L = L.to_array()
    return L.reshape(b, spp, -1).mean(dim=1)
