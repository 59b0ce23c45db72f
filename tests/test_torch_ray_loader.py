"""Port parity for the ray loader (``ad/ray_loader.py``): the
``RayDataLoader``'s batches (pixel ids and reference values, one view or
several) bit-equal to the JAX package's from the same seed;
``render_batch`` of the loader's pixels per pixel against JAX's, in the
RGB variant (Cornell box) and in the spectral variant (XYZ); and, under
``prb``, a few gradient steps of the batch loss lowering it."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mitsuba3_tpu as mj
from mitsuba3_tpu.ad import ray_loader as j_rl

import chip_smoke
import mitsuba3_tpu_torch as mt

torch.set_num_threads(1)
SIDE, BATCH, SPP = 16, 96, 4


@pytest.mark.parametrize("views", [1, 3])
def test_batches_bit_equal_jax(np_rng, views):
    refs = np_rng.uniform(0, 1, (views, 6, 10, 3)).astype(np.float32)
    if views == 1:
        refs = refs[0]
    lj = j_rl.RayDataLoader(refs, batch_size=BATCH, seed=11, spp=SPP)
    lt = mt.ad.RayDataLoader(refs, batch_size=BATCH, seed=11, spp=SPP,
                             device="cpu")
    assert (lt.n_sensors, lt.height, lt.width) == (lj.n_sensors, lj.height,
                                                    lj.width)
    for _ in range(4):
        (ids_j, ref_j), (ids_t, ref_t) = next(lj), next(lt)
        assert ids_t.dtype == torch.int32
        np.testing.assert_array_equal(ids_t.numpy(), np.asarray(ids_j))
        np.testing.assert_array_equal(ref_t.numpy(), np.asarray(ref_j))


def _scene_dict(mi, spectral: bool):
    if spectral:
        return chip_smoke.spectral_variant_cornell_dict(mi, SIDE, SIDE, 3)
    return mi.cornell_box(SIDE, SIDE, max_depth=3)


@pytest.mark.parametrize("spectral", [False, True])
def test_render_batch_matches_jax(np_rng, spectral):
    """The batch's per-pixel means (XYZ in the spectral variant) at
    rtol 1e-3, atol 1e-3 on > 99.5 % of values, their mean at rtol 1e-4."""
    refs = np_rng.uniform(0, 1, (SIDE, SIDE, 3)).astype(np.float32)
    ids, _ = next(mt.ad.RayDataLoader(refs, BATCH, seed=2, device="cpu"))
    sj = mj.load_dict(_scene_dict(mj, spectral), spectral=spectral)
    st = mt.load_dict(_scene_dict(mt, spectral), device="cpu",
                      spectral=spectral)
    got = mt.ad.render_batch(st, ids, seed=3, spp=SPP).numpy()
    want = np.asarray(j_rl.render_batch(sj, jnp.asarray(ids.numpy()),
                                        seed=3, spp=SPP))
    assert got.shape == want.shape == (BATCH, 3)
    assert np.isfinite(got).all() and got.mean() > 0.01
    assert np.isclose(got, want, rtol=1e-3, atol=1e-3).mean() > 0.995
    np.testing.assert_allclose(got.mean(), want.mean(), rtol=1e-4)


@pytest.mark.parametrize("spectral", [False, True])
def test_render_batch_steps_lower_the_loss(spectral):
    """Targets rendered from the Cornell box; its BSDF rows perturbed;
    five SGD steps on one batch's mean((render_batch - target)^2) through
    prb lower that loss."""
    d = chip_smoke._prb_dict(_scene_dict(mt, spectral))
    scene = mt.load_dict(d, device="cpu", spectral=spectral)
    ref = mt.render(scene, seed=0, spp=16).detach()
    if spectral:
        # render_batch gives XYZ: the targets are the film's XYZ
        from mitsuba3_tpu_torch.core import spectrum
        ref = spectrum.srgb_to_xyz(ref)
    first = next(mt.ad.RayDataLoader(ref.numpy(), BATCH, seed=4,
                                     device="cpu"))
    rows = (scene.bsdf_params * 0.6).detach().requires_grad_(True)

    def loss_of(rows_, batch, seed):
        img = mt.ad.render_batch(scene.replace(bsdf_params=rows_),
                                 batch[0], seed=seed, spp=SPP)
        return torch.mean((img - batch[1]) ** 2)

    with torch.no_grad():
        before = float(loss_of(rows, first, 1))
    opt = torch.optim.SGD([rows], lr=8.0)
    for _ in range(5):
        opt.zero_grad()
        loss_of(rows, first, 1).backward()
        assert torch.isfinite(rows.grad).all()
        opt.step()
    with torch.no_grad():
        after = float(loss_of(rows, first, 1))
    assert after < before, (before, after)
