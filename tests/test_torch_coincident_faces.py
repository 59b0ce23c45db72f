"""Where a box stands on the floor, its bottom face and the floor
coincide at y = -1: a ray inside the box hits the one or the other as an
ulp of the ray decides, so two renders whose rays differ by an ulp part
there, though neither is at fault. The card's camera rays are an ulp off
the CPU's on ~40 % of lanes, and the two packages' by up to two ulps on
the CPU. The witnesses: the dispersive (and the plain) glass box of
``chip_smoke.spectral_variant_cornell_dict`` on the floor at ``max_depth``
8 parts from itself when its camera rays move by an ulp, and agrees when
it stands ``GLASS_LIFT`` above the floor (as every scene of that function
does); a mask box on the floor parts from JAX only at such ties
(``test_torch_spectral._mask``; its render is held lifted)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
import mitsuba3_tpu as mj
import mitsuba3_tpu_torch as mt
from mitsuba3_tpu_torch.core.vec import Vec3
from mitsuba3_tpu_torch.render import integrator as t_int
from test_torch_spectral import SEED, SIDE, SPP, _mask

torch.set_num_threads(1)


def _an_ulp_off(gen_camera_rays):
    """`gen_camera_rays` with each component of 40 % of the rays'
    directions (drawn from a fixed seed) moved by one ulp."""
    def moved(scene, *args, **kw):
        rng, ray, jitter = gen_camera_rays(scene, *args, **kw)
        g = torch.Generator().manual_seed(1)

        def ulp(x):
            pick = torch.rand(x.shape, generator=g) < 0.4
            return torch.where(pick, torch.nextafter(
                x, torch.full_like(x, 2.0)), x)
        return rng, ray.replace(d=Vec3(ulp(ray.d.x), ulp(ray.d.y),
                                       ulp(ray.d.z))), jitter
    return moved


@pytest.mark.parametrize("dispersion", [True, False])
def test_glass_box_on_the_floor_parts_on_an_ulp(monkeypatch, dispersion):
    """16^2, 16 spp, max_depth 8 in the spectral variant: on the floor,
    the render from camera rays an ulp off parts from the plain one (<
    0.995 of values within 1e-3); lifted GLASS_LIFT, every value
    agrees."""
    close = {}
    for lift in (0.0, chip_smoke.GLASS_LIFT):
        d = chip_smoke.spectral_variant_cornell_dict(mt, SIDE, SIDE, 8,
                                                     "glass", lift)
        if not dispersion:
            d["small-box"]["bsdf"] = {"type": "dielectric",
                                      "int_ior": 1.5168}
        scene = mt.load_dict(d, device="cpu", spectral=True)
        plain = mt.render(scene, seed=SEED, spp=SPP).numpy()
        with monkeypatch.context() as m:
            m.setattr(t_int, "_gen_camera_rays",
                      _an_ulp_off(t_int._gen_camera_rays))
            moved = mt.render(scene, seed=SEED, spp=SPP).numpy()
        close[lift] = np.isclose(moved, plain, rtol=1e-3, atol=1e-3).mean()
    assert close[0.0] < 0.995, close
    assert close[chip_smoke.GLASS_LIFT] == 1.0, close


def test_mask_parts_from_jax_only_at_coincident_faces():
    """The witness for _mask's lift, in RGB: with the masked box on the
    floor, the two packages' camera rays differ by at most two ulps, and
    of the lanes that one bounce leaves alive in both, some go on to hit
    different triangles; every one of them is a tie between the floor and
    the box's bottom face, which coincide at y = -1: both hits on that
    plane and their t equal to 1e-5."""
    from mitsuba3_tpu.integrators import path as j_path
    from mitsuba3_tpu.render import integrator as j_int
    from mitsuba3_tpu.render.records import Ray as JRay
    from mitsuba3_tpu_torch.integrators import path as t_path
    from mitsuba3_tpu_torch.render.records import Ray as TRay

    sj = mj.load_dict(_mask(mj, 0.0))
    st = mt.load_dict(_mask(mt, 0.0), device="cpu")
    seed = t_int.pass_seed(SEED, 0)
    rng_j, ray_j, _, _ = j_int._gen_camera_rays(sj, seed, SPP,
                                                spp_total=SPP,
                                                base_seed=SEED)
    rng_t, ray_t, _ = t_int._gen_camera_rays(st, seed, SPP, 0, SPP, SEED)
    for a, b in ((ray_t.d.x, ray_j.d.x), (ray_t.d.y, ray_j.d.y),
                 (ray_t.d.z, ray_j.d.z)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0,
                                   atol=2.4e-7)
    state_j, _ = j_path.make_bounce(sj, sj.integrator)(
        j_path.init_state(sj, rng_j, ray_j, sj.integrator), jnp.int32(0))
    state_t, _ = t_path.make_bounce(st, st.integrator)(
        t_path.init_state(st, rng_t, ray_t, st.integrator))
    hit_j = sj.ray_intersect_preliminary(
        JRay.make(state_j.ray_o, state_j.ray_d), active=state_j.active)
    hit_t = st.ray_intersect_preliminary(
        TRay.make(state_t.ray_o, state_t.ray_d), active=state_t.active)
    parted = (np.asarray(state_j.active) & state_t.active.numpy()
              & (np.asarray(hit_j.prim_index) != hit_t.prim_index.numpy()))
    assert parted.sum() > 0
    t_j, t_t = np.asarray(hit_j.t)[parted], hit_t.t.numpy()[parted]
    np.testing.assert_allclose(t_t, t_j, rtol=1e-5)
    for o, d, t in ((state_j.ray_o.y, state_j.ray_d.y, t_j),
                    (state_t.ray_o.y.numpy(), state_t.ray_d.y.numpy(), t_t)):
        y = np.asarray(o)[parted] + t * np.asarray(d)[parted]
        np.testing.assert_allclose(y, -1.0, rtol=0, atol=1e-5)
