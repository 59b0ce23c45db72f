"""Port parity for the samplers, sensors, reconstruction filters and the
crop window: the five samplers' integer and float streams bit-equal to
JAX's; every sensor type's rays (and the batch sensor's) against JAX's on
4,096 film positions; the six filters' weights, halos and ordered
splats; a crop render equal to the same region of the full render; the
five sampler/sensor/filter combinations of ``chip_smoke.XML_COMBOS``
rendered per pixel like JAX at 16^2 from one XML file; and one ``prb``
gradient with ``multijitter``, ``mitchell`` and a crop against
``jax.grad``. JAX runs eagerly where that is faster than compiling."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mitsuba3_tpu as mj
from mitsuba3_tpu import sensors as sensors_j
from mitsuba3_tpu.core import warp as warp_j
from mitsuba3_tpu.core.vec import Vec2 as Vec2J
from mitsuba3_tpu.render import film as film_j
from mitsuba3_tpu.render import sampler as sampler_j
from mitsuba3_tpu.render.scene import FilmConfig as FilmConfigJ

import chip_smoke
import mitsuba3_tpu_torch as mt
from mitsuba3_tpu_torch import sensors
from mitsuba3_tpu_torch.core import warp as warp_t
from mitsuba3_tpu_torch.core.struct import take_lanes
from mitsuba3_tpu_torch.core.vec import Vec2
from mitsuba3_tpu_torch.render import film as film_t
from mitsuba3_tpu_torch.render import sampler as sampler_t
from test_torch_prb import _assert_grads_close

torch.set_num_threads(1)
N = 2000
RAYS = 4096


def _lanes(a):
    return torch.as_tensor(np.asarray(a).astype(np.int64))


def _draws(s, module):
    """12 dimensions: four next_2d and four next_1d, interleaved."""
    out = []
    for k in range(8):
        if k % 2:
            s, u = module.next_1d(s)
            out.append(u)
        else:
            s, v = module.next_2d(s)
            out += [v.x, v.y]
    return s, out


@pytest.mark.parametrize("spp", [1, 4, 8, 16, 64])
@pytest.mark.parametrize("stype", sampler_t.TYPES)
def test_sampler_streams_bit_equal_to_jax(np_rng, stype, spp):
    """Per-pixel hash, orthogonal resolution (64 spp: 11), every draw of
    12 dimensions and the PCG32 state equal JAX's bits, for two base
    seeds (8 spp takes the non-square fallback)."""
    for base_seed in (0, 0xDEADBEEF):
        pixel = np_rng.integers(0, 512 * 512, N).astype(np.int32)
        sample = np_rng.integers(0, spp, N).astype(np.uint32)
        js = sampler_j.seed(11, N, sample_idx=jnp.asarray(sample),
                            pixel_id=jnp.asarray(pixel), stype=stype,
                            spp=spp, base_seed=base_seed)
        ts = sampler_t.seed(11, _lanes(sample), _lanes(pixel), spp,
                            stype=stype, base_seed=base_seed)
        assert (ts.stype, ts.spp, ts.res) == (js.stype, js.spp, js.res)
        if stype == "orthogonal" and spp == 64:
            assert ts.res == 11
        if stype != "independent":
            assert (np.asarray(js.pixel_hash).astype(np.int64)
                    == ts.pixel_hash.numpy()).all()
        js, dj = _draws(js, sampler_j)
        ts, dt = _draws(ts, sampler_t)
        assert int(js.dim) == ts.dim == 12
        for a, b in zip(dj, dt):
            assert (np.asarray(a).view(np.int32)
                    == b.numpy().view(np.int32)).all(), (stype, spp)
        for name in ("state_hi", "state_lo", "inc_hi", "inc_lo"):
            assert (np.asarray(getattr(js.rng, name)).astype(np.int64)
                    == getattr(ts.rng, name).numpy()).all()


@pytest.mark.parametrize("l", [3, 11, 121, 4096, 65536, 65537, 100003,
                               1 << 20, 1 << 30, (1 << 31) - 1])
def test_kensler_permutation_bit_equal_to_jax(np_rng, l):
    """_permute_kensler, which runs its scramble mod the next power of
    two, for lengths up to 2^31 - 1 (JAX's side takes no more), on both
    sides of the power-of-two skip of the cycle walk: random indices
    below l and random 32-bit keys."""
    i = np_rng.integers(0, l, N).astype(np.uint32)
    p = np_rng.integers(0, 1 << 32, N, dtype=np.uint64).astype(np.uint32)
    want = np.asarray(sampler_j._permute_kensler(jnp.asarray(i), l,
                                                 jnp.asarray(p)))
    got = sampler_t._permute_kensler(_lanes(i), l, _lanes(p)).numpy()
    assert (want.astype(np.int64) == got).all()
    assert got.min() >= 0 and got.max() < l


def test_kensler_permutation_refuses_lengths_above_2_31():
    """Above 2^31 a product of two scrambled values would overflow
    int64, so such a length is refused rather than wrapped."""
    i = torch.zeros(4, dtype=torch.int64)
    with pytest.raises(ValueError, match="2\\^31"):
        sampler_t._permute_kensler(i, (1 << 31) + 1, i)


def test_sampler_lanes_survive_compaction(np_rng):
    """A structured sampler's per-lane leaves follow ``take_lanes`` (the
    integrators' lane compaction): drawing after taking lanes equals
    taking the lanes of the full draw; ``independent`` keeps no per-lane
    leaf besides its PCG32 state."""
    n = 512
    pixel, sample = _lanes(np.arange(n) // 16), _lanes(np.arange(n) % 16)
    keep = torch.as_tensor(np.sort(np_rng.choice(n, 200, replace=False)))
    for stype in sampler_t.TYPES:
        s = sampler_t.seed(3, sample, pixel, 16, stype=stype, base_seed=9)
        s, _ = sampler_t.next_1d(s)
        full, v_full = sampler_t.next_2d(s)
        part, v_part = sampler_t.next_2d(take_lanes(s, keep, n))
        assert torch.equal(v_full.x[keep], v_part.x)
        assert torch.equal(v_full.y[keep], v_part.y)
        assert part.dim == full.dim == 3
    s = sampler_t.seed(3, sample, pixel, 16)
    assert s.sample_idx is None and s.pixel_hash is None


def _sensor_spec(T, stype, fov_axis):
    to_world = T().look_at(origin=[0.5, -3.0, 1.5], target=[0, 0, 0.2],
                           up=[0, 0, 1])
    if stype in ("orthographic", "distant"):
        to_world = to_world @ T().scale([1.3, 0.7, 1.0])
    return {"type": stype, "fov": 41.0, "fov_axis": fov_axis,
            "to_world": to_world, "aperture_radius": 0.07,
            "focus_distance": 2.5}


def _ray_close(rj, rt, lanes=slice(None), atol=1e-7):
    for a, b in ((rj.o, rt.o), (rj.d, rt.d)):
        for c in "xyz":
            np.testing.assert_allclose(getattr(b, c).numpy()[lanes],
                                       np.asarray(getattr(a, c))[lanes],
                                       rtol=1e-6, atol=atol)


def _disk_agrees(pos):
    """Lanes whose concentric-disk point is bit-equal in both packages:
    XLA-CPU's sin and cos differ from torch's by an ulp on ~5 % of inputs
    (ROADMAP queue 3)."""
    pj = warp_j.square_to_uniform_disk_concentric_v(
        Vec2J(jnp.asarray(pos[0]), jnp.asarray(pos[1])))
    pt = warp_t.square_to_uniform_disk_concentric(
        Vec2(torch.as_tensor(pos[0]), torch.as_tensor(pos[1])))
    return ((np.asarray(pj.x) == pt.x.numpy())
            & (np.asarray(pj.y) == pt.y.numpy()))


@pytest.mark.parametrize("fov_axis", ["x", "y", "smaller", "larger",
                                      "diagonal"])
@pytest.mark.parametrize("stype", sensors.TYPES)
def test_sensor_rays_match_jax(np_rng, stype, fov_axis):
    """build_perspective and sample_ray of each sensor type on a 24 x 16
    film at 4,096 film positions and aperture samples: rtol 1e-6. The
    irradiancemeter's direction is the cosine hemisphere of the film
    position, z = sqrt(1 - x^2 - y^2): where its disk point differs by the
    ulp of sin or cos, that ulp grows by 1/z near the rim, so those lanes
    (about 9 %) are held at 4e-6."""
    pos, ap = np_rng.uniform(size=(2, 2, RAYS)).astype(np.float32)
    dj, cj = sensors_j.build_perspective(
        _sensor_spec(mj.ScalarTransform4f, stype, fov_axis), 24, 16)
    dt, ct = sensors.build_perspective(
        _sensor_spec(mt.ScalarTransform4f, stype, fov_axis), 24, 16, "cpu")
    assert ct.type == cj.type and ct.fov_axis == cj.fov_axis
    rj = sensors_j.sample_ray(dj, Vec2J(jnp.asarray(pos[0]),
                                        jnp.asarray(pos[1])), stype=stype,
                              aperture_sample=Vec2J(jnp.asarray(ap[0]),
                                                    jnp.asarray(ap[1])))
    rt = sensors.sample_ray(dt, Vec2(torch.as_tensor(pos[0]),
                                     torch.as_tensor(pos[1])), stype=stype,
                            aperture_sample=Vec2(torch.as_tensor(ap[0]),
                                                 torch.as_tensor(ap[1])))
    if stype == "irradiancemeter":
        same = _disk_agrees(pos)
        assert same.mean() > 0.85
        _ray_close(rj, rt, lanes=same)
        _ray_close(rj, rt, atol=4e-6)
    else:
        _ray_close(rj, rt)


def test_batch_sensor_rays_match_jax(np_rng):
    """build_batch and sample_ray_batch: three sub-sensors (perspective,
    thinlens, orthographic) splitting a 36 x 16 film's columns."""
    pos, ap = np_rng.uniform(size=(2, 2, RAYS)).astype(np.float32)

    def spec(T):
        return {"type": "batch", "film": {"width": 36, "height": 16},
                **{f"s{k}": _sensor_spec(T, t, "x") for k, t in enumerate(
                    ("perspective", "thinlens", "orthographic"))}}
    dj, cj = sensors_j.build_batch(spec(mj.ScalarTransform4f), 36, 16)
    dt, ct = sensors.build_batch(spec(mt.ScalarTransform4f), 36, 16, "cpu")
    assert ct.sub_types == cj.sub_types == ("perspective", "thinlens",
                                            "orthographic")
    rj = sensors_j.sample_ray_batch(
        dj, Vec2J(jnp.asarray(pos[0]), jnp.asarray(pos[1])), cj.sub_types,
        Vec2J(jnp.asarray(ap[0]), jnp.asarray(ap[1])))
    rt = sensors.sample_ray_batch(
        dt, Vec2(torch.as_tensor(pos[0]), torch.as_tensor(pos[1])),
        ct.sub_types, Vec2(torch.as_tensor(ap[0]), torch.as_tensor(ap[1])))
    _ray_close(rj, rt)


@pytest.mark.parametrize("name", film_t.RFILTERS)
def test_rfilter_matches_jax(np_rng, name):
    """rfilter_eval on offsets across the support, rfilter_radius,
    halo_rows, and splat_ordered of random samples (5 x 6 pixels, 3 per
    pixel)."""
    x = np.linspace(-3.5, 3.5, 1001, dtype=np.float32)
    r = film_t.rfilter_radius(name)
    assert r == film_j.rfilter_radius(name)
    np.testing.assert_allclose(
        film_t.rfilter_eval(name, torch.as_tensor(x), r).numpy(),
        np.asarray(film_j.rfilter_eval(name, jnp.asarray(x), r)),
        rtol=1e-6, atol=1e-7)
    fj, ft = FilmConfigJ(rfilter=name), film_t.FilmConfig(rfilter=name)
    assert film_t.halo_rows(ft) == film_j.halo_rows(fj)
    h, w, sppc = 5, 6, 3
    jit = np_rng.uniform(size=(2, h * w * sppc)).astype(np.float32)
    vals = np_rng.uniform(size=(h * w * sppc, 3)).astype(np.float32)
    ij, wj = film_j.splat_ordered(fj, Vec2J(jnp.asarray(jit[0]),
                                            jnp.asarray(jit[1])),
                                  jnp.asarray(vals), sppc, h, w)
    it, wt = film_t.splat_ordered(ft, Vec2(torch.as_tensor(jit[0]),
                                           torch.as_tensor(jit[1])),
                                  torch.as_tensor(vals), sppc, h, w)
    np.testing.assert_allclose(it.numpy(), np.asarray(ij), rtol=1e-5,
                               atol=1e-6)
    np.testing.assert_allclose(wt.numpy(), np.asarray(wj), rtol=1e-5,
                               atol=1e-6)


def test_crop_render_equals_full_region():
    """A crop is seeded by the full film's pixel ids and maps the full
    film plane, so with the box filter (no halo) a crop render equals the
    same region of the full render, value for value (tests/test_render.py
    holds JAX's crop to the region statistically); a crop outside the
    film is refused."""
    d = mt.cornell_box(24, 24, max_depth=3)
    d["sensor"]["film"]["rfilter"] = {"type": "box"}
    d["sensor"]["sampler"]["type"] = "stratified"
    full = mt.render(mt.load_dict(d, device="cpu"), spp=16, seed=3)
    d["sensor"]["film"].update(crop_width=12, crop_height=8,
                               crop_offset_x=5, crop_offset_y=9)
    crop = mt.render(mt.load_dict(d, device="cpu"), spp=16, seed=3)
    assert tuple(crop.shape) == (8, 12, 3)
    assert torch.equal(crop, full[9:17, 5:17])
    d["sensor"]["film"]["crop_width"] = 20
    with pytest.raises(ValueError, match="crop window"):
        mt.load_dict(d, device="cpu")


# JAX's render compiles slower than it runs eagerly for these samplers
EAGER = ("stratified", "multijitter", "orthogonal")


@pytest.mark.parametrize("combo", chip_smoke.XML_COMBOS,
                         ids=[c[0] for c in chip_smoke.XML_COMBOS])
def test_xml_renders_match_jax(tmp_path, combo):
    """chip_smoke's five card-vs-CPU scenes at 16^2, 16 spp (max_depth 3:
    JAX's eager renders cost per bounce), read from one XML file by both
    packages: per pixel (> 99.5 % of values isclose 1e-3), means rtol
    1e-3, equal ray counts."""
    sampler, sensor, rfilter, crop = combo
    path = chip_smoke.cornell_xml(
        mt, str(tmp_path), 16, 16, max_depth=3, spp=16, sampler=sampler,
        sensor=sensor, rfilter=rfilter,
        crop=crop and tuple(c // 2 for c in crop))
    st = mt.load_file(path, device="cpu")
    assert (st.sampler_type, st.sensor_config.type, st.film.rfilter) == (
        sampler, sensor, rfilter)
    img_t, rays_t = mt.render_with_stats(st, seed=5)
    with jax.disable_jit(sampler in EAGER):
        img_j, rays_j = mj.render_with_stats(mj.load_file(path), seed=5)
    img_j = np.asarray(img_j)
    img_t = img_t.numpy()
    assert img_t.shape == img_j.shape and np.isfinite(img_t).all()
    assert img_t.max() > 0
    assert np.isclose(img_t, img_j, rtol=1e-3, atol=1e-3).mean() > 0.995
    assert np.allclose(img_t.mean(), img_j.mean(), rtol=1e-3)
    assert rays_t == int(rays_j)


def test_prb_grads_multijitter_mitchell_crop_match_jax(tmp_path):
    """One prb gradient of mean(render) at 4 spp: an 8 x 8 crop of a
    12 x 12 film, multijitter, mitchell; bsdf_params and em_radiance
    within 1e-4 of jax.grad's largest entry, every entry finite."""
    names = ("bsdf_params", "em_radiance")
    path = chip_smoke.cornell_xml(
        mt, str(tmp_path), 12, 12, max_depth=3, spp=4, sampler="multijitter",
        rfilter="mitchell", crop=(8, 8, 2, 3), integrator="prb")
    st = mt.load_file(path, device="cpu")
    theta = {k: getattr(st, k).detach().clone().requires_grad_(True)
             for k in names}
    img = mt.render(st.replace(**theta), spp=4, seed=2)
    assert tuple(img.shape) == (8, 8, 3)
    img.mean().backward()
    sj = mj.load_file(path)

    def loss(th):
        return mj.render(sj.replace(**th), spp=4, seed=2).mean()
    gj = jax.grad(loss)({k: getattr(sj, k) for k in names})
    gt = {k: v.grad for k, v in theta.items()}
    for k in names:
        assert np.isfinite(np.asarray(gj[k])).all()
        assert float(gt[k].abs().max()) > 0
    _assert_grads_close(gj, gt, names, 1e-4)
