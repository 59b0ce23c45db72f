"""Port parity for participating media and phase functions, module by
module: the loader's medium rows, grids, phase tables, world->grid
affines and face media against the JAX loader's (bit-equal), the free
flight (``sample_real_interaction``), ``transmittance`` and
``intersect_aabb`` of homogeneous and heterogeneous media with and without
spectral MIS, each phase function's ``sample``/``eval_pdf`` on 4,096
lanes, the cell-table density lookup against the eight-gather oracle,
the sampler's block draws, ``convert.py`` both ways and
``traverse``/``update()`` of the medium rows and a density grid, and the
``prbvolpath`` gradients of a render against ``jax.grad`` of JAX's.
Inputs come from numpy seeds; every tolerance is stated at its assert."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mitsuba3_tpu as mj
from mitsuba3_tpu import media as media_j
from mitsuba3_tpu import phase as phase_j
from mitsuba3_tpu.core import distr as distr_j
from mitsuba3_tpu.core.vec import Vec2 as Vec2J
from mitsuba3_tpu.core.vec import Vec3 as Vec3J
from mitsuba3_tpu.render import sampler as sampler_j
from mitsuba3_tpu.render.records import Ray as RayJ
from mitsuba3_tpu.utils.params import traverse as traverse_j

import chip_smoke
import mitsuba3_tpu_torch as mt
from mitsuba3_tpu_torch import media as media_t
from mitsuba3_tpu_torch import phase as phase_t
from mitsuba3_tpu_torch.convert import arrays_from_scene, scene_from_arrays
from mitsuba3_tpu_torch.core import distr as distr_t
from mitsuba3_tpu_torch.core.vec import Vec2, Vec3
from mitsuba3_tpu_torch.render import sampler as sampler_t
from mitsuba3_tpu_torch.render.records import Ray

torch.set_num_threads(1)

MEDIUM_ARRAYS = ("medium_params", "medium_to_grid", "face_medium")
MEDIUM_META = ("medium_types", "phase_types", "sensor_medium")

PHASES = {
    "isotropic": {"type": "isotropic"},
    "hg": {"type": "hg", "g": 0.6},
    "rayleigh": {"type": "rayleigh"},
    "sggx": {"type": "sggx", "S": [0.2, 1.0, 0.5, 0.1, 0.05, -0.1]},
    "tabphase": {"type": "tabphase", "values": "0.5, 1.0, 2.0, 4.0, 3.0"},
    "blendphase": {"type": "blendphase", "weight": 0.3,
                   "phase_0": {"type": "hg", "g": -0.4},
                   "phase_1": {"type": "rayleigh"}},
}


def _grid(side=8, seed=3):
    rng = np.random.default_rng(seed)
    return rng.uniform(0.0, 1.0, (side, side + 1, side + 2)).astype(
        np.float32)


def slab_dict(mi, interior, width=8, integrator="volpath", spp=4,
              max_depth=8, sensor_medium=None):
    """tests/test_medium.py's fog slab: a null cube holding `interior`
    seen from z = -4 under a constant environment, plus a point light."""
    d = {"type": "scene",
         "integrator": {"type": integrator, "max_depth": max_depth},
         "sensor": {"type": "perspective", "fov": 30.0,
                    "to_world": mi.ScalarTransform4f().look_at(
                        origin=[0, 0, -4], target=[0, 0, 0], up=[0, 1, 0]),
                    "film": {"width": width, "height": width},
                    "sampler": {"type": "independent", "sample_count": spp}},
         "fog": {"type": "cube", "bsdf": {"type": "null"},
                 "interior": interior},
         "lamp": {"type": "point", "position": [1.5, 2.0, -1.0],
                  "intensity": {"type": "rgb", "value": [4, 3, 2]}},
         "env": {"type": "constant",
                 "radiance": {"type": "rgb", "value": 0.5}}}
    if sensor_medium is not None:
        d["sensor"]["medium"] = sensor_medium
    return d


def het_medium(mi, grid, phase=None, sigma=(3.0, 2.0, 1.0)):
    return {"type": "heterogeneous",
            "sigma_t": {"type": "rgb", "value": list(sigma)},
            "albedo": {"type": "rgb", "value": [0.8, 0.7, 0.9]},
            "density": {"type": "gridvolume", "data": grid,
                        "to_world": mi.ScalarTransform4f()
                        .translate([-1, -1, -1]).scale(2.0)},
            "phase": phase or {"type": "hg", "g": 0.3}}


def hom_medium(phase=None, sigma=(0.8, 0.5, 1.2)):
    return {"type": "homogeneous",
            "sigma_t": {"type": "rgb", "value": list(sigma)},
            "albedo": {"type": "rgb", "value": [0.7, 0.8, 0.6]},
            "phase": phase or {"type": "isotropic"}}


def _pair(make):
    """(JAX scene, port scene on the CPU) of `make(package)`."""
    return mj.load_dict(make(mj)), mt.load_dict(make(mt), device="cpu")


def _hold_scene_media(sj, st):
    for name in MEDIUM_ARRAYS:
        np.testing.assert_array_equal(np.asarray(getattr(sj, name)),
                                      getattr(st, name).numpy(), name)
    for name in MEDIUM_META:
        assert getattr(sj, name) == getattr(st, name), name
    for name in ("medium_grids", "phase_tables"):
        a, b = getattr(sj, name), getattr(st, name)
        assert len(a) == len(b), name
        for x, y in zip(a, b):
            np.testing.assert_array_equal(np.asarray(x), y.numpy(), name)


def _many_media(mi, vol_path):
    """Every way of giving a medium: named at the top level and referenced,
    a sensor medium, interior and exterior on a mesh, a rectangle, a cube
    and an OBJ file, a .vol grid, a raw array, every phase type."""
    T = mi.ScalarTransform4f
    g = _grid()
    phases = list(PHASES.values())
    d = slab_dict(mi, {"type": "ref", "id": "named"},
                  sensor_medium=hom_medium(phases[2]))
    d["named"] = het_medium(mi, g, phases[1])
    d["raw"] = {"type": "heterogeneous", "density": g[::-1].copy(),
                "albedo": 0.5, "scale": 2.0, "phase": phases[3],
                "sample_emitters": False}
    d["plane"] = {"type": "rectangle", "to_world": T().translate([0, 0, 2]),
                  "bsdf": {"type": "null"},
                  "exterior": {"type": "ref", "id": "raw"},
                  "interior": hom_medium(phases[4])}
    d["tri"] = {"type": "mesh",
                "vertices": np.array([[0, 0, 3], [1, 0, 3], [0, 1, 3]],
                                     np.float32),
                "faces": np.array([[0, 1, 2]]), "bsdf": {"type": "null"},
                "interior_medium": hom_medium(phases[5])}
    d["volfile"] = {"type": "cube", "to_world": T().translate([3, 0, 0]),
                    "interior": {"type": "heterogeneous",
                                 "density": {"type": "gridvolume",
                                             "filename": vol_path},
                                 "sigma_t": {"type": "rgb",
                                             "value": [1, 2, 3]}}}
    d["opaque"] = {"type": "cube", "to_world": T().translate([-3, 0, 0])
                   .scale(0.5)}
    return d


def _write_vol(path, grid):
    with open(path, "wb") as f:
        f.write(b"VOL" + bytes([3]))
        d, h, w = grid.shape
        f.write(np.array([1, w, h, d, 1], np.int32).tobytes())
        f.write(np.array([-1, -2, -3, 2, 1, 0.5], np.float32).tobytes())
        f.write(grid.astype(np.float32).tobytes())


def test_medium_rows_match_jax(tmp_path):
    """Every lowering of a medium and a phase: rows, grids, tables,
    affines, face media and the static fields bit-equal to JAX's."""
    vol = str(tmp_path / "density.vol")
    _write_vol(vol, _grid(5, seed=9))
    sj, st = _pair(lambda mi: _many_media(mi, vol))
    assert len(st.medium_types) == 6 and st.sensor_medium >= 0
    assert set(st.phase_types) == set(range(6))
    _hold_scene_media(sj, st)
    assert st.face_table.shape[1] == 30


def test_media_of_examples_and_regression_match_jax():
    """tests/test_regression.py's fog cube and examples/03_volumetric.py's
    smoke (chip_smoke.smoke_dict at the example's 96^2 and 24^3) load with
    JAX's arrays."""
    for make in (lambda mi: chip_smoke.fog_cornell_dict(mi, 32, 32, 6),
                 lambda mi: chip_smoke.smoke_dict(mi, 96, 24, spp=32)):
        _hold_scene_media(*_pair(make))


def test_media_refusals():
    """A blend inside a blend is refused as JAX refuses it; the port names
    what it does not carry."""
    nested = {"type": "blendphase", "phase_0": {"type": "isotropic"},
              "phase_1": {"type": "blendphase",
                          "phase_0": {"type": "isotropic"},
                          "phase_1": {"type": "isotropic"}}}
    for mi, kw in ((mj, {}), (mt, {"device": "cpu"})):
        with pytest.raises(ValueError, match="nested blendphase"):
            mi.load_dict(slab_dict(mi, hom_medium(nested)), **kw)
    with pytest.raises(NotImplementedError, match="medium type"):
        mt.load_dict(slab_dict(mt, {"type": "vdbmedium"}), device="cpu")
    with pytest.raises(NotImplementedError, match="albedo_texture"):
        mt.load_dict(slab_dict(mt, dict(hom_medium(), albedo_texture=1)),
                     device="cpu")


# ---------------------------------------------------------------------------
# Free flight, transmittance, bounds
# ---------------------------------------------------------------------------

def _vj(a):
    return Vec3J(jnp.asarray(a[:, 0]), jnp.asarray(a[:, 1]),
                 jnp.asarray(a[:, 2]))


def _vt(a):
    t = torch.as_tensor(a)
    return Vec3(t[:, 0], t[:, 1], t[:, 2])


def _samplers(n, seed=11):
    pix = np.arange(n, dtype=np.int64)
    rj = sampler_j.seed(seed, n, sample_idx=jnp.zeros(n, jnp.uint32),
                        pixel_id=jnp.asarray(pix, jnp.uint32), spp=1)
    rt = sampler_t.seed(seed, torch.zeros(n, dtype=torch.int64),
                        torch.as_tensor(pix), 1)
    return rj, rt


def _rng_equal(rj, rt):
    assert int(rj.dim) == rt.dim
    for half in ("state_hi", "state_lo"):
        np.testing.assert_array_equal(
            np.asarray(getattr(rj.rng, half)).astype(np.int64),
            getattr(rt.rng, half).numpy())


def _rays(n, seed):
    """Rays from inside and around the unit cube in random directions,
    medium slots 0 and 1 and vacuum (-1)."""
    rng = np.random.default_rng(seed)
    o = rng.uniform(-1.5, 1.5, (n, 3)).astype(np.float32)
    d = rng.normal(size=(n, 3))
    d = (d / np.linalg.norm(d, axis=1, keepdims=True)).astype(np.float32)
    t_surf = rng.uniform(0.1, 4.0, n).astype(np.float32)
    t_surf[::7] = np.inf
    med = rng.integers(-1, 2, n).astype(np.int32)
    channel = rng.integers(0, 3, n).astype(np.int32)
    active = rng.uniform(size=n) < 0.9
    return o, d, t_surf, med, channel, active


def _two_media(mi):
    """A homogeneous and a heterogeneous medium (slots 0, 1)."""
    d = slab_dict(mi, hom_medium({"type": "hg", "g": 0.5}))
    d["smoke"] = {"type": "cube", "to_world": mi.ScalarTransform4f()
                  .translate([0, 0, 3]), "bsdf": {"type": "null"},
                  "interior": het_medium(mi, _grid())}
    return d


@pytest.fixture(scope="module")
def two_media():
    return _pair(_two_media)


def _close(a, b, what, rtol=1e-5, atol=1e-6, share=1.0):
    a, b = np.asarray(a), np.asarray(b)
    ok = np.isclose(a, b, rtol=rtol, atol=atol) | (
        np.isinf(a) & np.isinf(b) & (np.sign(a) == np.sign(b)))
    assert ok.mean() >= share, (what, ok.mean(), np.abs(a - b).max())


@pytest.mark.parametrize("mis", [False, True])
def test_sample_real_interaction_matches_jax(two_media, mis):
    """4,096 rays in a homogeneous and a heterogeneous medium (and vacuum
    lanes): the real-collision distance, point and weight agree at rtol
    1e-5 (atol 1e-6) on every lane, and the sampler streams end bit-equal
    (48 steps of two draws each, done lanes included)."""
    sj, st = two_media
    n = 4096
    o, d, t_surf, med, ch, act = _rays(n, 5)
    rj, rt = _samplers(n)
    mj_, wj, rj = media_j.sample_real_interaction(
        sj, jnp.asarray(med), RayJ.make(_vj(o), _vj(d)), jnp.asarray(t_surf),
        rj, jnp.asarray(ch), jnp.asarray(act), spectral_mis=mis)
    mt_, wt, rt = media_t.sample_real_interaction(
        st, torch.as_tensor(med), Ray.make(_vt(o), _vt(d)),
        torch.as_tensor(t_surf), rt, torch.as_tensor(ch),
        torch.as_tensor(act), spectral_mis=mis)
    _rng_equal(rj, rt)
    real = np.isfinite(np.asarray(mj_.t))
    assert 0.1 < real.mean() < 0.9
    np.testing.assert_array_equal(real, torch.isfinite(mt_.t).numpy())
    _close(mj_.t, mt_.t, "t")
    for c in "xyz":
        _close(getattr(mj_.p, c), getattr(mt_.p, c), f"p.{c}")
        _close(getattr(wj, c), getattr(wt, c), f"w.{c}")


@pytest.mark.parametrize("mis", [False, True])
def test_transmittance_and_bounds_match_jax(two_media, mis):
    """Analytic (homogeneous) and ratio-tracked (heterogeneous)
    transmittance at rtol 1e-5 (atol 1e-6), streams bit-equal; the
    medium bounds (intersect_aabb) at rtol 1e-6."""
    sj, st = two_media
    n = 4096
    o, d, t_end, med, ch, act = _rays(n, 6)
    t_end = np.where(np.isfinite(t_end), t_end, 50.0).astype(np.float32)
    rj, rt = _samplers(n, seed=12)
    trj, rj = media_j.transmittance(
        sj, jnp.asarray(med), _vj(o), _vj(d), jnp.asarray(t_end), rj,
        jnp.asarray(ch), jnp.asarray(act), spectral_mis=mis)
    trt, rt = media_t.transmittance(
        st, torch.as_tensor(med), _vt(o), _vt(d), torch.as_tensor(t_end), rt,
        torch.as_tensor(ch), torch.as_tensor(act), spectral_mis=mis)
    _rng_equal(rj, rt)
    assert 0.05 < float(np.mean(np.asarray(trj.x) < 0.99)) < 0.95
    for c in "xyz":
        _close(getattr(trj, c), getattr(trt, c), f"tr.{c}")
    lo_j, hi_j = media_j.intersect_aabb(sj, jnp.asarray(med), _vj(o), _vj(d))
    lo_t, hi_t = media_t.intersect_aabb(st, torch.as_tensor(med), _vt(o),
                                        _vt(d))
    _close(lo_j, lo_t, "mint", rtol=1e-6)
    _close(hi_j, hi_t, "maxt", rtol=1e-6)


def test_cell_lookup_matches_oracle(np_rng):
    """The one-row cell lookup against the eight-gather oracle and JAX's
    two lookups, points inside, outside and exactly on the grid's faces:
    z-first order bit-equal to JAX's _sample_grid_cells, x-first order
    bit-equal to _sample_grid (JAX's lookup above 4M cells), both within
    1e-6 of the oracle."""
    g = _grid(6, seed=4)
    n = 4096
    p = np_rng.uniform(-0.1, 1.1, (n, 3)).astype(np.float32)
    p[:64] = np.round(p[:64])
    p[64:128, 0] = 1.0
    pj, pt = _vj(p), _vt(p)
    gt = torch.as_tensor(g)
    cells = media_t.build_cells(gt)
    np.testing.assert_array_equal(np.asarray(media_j._cell_rows(
        jnp.asarray(g))), cells.numpy())
    zyx = media_t.sample_grid_cells(cells, g.shape, pt, zyx=True).numpy()
    xyz = media_t.sample_grid_cells(cells, g.shape, pt, zyx=False).numpy()
    oracle = media_t.sample_grid(gt, pt).numpy()
    np.testing.assert_array_equal(zyx, np.asarray(media_j._sample_grid_cells(
        jnp.asarray(media_j._cell_rows(jnp.asarray(g))), g.shape, pj)))
    np.testing.assert_array_equal(xyz, np.asarray(media_j._sample_grid(
        jnp.asarray(g), pj)))
    np.testing.assert_array_equal(xyz, oracle)
    np.testing.assert_allclose(zyx, oracle, rtol=1e-6, atol=1e-6)
    assert media_t.cell_table(gt) is media_t.cell_table(gt)


# ---------------------------------------------------------------------------
# Phase functions
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def phase_media():
    """One homogeneous medium per phase type (slots in PHASES order)."""
    def make(mi):
        d = slab_dict(mi, hom_medium(PHASES["isotropic"]))
        for k, ph in enumerate(list(PHASES.values())[1:]):
            d[f"box{k}"] = {"type": "cube", "bsdf": {"type": "null"},
                            "to_world": mi.ScalarTransform4f().translate(
                                [0, 0, 3 + 3 * k]),
                            "interior": hom_medium(ph)}
        return d
    return _pair(make)


def _phase_inputs(n, slots, seed):
    rng = np.random.default_rng(seed)
    wi = rng.normal(size=(n, 3))
    wi = (wi / np.linalg.norm(wi, axis=1, keepdims=True)).astype(np.float32)
    wo = rng.normal(size=(n, 3))
    wo = (wo / np.linalg.norm(wo, axis=1, keepdims=True)).astype(np.float32)
    s1 = rng.uniform(size=n).astype(np.float32)
    s2 = rng.uniform(size=(n, 2)).astype(np.float32)
    med = rng.choice(slots, n).astype(np.int32)
    return wi, wo, s1, s2, med


# rayleigh samples through cube roots: torch's pow(x, 1/3) and XLA's cbrt
# differ by an ulp, which the sampled cosine carries
PHASE_RTOL = {"rayleigh": 2e-5}


@pytest.mark.parametrize("name", list(PHASES) + ["mixed"])
def test_phase_sample_eval_match_jax(phase_media, name):
    """sample and eval_pdf of each phase type (and all six mixed, lane by
    lane: the pruned dispatch) on 4,096 random frames: directions, weights
    and pdfs at rtol 1e-5 (rayleigh 2e-5), atol 1e-6; values and pdfs at
    random directions the same; sampled pdf = eval_pdf there."""
    sj, st = phase_media
    slots = (list(range(6)) if name == "mixed"
             else [list(PHASES).index(name)])
    n = 4096
    wi, wo, s1, s2, med = _phase_inputs(n, slots, 8)
    rtol = max(PHASE_RTOL.get(name, 1e-5), 2e-5 if name == "mixed" else 0)
    a = (jnp.asarray(med), _vj(wi))
    b = (torch.as_tensor(med), _vt(wi))
    s2j = Vec2J(jnp.asarray(s2[:, 0]), jnp.asarray(s2[:, 1]))
    s2t = Vec2(torch.as_tensor(s2[:, 0]), torch.as_tensor(s2[:, 1]))
    woj, wj, pj = phase_j.sample(sj, *a, jnp.asarray(s1), s2j)
    wot, wt, pt = phase_t.sample(st, *b, torch.as_tensor(s1), s2t)
    for c in "xyz":
        _close(getattr(woj, c), getattr(wot, c), f"wo.{c}", rtol=rtol,
               atol=2e-6)
    _close(wj, wt, "weight", rtol=rtol)
    _close(pj, pt, "pdf", rtol=rtol)
    vj, qj = phase_j.eval_pdf(sj, *a, _vj(wo))
    vt, qt = phase_t.eval_pdf(st, *b, _vt(wo))
    _close(vj, vt, "value", rtol=1e-5)
    _close(qj, qt, "eval pdf", rtol=1e-5)
    v2, q2 = phase_t.eval_pdf(st, *b, wot)
    _close(q2, pt, "sampled pdf", rtol=1e-3, atol=1e-4)


def test_continuous_distribution_matches_jax(np_rng):
    """The tabulated phase's piecewise-linear distribution: sample and
    eval_pdf_normalized at rtol 1e-5 (atol 1e-6): XLA contracts the
    segment inversion differently, a few values differ by 2 ulps."""
    pdf = np_rng.uniform(0.1, 3.0, 9).astype(np.float32)
    xi = np_rng.uniform(size=2000).astype(np.float32)
    x = np_rng.uniform(-1.2, 1.2, 2000).astype(np.float32)
    dj = distr_j.ContinuousDistribution.from_pdf(jnp.asarray(pdf), -1.0, 1.0)
    dt = distr_t.ContinuousDistribution.from_pdf(torch.as_tensor(pdf),
                                                 -1.0, 1.0)
    for fj, ft, arg in ((dj.sample, dt.sample, xi),
                        (dj.eval_pdf_normalized, dt.eval_pdf_normalized, x)):
        np.testing.assert_allclose(ft(torch.as_tensor(arg)).numpy(),
                                   np.asarray(fj(jnp.asarray(arg))),
                                   rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("stype", sampler_t.TYPES)
def test_block_draws_bit_equal(stype):
    """next_1d_block(k) and advance(k) against k next_1d calls, for every
    sampler type: values, PCG32 state and dimension bit-equal."""
    n = 777
    s = sampler_t.seed(5, torch.arange(n) % 16, torch.arange(n) // 3, 16,
                       stype=stype, base_seed=2)
    seq, draws = s, []
    for _ in range(50):
        seq, u = sampler_t.next_1d(seq)
        draws.append(u)
    blk, us = sampler_t.next_1d_block(s, 50)
    adv = sampler_t.advance(s, 50)
    assert torch.equal(us, torch.stack(draws))
    for other in (blk, adv):
        assert other.dim == seq.dim
        assert torch.equal(other.rng.state_hi, seq.rng.state_hi)
        assert torch.equal(other.rng.state_lo, seq.rng.state_lo)


# ---------------------------------------------------------------------------
# convert.py and traverse / update
# ---------------------------------------------------------------------------

def test_convert_both_ways():
    """A JAX volumetric scene's arrays build the port's scene with the
    port loader's arrays, and back; the configs of volpath, volpathmis and
    prbvolpath (max_null_events, shadow_segments) cross both ways."""
    for itype in ("volpath", "volpathmis", "prbvolpath"):
        def make(mi):
            d = _two_media(mi)
            d["integrator"] = {"type": itype, "max_depth": 5,
                               "max_null_events": 3, "shadow_segments": 2}
            return d
        sj, st = _pair(make)
        aj, meta_j = arrays_from_scene(sj)
        at, meta_t = arrays_from_scene(st)
        assert sorted(aj) == sorted(at)
        for k in aj:
            if not k.startswith("accel."):
                np.testing.assert_array_equal(aj[k], at[k], k)
        for k in MEDIUM_META:
            assert meta_j[k] == meta_t[k]
        back = scene_from_arrays(aj, meta_j, device="cpu")
        assert back.integrator == st.integrator
        assert (back.integrator.max_null_events,
                back.integrator.shadow_segments) == (3, 2)
        assert type(back.integrator).__name__ == type(
            sj.integrator).__name__
        _hold_scene_media(sj, back)
        a2, _ = arrays_from_scene(back)
        for k in aj:
            np.testing.assert_array_equal(aj[k], a2[k], k)


def test_traverse_update_media_matches_jax(two_media):
    """traverse exposes medium_params and medium0.density.data; update()
    of a grid re-derives the majorant of the row that owns it as JAX's
    does (bit-equal), and the new grid's lookups use a new cell table."""
    sj, st = two_media
    pj, pt = traverse_j(sj), mt.traverse(st)
    assert {"medium_params", "medium0.density.data"} <= set(pt.keys())
    assert set(pj.keys()) == set(pt.keys())
    g_new = (_grid() * 2.5).astype(np.float32)
    rows = np.asarray(sj.medium_params).copy()
    rows[0, 0:3] = [1.5, 0.25, 2.0]
    # one key an update: JAX applies a call's keys in its set's order
    for p in (pj, pt):
        p["medium_params"] = rows
        p.update()
        p["medium0.density.data"] = g_new
    sj2, st2 = pj.update(), pt.update()
    _hold_scene_media(sj2, st2)
    assert float(st2.medium_params[1, 8]) == pytest.approx(
        2.5 * float(_grid().max()) * 3.0, rel=1e-5)
    assert float(st2.medium_params[0, 0]) == 1.5
    # both keys in one update: the port applies the rows first
    pt = mt.traverse(st)
    pt["medium0.density.data"] = g_new
    pt["medium_params"] = rows
    np.testing.assert_array_equal(pt.update().medium_params.numpy(),
                                  st2.medium_params.numpy())
    p = _vt(np.random.default_rng(1).uniform(0, 1, (256, 3)).astype(
        np.float32))
    np.testing.assert_array_equal(
        media_t.lookup_grid(st2.medium_grids[0], p).numpy(),
        media_t.sample_grid_cells(media_t.build_cells(st2.medium_grids[0]),
                                  g_new.shape, p).numpy())
    assert torch.equal(st.medium_grids[0], torch.as_tensor(_grid()))


# ---------------------------------------------------------------------------
# prbvolpath
# ---------------------------------------------------------------------------

def fog_smoke_cornell(mi, side=8, depth=4):
    """The Cornell box with a heterogeneous cube (a 6^3 grid, HG g 0.3)
    where the fog cube stands: one scene with every kind of θ entry."""
    d = chip_smoke.fog_cornell_dict(mi, side, side, depth, "prbvolpath")
    grid = np.random.default_rng(2).uniform(0.0, 1.0, (6, 6, 6)).astype(
        np.float32)
    d["fog"]["interior"] = het_medium(mi, grid, sigma=(1.2, 0.8, 1.5))
    d["fog"]["interior"]["density"]["to_world"] = (
        mi.ScalarTransform4f().translate([-1, 0.1, -1]).scale(1.8))
    return d


GRAD_NAMES = ("medium_params", "medium_grids", "bsdf_params", "em_radiance")


def test_prbvolpath_grads_match_jax():
    """PRB through a heterogeneous medium in the Cornell box (8^2, 4 spp,
    max_depth 4, seed 3): gradients of sum(image^2) with respect to the
    medium rows, the density grid, the BSDF rows and the emitter radiance
    within 1e-4 of the largest entry of jax.grad's through JAX's
    prbvolpath (its compile with most optimizations off), every entry
    finite on both sides, the medium rows' sigma_t and albedo entries
    nonzero; the primal image equals volpath's per pixel."""
    sj = mj.load_dict(fog_smoke_cornell(mj))
    st = mt.load_dict(fog_smoke_cornell(mt), device="cpu")

    def loss_j(th):
        img = mj.render(sj.replace(**th), seed=3, spp=4)
        return jnp.sum(img * img)

    theta_j = {k: getattr(sj, k) for k in GRAD_NAMES}
    jax.config.update("jax_disable_most_optimizations", True)
    try:
        gj = jax.jit(jax.grad(loss_j))(theta_j)
    finally:
        jax.config.update("jax_disable_most_optimizations", False)
    theta_t = {k: tuple(g.clone().requires_grad_(True) for g in v)
               if isinstance(v, tuple) else v.clone().requires_grad_(True)
               for k, v in ((k, getattr(st, k)) for k in GRAD_NAMES)}
    img = mt.render(st.replace(**theta_t), seed=3, spp=4)
    (img * img).sum().backward()
    pairs = [("medium_params", gj["medium_params"],
              theta_t["medium_params"].grad),
             ("medium_grids", gj["medium_grids"][0],
              theta_t["medium_grids"][0].grad),
             ("bsdf_params", gj["bsdf_params"], theta_t["bsdf_params"].grad),
             ("em_radiance", gj["em_radiance"], theta_t["em_radiance"].grad)]
    for name, a, b in pairs:
        a, b = np.asarray(a), b.numpy()
        assert np.isfinite(a).all() and np.isfinite(b).all(), name
        scale = np.abs(a).max()
        assert scale > 0, name
        np.testing.assert_allclose(b, a, rtol=0, atol=1e-4 * scale,
                                   err_msg=name)
    rows = theta_t["medium_params"].grad.numpy()[0]
    assert (rows[0:6] != 0).all(), rows
    d_v = fog_smoke_cornell(mt)
    d_v["integrator"]["type"] = "volpath"
    img_v = mt.render(mt.load_dict(d_v, device="cpu"), seed=3, spp=4)
    assert np.isclose(img.detach().numpy(), img_v.numpy(), rtol=1e-5,
                      atol=1e-6).mean() > 0.999
