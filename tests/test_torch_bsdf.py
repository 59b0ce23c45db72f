"""Port parity for the BSDF layer: ``render/fresnel.py``,
``render/microfacet.py`` and every BSDF the port loads (conductor to
blendbsdf, with twosided), against the JAX package in the same process.

Per case the loader's row, type, slot flags and adapter depth are
bit-equal to JAX's; ``sample``, ``eval_pdf`` and (null, mask)
``eval_null_transmission`` agree on 4,096 random local frames from both
sides of the surface at rtol 1e-5 / atol 1e-6, or rtol 1e-4 where the
function takes log, exp, tan or erf (Beckmann lobes, the roughplastic
coat); the sampled lobe types are equal, and a sample's direction, pdf
and weight may miss on 0.25 % of the lanes (SAMPLE_OUTLIERS). JAX runs
eagerly at that width (no jit: one compile per case would cost more than
the work)."""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mitsuba3_tpu as mj
from mitsuba3_tpu import bsdfs as bsdfs_j
from mitsuba3_tpu.core.vec import Vec2 as Vec2J
from mitsuba3_tpu.core.vec import Vec3 as Vec3J
from mitsuba3_tpu.render import fresnel as fresnel_j
from mitsuba3_tpu.render import microfacet as mf_j

import chip_smoke
import mitsuba3_tpu_torch as mt
from mitsuba3_tpu_torch import bsdfs as bsdfs_t
from mitsuba3_tpu_torch.core.struct import struct
from mitsuba3_tpu_torch.core.vec import Vec2, Vec3
from mitsuba3_tpu_torch.render import fresnel as fresnel_t
from mitsuba3_tpu_torch.render import microfacet as mf_t

torch.set_num_threads(1)
N = 4096
# XLA-CPU's rsqrt, sin and cos differ from torch's by an ulp on about 29 %,
# 5 % and 5 % of inputs; a sampled direction amplifies that where it is
# built from sqrt(1 - p^2) near the rim of the sampling disk (the cosine
# warp, the GGX visible-normal sampler) and through the half-vector
# Jacobians near grazing angles, up to 2e-5 on a handful of lanes. So a
# sample's wo, pdf and weight may miss the tolerance on 0.25 % of the
# lanes (10 of 4,096), within rtol 1e-3 / atol 5e-5.
SAMPLE_OUTLIERS = 2.5e-3

ROUGH_PLASTIC = {"type": "roughplastic", "alpha": 0.2, "distribution": "ggx",
                 "diffuse_reflectance": {"type": "rgb",
                                         "value": [0.6, 0.6, 0.7]}}
# case -> (BSDF spec, rtol)
CASES = {
    "conductor": ({"type": "conductor", "material": "Au"}, 1e-5),
    "roughconductor_ggx": ({"type": "roughconductor", "alpha": 0.25,
                            "material": "Au"}, 1e-5),
    "roughconductor_beckmann": ({"type": "roughconductor", "alpha": 0.3,
                                 "distribution": "beckmann",
                                 "material": "Ag"}, 1e-5),
    "roughconductor_ggx_aniso": ({"type": "roughconductor",
                                  "material": "Cu", "alpha_u": 0.05,
                                  "alpha_v": 0.3}, 1e-5),
    "roughconductor_beckmann_aniso": ({"type": "roughconductor",
                                       "material": "Al", "alpha_u": 0.4,
                                       "alpha_v": 0.1,
                                       "distribution": "beckmann"}, 1e-5),
    "plastic": ({"type": "plastic"}, 1e-5),
    "plastic_nonlinear": ({"type": "plastic", "nonlinear": True,
                           "diffuse_reflectance": {
                               "type": "rgb", "value": [0.7, 0.3, 0.1]}},
                          1e-5),
    "roughplastic_ggx": (ROUGH_PLASTIC, 1e-4),
    "roughplastic_beckmann": ({"type": "roughplastic", "alpha": 0.3,
                               "nonlinear": True}, 1e-4),
    "dielectric": ({"type": "dielectric", "int_ior": 1.5}, 1e-5),
    "thindielectric": ({"type": "thindielectric"}, 1e-5),
    "roughdielectric_ggx": ({"type": "roughdielectric", "alpha": 0.15,
                             "distribution": "ggx"}, 1e-5),
    "roughdielectric_beckmann": ({"type": "roughdielectric", "alpha": 0.2,
                                  "distribution": "beckmann"}, 1e-4),
    "null": ({"type": "null", "transmittance": {
        "type": "rgb", "value": [0.9, 0.8, 0.7]}}, 1e-5),
    "mask": ({"type": "mask", "opacity": 0.7,
              "bsdf": {"type": "conductor", "material": "Au"}}, 1e-5),
    "blendbsdf": ({"type": "blendbsdf", "weight": 0.3,
                   "bsdf_0": {"type": "diffuse"},
                   "bsdf_1": {"type": "roughconductor", "material": "Cu",
                              "alpha_u": 0.05, "alpha_v": 0.3}}, 1e-5),
    "twosided_roughconductor": ({"type": "twosided", "bsdf": {
        "type": "roughconductor", "alpha": 0.25, "material": "Au"}}, 1e-5),
    "twosided_mask": ({"type": "twosided", "bsdf": {
        "type": "mask", "opacity": 0.7, "bsdf": ROUGH_PLASTIC}}, 1e-4),
}
NULL_LIKE = ("null", "mask", "twosided_mask")


def _scene_dict(bsdf):
    return {"type": "scene",
            "quad": {"type": "rectangle", "bsdf": bsdf}}


@functools.lru_cache(maxsize=None)
def _scenes(case):
    """(JAX scene, port scene) of one rectangle carrying the case's BSDF;
    its slot is the last one (nested slots come first)."""
    spec = CASES[case][0]
    return (mj.load_dict(_scene_dict(spec)),
            mt.load_dict(_scene_dict(spec), device="cpu"))


@dataclasses.dataclass
class _SIJ:
    """The surface-interaction fields a JAX BSDF reads."""
    wi: Vec3J
    t: jnp.ndarray
    wavelengths: Vec3J = None


@struct
class _SIT:
    wi: Vec3
    t: torch.Tensor


def _dirs(rng, n):
    d = rng.normal(size=(n, 3))
    return (d / np.linalg.norm(d, axis=1, keepdims=True)).astype(np.float32)


def _inputs(seed=7):
    """Random local frames (wi, wo on the whole sphere: both sides) and
    samples (s1, s2), from a numpy seed."""
    rng = np.random.default_rng(seed)
    return (_dirs(rng, N), _dirs(rng, N),
            rng.uniform(0, 1, N).astype(np.float32),
            rng.uniform(0, 1, (N, 2)).astype(np.float32))


def _vj(a):
    return Vec3J(*(jnp.asarray(a[:, i]) for i in range(3)))


def _vt(a):
    return Vec3(*(torch.as_tensor(np.ascontiguousarray(a[:, i]))
                  for i in range(3)))


def _si_pair(wi):
    t = np.ones(N, np.float32)
    return (_SIJ(wi=_vj(wi), t=jnp.asarray(t)),
            _SIT(wi=_vt(wi), t=torch.as_tensor(t)))


def _close(a, b, rtol, what, atol=1e-6, outliers=0):
    """allclose at (rtol, atol); with `outliers` > 0, that share of the
    lanes may miss it but must stay within rtol 1e-3 / atol 5e-5."""
    a = np.asarray(a)
    b = b.detach().numpy() if isinstance(b, torch.Tensor) else np.asarray(b)
    if not outliers:
        np.testing.assert_allclose(b, a, rtol=rtol, atol=atol, err_msg=what)
        return
    miss = ~np.isclose(b, a, rtol=rtol, atol=atol)
    assert miss.mean() <= outliers, (what, int(miss.sum()))
    np.testing.assert_allclose(b, a, rtol=1e-3, atol=5e-5, err_msg=what)


def _close_vec(a, b, rtol, what, atol=1e-6, outliers=0):
    for c in "xyz":
        _close(getattr(a, c), getattr(b, c), rtol, f"{what}.{c}", atol,
               outliers)


def _slots(st, idx=None):
    """The case's top slot (the last) on every lane, or `idx`."""
    last = len(st.bsdf_types) - 1
    idx = np.full(N, last, np.int32) if idx is None else idx
    return jnp.asarray(idx), torch.as_tensor(idx)


@pytest.mark.parametrize("case", sorted(CASES))
def test_bsdf_rows_match_jax(case):
    """Rows, type ids, slot flags and adapter depth bit-equal to JAX's."""
    sj, st = _scenes(case)
    np.testing.assert_array_equal(np.asarray(sj.bsdf_params),
                                  st.bsdf_params.numpy())
    assert sj.bsdf_params.dtype == np.float32
    assert tuple(sj.bsdf_types) == st.bsdf_types
    assert tuple(sj.bsdf_flags) == st.bsdf_flags
    assert sj.adapter_max_depth == st.adapter_max_depth


def _sample(sj, st, idx, seed=7):
    wi, _, s1, s2 = _inputs(seed)
    si_j, si_t = _si_pair(wi)
    ij, it = idx
    bj, wj = bsdfs_j.sample(sj, ij, si_j, jnp.asarray(s1),
                            Vec2J(jnp.asarray(s2[:, 0]),
                                  jnp.asarray(s2[:, 1])))
    bt, wt = bsdfs_t.sample(st, it, si_t, torch.as_tensor(s1),
                            Vec2(torch.as_tensor(s2[:, 0]),
                                 torch.as_tensor(s2[:, 1])))
    return bj, wj, bt, wt


def _assert_samples_close(bj, wj, bt, wt, rtol):
    """The sampled lobes equal; wo, pdf, eta and weight at `rtol` on all
    but SAMPLE_OUTLIERS of the lanes."""
    np.testing.assert_array_equal(
        np.asarray(bj.sampled_type).astype(np.int64),
        bt.sampled_type.numpy().astype(np.int64))
    np.testing.assert_array_equal(np.asarray(bj.sampled_component),
                                  bt.sampled_component.numpy())
    _close_vec(bj.wo, bt.wo, rtol, "wo", outliers=SAMPLE_OUTLIERS)
    _close(bj.pdf, bt.pdf, rtol, "pdf", outliers=SAMPLE_OUTLIERS)
    _close(bj.eta, bt.eta, rtol, "eta")
    _close_vec(wj, wt, rtol, "weight", outliers=SAMPLE_OUTLIERS)


@pytest.mark.parametrize("case", sorted(CASES))
def test_bsdf_sample_matches_jax(case):
    """sample: wo, pdf, eta and weight allclose, the sampled lobe equal;
    some lanes are live and some are not."""
    sj, st = _scenes(case)
    bj, wj, bt, wt = _sample(sj, st, _slots(st))
    _assert_samples_close(bj, wj, bt, wt, CASES[case][1])
    live = bt.pdf.numpy() > 0
    assert 0.1 < live.mean() <= 1.0


@pytest.mark.parametrize("case", sorted(CASES))
def test_bsdf_eval_pdf_matches_jax(case):
    """eval_pdf (value with the cosine, pdf) allclose on random wi, wo."""
    sj, st = _scenes(case)
    wi, wo, _, _ = _inputs(11)
    si_j, si_t = _si_pair(wi)
    ij, it = _slots(st)
    vj, pj = bsdfs_j.eval_pdf(sj, ij, si_j, _vj(wo))
    vt, pt = bsdfs_t.eval_pdf(st, it, si_t, _vt(wo))
    rtol = CASES[case][1]
    _close_vec(vj, vt, rtol, "value")
    _close(pj, pt, rtol, "pdf")
    assert np.isfinite(pt.numpy()).all()
    delta = not (st.bsdf_flags[-1] & bsdfs_t.SMOOTH)
    assert (pt.numpy() > 0).any() != delta


@pytest.mark.parametrize("case", NULL_LIKE)
def test_bsdf_null_transmission_matches_jax(case):
    sj, st = _scenes(case)
    wi, _, _, _ = _inputs(13)
    si_j, si_t = _si_pair(wi)
    ij, it = _slots(st)
    tj = bsdfs_j.eval_null_transmission(sj, ij, si_j)
    tt = bsdfs_t.eval_null_transmission(st, it, si_t)
    _close_vec(tj, tt, 1e-6, "transmission", atol=0)
    assert float(tt.x.min()) > 0


@functools.lru_cache(maxsize=None)
def _every_bsdf():
    return (mj.load_dict(chip_smoke.every_bsdf_dict(mj, 8, 8, 4)),
            mt.load_dict(chip_smoke.every_bsdf_dict(mt, 8, 8, 4),
                         device="cpu"))


def test_mixed_lanes_match_jax():
    """The every-BSDF Cornell's slots drawn per lane: the masked dispatch
    over its 14 types (adapters nesting at depth 1) matches JAX's in
    sample and eval_pdf; rows, flags and depth bit-equal."""
    sj, st = _every_bsdf()
    np.testing.assert_array_equal(np.asarray(sj.bsdf_params),
                                  st.bsdf_params.numpy())
    assert (tuple(sj.bsdf_flags), sj.adapter_max_depth) == (
        st.bsdf_flags, st.adapter_max_depth)
    assert set(st.bsdf_types) == set(range(11)) | {12, 15, 18}
    # lanes here name every slot, nested ones too, which no face names: the
    # dispatch's reach is that of faces naming every slot
    st = st.replace(bsdf_reach=bsdfs_t.reachable_types(
        st.bsdf_types, st.bsdf_params.numpy(), range(len(st.bsdf_types))))
    idx = np.random.default_rng(3).integers(0, len(st.bsdf_types), N)
    idx = idx.astype(np.int32)
    bj, wj, bt, wt = _sample(sj, st, _slots(st, idx), seed=17)
    _assert_samples_close(bj, wj, bt, wt, 1e-4)
    wi, wo, _, _ = _inputs(19)
    si_j, si_t = _si_pair(wi)
    vj, pj = bsdfs_j.eval_pdf(sj, jnp.asarray(idx), si_j, _vj(wo))
    vt, pt = bsdfs_t.eval_pdf(st, torch.as_tensor(idx), si_t, _vt(wo))
    _close_vec(vj, vt, 1e-4, "value")
    _close(pj, pt, 1e-4, "pdf")


# ---------------------------------------------------------------------------
# Fresnel and microfacet functions
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("eta", [1.5, 1 / 1.5, 1.0, 2.4])
def test_fresnel_dielectric_matches_jax(eta):
    """r, cos_theta_t, eta_it, eta_ti on cosines over [-1, 1] (both sides,
    with total internal reflection where eta_ti > 1)."""
    rng = np.random.default_rng(1)
    c = np.concatenate([rng.uniform(-1, 1, N - 4), [-1, 0, 1, 1e-4]])
    c = c.astype(np.float32)
    e = np.full(N, eta, np.float32)
    outs_j = fresnel_j.fresnel_dielectric(jnp.asarray(c), jnp.asarray(e))
    outs_t = fresnel_t.fresnel_dielectric(torch.as_tensor(c),
                                          torch.as_tensor(e))
    for name, a, b in zip(("r", "cos_theta_t", "eta_it", "eta_ti"), outs_j,
                          outs_t):
        _close(a, b, 1e-5, name)
    if eta != 1.0:
        assert (outs_t[0].numpy() == 1.0).any()     # TIR from inside


def test_fresnel_conductor_and_directions_match_jax():
    """fresnel_conductor for every named material, fresnel_diffuse_
    reflectance, reflect, reflect_m, refract, refract_m; CONDUCTOR_IOR
    equal."""
    assert fresnel_t.CONDUCTOR_IOR == fresnel_j.CONDUCTOR_IOR
    rng = np.random.default_rng(2)
    c = rng.uniform(0, 1, N).astype(np.float32)
    for eta, k in fresnel_t.CONDUCTOR_IOR.values():
        ej, kj = Vec3J(*map(jnp.float32, eta)), Vec3J(*map(jnp.float32, k))
        et = Vec3(*(torch.tensor(v, dtype=torch.float32) for v in eta))
        kt = Vec3(*(torch.tensor(v, dtype=torch.float32) for v in k))
        _close_vec(fresnel_j.fresnel_conductor(jnp.asarray(c), ej, kj),
                   fresnel_t.fresnel_conductor(torch.as_tensor(c), et, kt),
                   1e-5, "fresnel_conductor")
    e = rng.uniform(0.3, 3.0, N).astype(np.float32)
    _close(fresnel_j.fresnel_diffuse_reflectance(jnp.asarray(e)),
           fresnel_t.fresnel_diffuse_reflectance(torch.as_tensor(e)), 1e-5,
           "fresnel_diffuse_reflectance")
    wi, mn = _dirs(rng, N), _dirs(rng, N)
    ct = rng.uniform(-1, 1, N).astype(np.float32)
    eti = rng.uniform(0.5, 2.0, N).astype(np.float32)
    _close_vec(fresnel_j.reflect(_vj(wi)), fresnel_t.reflect(_vt(wi)), 0,
               "reflect", atol=0)
    _close_vec(fresnel_j.reflect_m(_vj(wi), _vj(mn)),
               fresnel_t.reflect_m(_vt(wi), _vt(mn)), 1e-5, "reflect_m")
    _close_vec(fresnel_j.refract(_vj(wi), jnp.asarray(ct), jnp.asarray(eti)),
               fresnel_t.refract(_vt(wi), torch.as_tensor(ct),
                                 torch.as_tensor(eti)), 1e-6, "refract")
    _close_vec(fresnel_j.refract_m(_vj(wi), _vj(mn), jnp.asarray(ct),
                                   jnp.asarray(eti)),
               fresnel_t.refract_m(_vt(wi), _vt(mn), torch.as_tensor(ct),
                                   torch.as_tensor(eti)), 1e-5, "refract_m")


@pytest.mark.parametrize("dist", ["ggx", "beckmann"])
@pytest.mark.parametrize("alphas", [(0.25, 0.25), (0.05, 0.4), (0.9, 0.6)])
def test_microfacet_matches_jax(dist, alphas):
    """eval_ndf, smith_g1, G, sample_visible (GGX: visible normals;
    Beckmann: its full NDF) and pdf_visible on random directions from both
    hemispheres; rtol 1e-5 for GGX, 1e-4 for Beckmann (exp, log)."""
    dj = mf_j.GGX if dist == "ggx" else mf_j.BECKMANN
    dt = mf_t.GGX if dist == "ggx" else mf_t.BECKMANN
    rtol = 1e-5 if dist == "ggx" else 1e-4
    rng = np.random.default_rng(4)
    wi, wo, mn = _dirs(rng, N), _dirs(rng, N), _dirs(rng, N)
    mn[:, 2] = np.abs(mn[:, 2])
    s2 = rng.uniform(0, 1, (N, 2)).astype(np.float32)
    au = np.full(N, alphas[0], np.float32)
    av = np.full(N, alphas[1], np.float32)
    aj, bj = jnp.asarray(au), jnp.asarray(av)
    at, bt = torch.as_tensor(au), torch.as_tensor(av)
    _close(mf_j.eval_ndf(dj, _vj(mn), aj, bj),
           mf_t.eval_ndf(dt, _vt(mn), at, bt), rtol, "eval_ndf")
    _close(mf_j.smith_g1(dj, _vj(wi), _vj(mn), aj, bj),
           mf_t.smith_g1(dt, _vt(wi), _vt(mn), at, bt), rtol, "smith_g1")
    _close(mf_j.G(dj, _vj(wi), _vj(wo), _vj(mn), aj, bj),
           mf_t.G(dt, _vt(wi), _vt(wo), _vt(mn), at, bt), rtol, "G")
    mj_, pj = mf_j.sample_visible(dj, _vj(wi), Vec2J(jnp.asarray(s2[:, 0]),
                                                     jnp.asarray(s2[:, 1])),
                                  aj, bj)
    mt_, pt = mf_t.sample_visible(dt, _vt(wi), Vec2(torch.as_tensor(s2[:, 0]),
                                                    torch.as_tensor(s2[:, 1])),
                                  at, bt)
    _close_vec(mj_, mt_, rtol, "sample_visible m",
               outliers=SAMPLE_OUTLIERS)
    _close(pj, pt, rtol, "sample_visible pdf", atol=1e-5,
           outliers=SAMPLE_OUTLIERS)
    assert float(mt_.z.min()) > 0 and np.isfinite(pt.numpy()).all()
    _close(mf_j.pdf_visible(dj, _vj(wi), _vj(mn), aj, bj),
           mf_t.pdf_visible(dt, _vt(wi), _vt(mn), at, bt), rtol,
           "pdf_visible", atol=1e-5)


# ---------------------------------------------------------------------------
# Gradients where a branch not taken could turn into NaN
# ---------------------------------------------------------------------------

EDGE_CASES = {
    # roughness near 0 on a glossy lobe
    "alpha_to_0": ({"type": "roughconductor", "alpha": 1e-4,
                    "material": "Au"}, "normal"),
    # directions at grazing incidence
    "grazing": ({"type": "roughplastic", "alpha": 0.2,
                 "distribution": "beckmann"}, "grazing"),
    # from inside a dielectric past the critical angle
    "total_internal_reflection": ({"type": "roughdielectric",
                                   "alpha": 0.2}, "inside"),
    "masked_dispatch": (None, "normal"),
}


def _edge_dirs(kind, rng):
    wi, wo = _dirs(rng, 512), _dirs(rng, 512)
    if kind == "grazing":
        wi[:, 2] = np.sign(wi[:, 2]) * 1e-4
        wo[:, 2] = np.abs(wo[:, 2]) * 1e-3
    elif kind == "inside":
        wi[:, 2] = -np.abs(wi[:, 2]) * 0.3     # beyond the critical angle
    for v in (wi, wo):
        v /= np.linalg.norm(v, axis=1, keepdims=True)
    return wi, wo


@pytest.mark.parametrize("case", sorted(EDGE_CASES))
def test_bsdf_param_gradients_finite(case):
    """d(sum of eval_pdf's value and pdf)/d bsdf_params, the quantity PRB's
    replay differentiates, is finite at alpha -> 0, at grazing cos theta,
    under total internal reflection and through the every-BSDF scene's
    masked dispatch (every type evaluated on every lane) and matches
    jax.grad where JAX's is finite."""
    spec, kind = EDGE_CASES[case]
    if spec is None:
        sj, st = _every_bsdf()
        idx = np.random.default_rng(5).integers(0, len(st.bsdf_types), 512)
    else:
        sj, st = (mj.load_dict(_scene_dict(spec)),
                  mt.load_dict(_scene_dict(spec), device="cpu"))
        idx = np.full(512, len(st.bsdf_types) - 1)
    idx = idx.astype(np.int32)
    wi, wo = _edge_dirs(kind, np.random.default_rng(6))
    leaf = st.bsdf_params.clone().requires_grad_(True)
    si = _SIT(wi=_vt(wi), t=torch.ones(512))
    v, p = bsdfs_t.eval_pdf(st.replace(bsdf_params=leaf),
                            torch.as_tensor(idx), si, _vt(wo))
    (g,) = torch.autograd.grad((v.x + v.y + v.z + p).sum(), [leaf])
    assert torch.isfinite(g).all(), case
    assert float(g.abs().max()) > 0

    def loss(table):
        s = sj.replace(bsdf_params=table)
        vj, pj = bsdfs_j.eval_pdf(s, jnp.asarray(idx),
                                  _SIJ(wi=_vj(wi), t=jnp.ones(512)),
                                  _vj(wo))
        return (vj.x + vj.y + vj.z + pj).sum()
    gj = np.asarray(jax.grad(loss)(sj.bsdf_params))
    ok = np.isfinite(gj)
    np.testing.assert_allclose(g.numpy()[ok], gj[ok], rtol=1e-3,
                               atol=1e-4 * np.abs(gj[ok]).max())
