"""Port parity for implicit shapes against the JAX package: the analytic
rows (``ops/analytic.py``: spheres, disks, cylinders and round cones),
the loader's rows for them, SDF grids (``ops/sdf.py``), ``merge`` and
``ellipsoidsmesh``.

The intersections give JAX's row ids and hit masks bit-equal and its t
and uv within float tolerance, also with the rows evaluated in chunks
smaller than the table (the running reduction, ties to the largest row);
the loader's rows are bit-equal to ``_try_analytic``'s and
``curve_cone_rows``'s; scenes of each shape render per pixel as JAX's
do, a textured analytic sphere among them (its mip LOD read from the
last face, as in JAX). Gradients of d mean(image) / d(analytic_prims)
and / d(an SDF grid offset) through a plain ``path`` render are within
1e-4 of ``jax.grad``'s largest entry. JAX's analytic gradient is NaN in
every geometric column (its intersection evaluates all four types on
every row, and the types a row is not give 0 * inf in the backward of
its t), so JAX runs with its analytic intersection's ray inputs
detached, which changes none of its values; the port's scene gives its
analytic intersection detached rays too (ROADMAP queue 3).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mitsuba3_tpu as mj
from mitsuba3_tpu import loader as loader_j
from mitsuba3_tpu.core.vec import Vec2 as JV2, Vec3 as JV3
from mitsuba3_tpu.ops import analytic as analytic_j, sdf as sdf_j
from mitsuba3_tpu.shapes import curves as curves_j
from mitsuba3_tpu.shapes import make_ellipsoids_mesh as ellipsoids_j

import mitsuba3_tpu_torch as mt
from mitsuba3_tpu_torch import shapes as shapes_t
from mitsuba3_tpu_torch.convert import arrays_from_scene, scene_from_arrays
from mitsuba3_tpu_torch.core.vec import Vec2 as TV2, Vec3 as TV3
from mitsuba3_tpu_torch.ops import analytic as analytic_t, sdf as sdf_t
from mitsuba3_tpu_torch.shapes import curves as curves_t

torch.set_num_threads(1)
N_RAYS = 4096


def _rays(rng, n, lo=-5.0, hi=5.0, target=2.0):
    o = rng.uniform(lo, hi, (n, 3)).astype(np.float32)
    d = rng.uniform(-target, target, (n, 3)).astype(np.float32) - o
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    return o, d


def _jv(a):
    return JV3.from_array(jnp.asarray(a))


def _tv(a):
    return TV3(*torch.tensor(a).T)


def _table(rng, a=37):
    """A seeded table of all four types; row 5 repeats row 1 (equal t)."""
    rows = np.zeros((a, analytic_t.N_COLS), np.float32)
    for i in range(a):
        axis = rng.normal(size=3)
        axis /= np.linalg.norm(axis)
        u = np.cross(axis, [0.3, 1.0, 0.1])
        u /= np.linalg.norm(u)
        rows[i, 0] = i % 4
        rows[i, 1:4] = rng.uniform(-2, 2, 3)
        rows[i, 4:7] = axis
        rows[i, 7] = rng.uniform(0.2, 0.8)
        rows[i, 8] = rng.uniform(0.5, 2.0)
        rows[i, 9:12] = u
        rows[i, 12:15] = np.cross(axis, u)
        rows[i, 21] = rng.uniform(0.1, 0.5)
        rows[i, 22:24] = (0.1 * i, 0.1 * i + 0.1)
    rows[5] = rows[1]
    return rows


@pytest.fixture(scope="module")
def analytic_case():
    rng = np.random.default_rng(16)
    table = _table(rng)
    o, d = _rays(rng, N_RAYS)
    maxt = rng.uniform(1.0, 10.0, N_RAYS).astype(np.float32)
    active = rng.uniform(size=N_RAYS) > 0.1
    with jax.disable_jit():
        out = analytic_j.intersect_analytic(
            jnp.asarray(table), _jv(o), _jv(d), jnp.asarray(maxt),
            active=jnp.asarray(active))
    return table, o, d, maxt, active, [np.asarray(x) for x in (
        out[0], out[1], out[2].x, out[2].y, out[3])]


@pytest.mark.parametrize("step", [analytic_t.STEP_ELEMS, 3 * N_RAYS])
def test_intersect_analytic_matches_jax(analytic_case, step, monkeypatch):
    """Row ids and hit masks bit-equal, t and uv allclose, with a maxt cap
    and an active mask; STEP_ELEMS of three rows' lanes runs the running
    reduction over chunks smaller than the table."""
    table, o, d, maxt, active, (tj, aj, uj, vj, okj) = analytic_case
    monkeypatch.setattr(analytic_t, "STEP_ELEMS", step)
    tt, at, uvt, okt = analytic_t.intersect_analytic(
        torch.tensor(table), _tv(o), _tv(d), torch.tensor(maxt),
        active=torch.tensor(active))
    np.testing.assert_array_equal(at.numpy(), aj)
    np.testing.assert_array_equal(okt.numpy(), okj)
    assert 1000 < okj.sum() < N_RAYS and (aj[okj] == 5).any()
    assert not (aj[okj] == 1).any()     # ties go to the larger row, 5
    np.testing.assert_allclose(tt.numpy(), tj, rtol=1e-6)
    np.testing.assert_allclose(uvt.x.numpy()[okj], uj[okj], atol=2e-6)
    np.testing.assert_allclose(uvt.y.numpy()[okj], vj[okj], atol=2e-6)


def test_analytic_surface_fields_match_jax(analytic_case):
    table, o, d, maxt, active, (tj, aj, uj, vj, okj) = analytic_case
    with jax.disable_jit():
        pj, nj, _, rj = analytic_j.surface_fields(
            jnp.asarray(table), jnp.asarray(aj), JV2(jnp.asarray(uj),
                                                     jnp.asarray(vj)),
            _jv(o), _jv(d), jnp.asarray(tj))
    pt, nt, _, rt = analytic_t.surface_fields(
        torch.tensor(table), torch.tensor(aj), TV2(torch.tensor(uj),
                                                   torch.tensor(vj)),
        _tv(o), _tv(d), torch.tensor(tj))
    np.testing.assert_array_equal(rt.numpy(), np.asarray(rj))
    for c in "xyz":
        np.testing.assert_allclose(getattr(pt, c).numpy()[okj],
                                   np.asarray(getattr(pj, c))[okj],
                                   atol=2e-5)
        np.testing.assert_allclose(getattr(nt, c).numpy()[okj],
                                   np.asarray(getattr(nj, c))[okj],
                                   atol=2e-5)


ROW_SPECS = {
    "sphere": {"type": "sphere", "center": [0.5, -1, 2], "radius": 0.7},
    "disk": {"type": "disk"},
    "cylinder": {"type": "cylinder", "radius": 0.3, "p0": [1, 0, 0],
                 "p1": [1, 1, 0.5]},
    "to_world": {"type": "sphere", "radius": 0.5,
                 "to_world": mt.ScalarTransform4f().translate([1, 2, 3])
                 .rotate([0.3, 1, 0], 40).scale(1.7).matrix},
    # tessellated in both packages: no row
    "anisotropic": {"type": "disk",
                    "to_world": mt.ScalarTransform4f().scale(
                        [1, 2, 1]).matrix},
    "emitter": {"type": "sphere", "emitter": {"type": "area"}},
    "flip_normals": {"type": "cylinder", "flip_normals": True},
}


@pytest.mark.parametrize("case", sorted(ROW_SPECS))
def test_analytic_rows_match_jax(case):
    row_t = shapes_t.analytic_row(ROW_SPECS[case])
    row_j = loader_j._try_analytic(ROW_SPECS[case])
    if row_j is None:
        assert row_t is None
    else:
        np.testing.assert_array_equal(row_t, row_j)


@pytest.mark.parametrize("ctype", ["linearcurve", "bsplinecurve"])
def test_curve_cone_rows_match_jax(ctype):
    """Bit-equal rows at the 512-cone edge (a to_world ignored by both, as
    JAX's rows ignore it); one control point more is a tube."""
    bspline = ctype == "bsplinecurve"
    rng = np.random.default_rng(3)
    # a B-spline of n points makes n + 1 spans of 8 cones
    n = 63 if bspline else 513
    pts = np.cumsum(rng.normal(size=(n + 1, 3)) * 0.05, axis=0)

    def spec(k):
        return {"type": ctype, "control_points": np.concatenate(
            [pts[:k], np.full((k, 1), 0.02)], 1).tolist(),
            "to_world": np.diag([2.0, 2.0, 2.0, 1.0])}
    rows_t = curves_t.curve_cone_rows(spec(n), bspline)
    rows_j = curves_j.curve_cone_rows(spec(n), bspline)
    assert rows_j is not None and rows_j.shape[0] == 512
    np.testing.assert_array_equal(rows_t, rows_j)
    assert curves_t.curve_cone_rows(spec(n + 1), bspline) is None
    assert curves_j.curve_cone_rows(spec(n + 1), bspline) is None


def _analytic_dict(pkg, width=16, spp=4, max_depth=3):
    """tests/test_analytic.py's sphere, a cylinder and a disk (a glossy
    one), a B-spline cone set and a mipmapped textured sphere on a floor
    mesh, lit by a point light and a constant environment."""
    T = pkg.ScalarTransform4f
    tex = np.random.default_rng(4).uniform(0, 1, (16, 16, 3)).astype(
        np.float32)
    return {
        "type": "scene",
        "integrator": {"type": "path", "max_depth": max_depth},
        "sensor": {"type": "perspective", "fov": 45.0,
                   "to_world": T().look_at(origin=[0, 0.5, -4.5],
                                           target=[0, 0, 0], up=[0, 1, 0]),
                   "film": {"width": width, "height": width,
                            "rfilter": {"type": "box"}},
                   "sampler": {"type": "independent", "sample_count": spp}},
        "sph": {"type": "sphere", "center": [0, 0, 0], "radius": 1.0,
                "bsdf": {"type": "diffuse", "reflectance": {
                    "type": "rgb", "value": [0.8, 0.4, 0.2]}}},
        "tex_sph": {"type": "sphere", "center": [-1.6, 0.6, 0.5],
                    "radius": 0.5, "bsdf": {"type": "diffuse", "reflectance": {
                        "type": "bitmap", "data": tex, "mipmap": True}}},
        "cyl": {"type": "cylinder", "radius": 0.3, "p0": [1.2, -1, 0],
                "p1": [1.4, 1, 0.5], "bsdf": {"type": "roughconductor"}},
        "dsk": {"type": "disk", "to_world": T().translate([0, -1.2, 0])
                .rotate([1, 0, 0], -90).scale(2.5)},
        "hair": {"type": "bsplinecurve",
                 "control_points": [[-1, 1.2, -1, 0.1], [-0.4, 1.5, -1, 0.15],
                                    [0.2, 1.3, -1.2, 0.1],
                                    [0.8, 1.6, -1, 0.05]],
                 "bsdf": {"type": "diffuse"}},
        "floor": {"type": "rectangle", "to_world": T().translate(
            [0, -1.3, 0]).rotate([1, 0, 0], -90).scale(6)},
        "light": {"type": "point", "position": [3, 3, -3],
                  "intensity": {"type": "rgb", "value": [60, 60, 60]}},
        "env": {"type": "constant", "radiance": 0.3},
    }


def _assert_render_close(img_t, img_j):
    assert img_t.shape == img_j.shape
    assert np.isfinite(img_t).all() and img_t.max() > 0
    assert np.isclose(img_t, img_j, rtol=1e-3, atol=1e-3).mean() > 0.995
    np.testing.assert_allclose(img_t.mean(), img_j.mean(), rtol=1e-3)


def test_analytic_scene_renders_as_jax():
    """Sphere, disk, cylinder, round cones and a textured analytic sphere
    (its mip LOD and vertex color read from the clamped last face, as in
    JAX): the rows, the face tables and the render per pixel."""
    sj = mj.load_dict(_analytic_dict(mj))
    st = mt.load_dict(_analytic_dict(mt), device="cpu")
    np.testing.assert_array_equal(st.analytic_prims.numpy(),
                                  np.asarray(sj.analytic_prims))
    assert set(np.asarray(sj.analytic_prims)[:, 0]) == {0, 1, 2, 3}
    for f in ("vertices", "faces", "face_bsdf", "bsdf_params"):
        np.testing.assert_array_equal(getattr(st, f).numpy(),
                                      np.asarray(getattr(sj, f)), err_msg=f)
    img_j, rays_j = mj.render_with_stats(sj, seed=2, spp=4)
    img_t, rays_t = mt.render_with_stats(st, seed=2, spp=4)
    _assert_render_close(img_t.numpy(), np.asarray(img_j))
    assert abs(rays_t - float(rays_j)) <= 1e-3 * float(rays_j)


def _medium_dict(pkg):
    """An analytic sphere bounding a homogeneous medium inside a box of
    light, under volpath."""
    T = pkg.ScalarTransform4f
    return {
        "type": "scene",
        "integrator": {"type": "volpath", "max_depth": 4},
        "sensor": {"type": "perspective", "fov": 40.0,
                   "to_world": T().look_at(origin=[0, 0, -4],
                                           target=[0, 0, 0], up=[0, 1, 0]),
                   "film": {"width": 12, "height": 12,
                            "rfilter": {"type": "box"}},
                   "sampler": {"type": "independent", "sample_count": 4}},
        "fog": {"type": "homogeneous", "sigma_t": 1.5, "albedo": 0.8},
        "ball": {"type": "sphere", "radius": 1.0, "bsdf": {"type": "null"},
                 "interior": {"type": "ref", "id": "fog"}},
        "floor": {"type": "rectangle", "to_world": T().translate(
            [0, -1.2, 0]).rotate([1, 0, 0], -90).scale(4)},
        "light": {"type": "point", "position": [2, 3, -2],
                  "intensity": {"type": "rgb", "value": [30, 30, 30]}},
        "env": {"type": "constant", "radiance": 0.5},
    }


def test_analytic_medium_volpath_matches_jax():
    sj = mj.load_dict(_medium_dict(mj))
    st = mt.load_dict(_medium_dict(mt), device="cpu")
    np.testing.assert_array_equal(st.analytic_prims.numpy(),
                                  np.asarray(sj.analytic_prims))
    assert st.analytic_prims[0, 18] == 0    # the sphere's interior medium
    img_j = np.asarray(mj.render(sj, seed=1, spp=4))
    _assert_render_close(mt.render(st, seed=1, spp=4).numpy(), img_j)


def _sdf_sphere_grid(res=24, r=0.3, noise=0.0):
    ax = (np.arange(res) + 0.5) / res
    z, y, x = np.meshgrid(ax, ax, ax, indexing="ij")
    g = np.sqrt((x - 0.5) ** 2 + (y - 0.5) ** 2 + (z - 0.5) ** 2) - r
    if noise:
        g = g + noise * np.random.default_rng(9).normal(size=g.shape)
    return g.astype(np.float32)


def test_sdf_ops_match_jax():
    """_sample_sdf, sdf_normal and intersect_sdf (a rotated, scaled grid,
    maxt caps, an active mask) against JAX: hits bit-equal, t and uv
    allclose."""
    rng = np.random.default_rng(5)
    grid = _sdf_sphere_grid(20, noise=0.01)
    w2l = np.linalg.inv(np.asarray(mt.ScalarTransform4f().translate(
        [-0.4, 0.1, 0.2]).rotate([0, 1, 1], 30).scale(1.3).matrix))
    row = np.zeros(sdf_t.SDF_COLS, np.float32)
    row[0:12] = w2l[:3, :4].reshape(-1)
    o, d = _rays(rng, 2048, -3, 3, 1.0)
    maxt = rng.uniform(1, 8, 2048).astype(np.float32)
    act = rng.uniform(size=2048) > 0.1
    p = rng.uniform(-0.2, 1.2, (2048, 3)).astype(np.float32)
    with jax.disable_jit():
        sj = np.asarray(sdf_j._sample_sdf(jnp.asarray(grid), _jv(p)))
        nj = sdf_j.sdf_normal(jnp.asarray(grid), _jv(p))
        tj, uj, vj, okj = (np.asarray(x) for x in sdf_j.intersect_sdf(
            jnp.asarray(grid), jnp.asarray(row), _jv(o), _jv(d),
            jnp.asarray(maxt), active=jnp.asarray(act)))
    g = torch.tensor(grid)
    np.testing.assert_allclose(sdf_t._sample_sdf(g, _tv(p)).numpy(), sj,
                               atol=1e-6)
    nt = sdf_t.sdf_normal(g, _tv(p))
    for c in "xyz":
        np.testing.assert_allclose(getattr(nt, c).numpy(),
                                   np.asarray(getattr(nj, c)), atol=1e-5)
    tt, ut, vt, okt = sdf_t.intersect_sdf(g, torch.tensor(row), _tv(o),
                                          _tv(d), torch.tensor(maxt),
                                          active=torch.tensor(act))
    np.testing.assert_array_equal(okt.numpy(), okj)
    assert 100 < okj.sum() < 2048
    np.testing.assert_allclose(tt.numpy(), tj, rtol=1e-5)
    np.testing.assert_allclose(ut.numpy()[okj], uj[okj], atol=1e-5)
    np.testing.assert_allclose(vt.numpy()[okj], vj[okj], atol=1e-5)


def _sdf_dict(pkg, grid, width=16, spp=8, max_depth=3):
    """tests/test_analytic.py:189's SDF blob scene."""
    T = pkg.ScalarTransform4f
    return {
        "type": "scene",
        "integrator": {"type": "path", "max_depth": max_depth},
        "sensor": {"type": "perspective", "fov": 40.0,
                   "to_world": T().look_at(origin=[0.5, 0.5, -2.0],
                                           target=[0.5, 0.5, 0.5],
                                           up=[0, 1, 0]),
                   "film": {"width": width, "height": width,
                            "rfilter": {"type": "box"}},
                   "sampler": {"type": "independent", "sample_count": spp}},
        "blob": {"type": "sdfgrid", "grid": grid,
                 "bsdf": {"type": "diffuse", "reflectance": {
                     "type": "rgb", "value": [0.8, 0.3, 0.2]}}},
        "light": {"type": "point", "position": [2, 3, -2],
                  "intensity": {"type": "rgb", "value": [40, 40, 40]}},
        "env": {"type": "constant", "radiance": {"type": "rgb",
                                                 "value": 0.2}},
    }


def test_sdf_scene_renders_as_jax(tmp_path):
    """tests/test_analytic.py:189's scene per pixel; the grid read from a
    .vol file loads as JAX loads it."""
    from mitsuba3_tpu_torch.utils.vol_io import write_vol
    grid = _sdf_sphere_grid(32)
    sj = mj.load_dict(_sdf_dict(mj, grid))
    st = mt.load_dict(_sdf_dict(mt, grid), device="cpu")
    np.testing.assert_array_equal(st.sdf_rows.numpy(),
                                  np.asarray(sj.sdf_rows))
    path = str(tmp_path / "blob.vol")
    write_vol(path, grid)
    from_file = []
    for pkg, kw in ((mj, {}), (mt, {"device": "cpu"})):
        d = _sdf_dict(pkg, grid)
        d["blob"] = {"type": "sdfgrid", "filename": path}
        from_file.append(pkg.load_dict(d, **kw))
    np.testing.assert_array_equal(from_file[1].sdf_grids[0].numpy(),
                                  np.asarray(from_file[0].sdf_grids[0]))
    np.testing.assert_array_equal(from_file[1].sdf_grids[0].numpy(), grid)
    img_j = np.asarray(mj.render(sj, seed=1, spp=8))
    _assert_render_close(mt.render(st, seed=1, spp=8).numpy(), img_j)


def test_sdf_grid_gradient_matches_jax():
    """tests/test_analytic.py:217: d mean(image) / d(an offset of the SDF
    grid) through a plain path render, finite, nonzero and equal to
    jax.grad's within 1e-4 of its magnitude."""
    base = _sdf_sphere_grid(24)
    d_j = _sdf_dict(mj, base, width=8, spp=4, max_depth=2)
    d_j.pop("env")
    sj = mj.load_dict(d_j)

    def loss(offset):
        s = sj.replace(sdf_grids=(sj.sdf_grids[0] + offset,))
        return mj.render(s, spp=4, seed=0).mean()
    gj = float(jax.grad(loss)(jnp.float32(0.0)))
    d_t = _sdf_dict(mt, base, width=8, spp=4, max_depth=2)
    d_t.pop("env")
    st = mt.load_dict(d_t, device="cpu")
    off = torch.zeros((), requires_grad=True)
    mt.render(st.replace(sdf_grids=(st.sdf_grids[0] + off,)), spp=4,
              seed=0).mean().backward()
    gt = float(off.grad)
    assert np.isfinite(gt) and gt != 0.0
    assert abs(gt - gj) <= 1e-4 * abs(gj)


def _grad_dict(pkg, max_depth):
    """A diffuse sphere, cylinder and disk (8^2)."""
    d = _analytic_dict(pkg, width=8, spp=4, max_depth=max_depth)
    for k in ("tex_sph", "hair", "floor"):
        d.pop(k)
    d["cyl"]["bsdf"] = {"type": "diffuse"}
    return d


@pytest.mark.parametrize("max_depth", [2, 3])
def test_analytic_prims_gradient_matches_jax(monkeypatch, max_depth):
    """d mean(image) / d(analytic_prims) through a plain path render
    against jax.grad (JAX's analytic intersection given detached rays, as
    the port's is, see the module docstring): every entry finite, within
    1e-4 of JAX's largest, the rows' geometric columns nonzero. At
    max_depth 3 a second analytic hit's BSDF and its light sample enter
    the image."""
    orig = analytic_j.intersect_analytic

    def detached_rays(table, o, d, maxt, active=None, any_hit=False):
        sg = jax.lax.stop_gradient
        return orig(table, jax.tree_util.tree_map(sg, o),
                    jax.tree_util.tree_map(sg, d), sg(maxt), active=active,
                    any_hit=any_hit)
    monkeypatch.setattr(analytic_j, "intersect_analytic", detached_rays)
    sj = mj.load_dict(_grad_dict(mj, max_depth))
    gj = np.asarray(jax.grad(lambda ap: mj.render(
        sj.replace(analytic_prims=ap), spp=4, seed=0).mean())(
            sj.analytic_prims))
    st = mt.load_dict(_grad_dict(mt, max_depth), device="cpu")
    ap = st.analytic_prims.clone().requires_grad_(True)
    mt.render(st.replace(analytic_prims=ap), spp=4, seed=0).mean().backward()
    gt = ap.grad.numpy()
    assert np.isfinite(gj).all() and np.isfinite(gt).all()
    np.testing.assert_allclose(gt, gj, rtol=0, atol=1e-4 * np.abs(gj).max())
    assert (np.abs(gt[:, 1:8]).max(axis=1) > 0).all()


def test_round_cones_part_on_ulps_of_the_rays():
    """A witness, on the CPU, of why chip_smoke renders the analytic
    terrain's round cones on the card from the CPU's camera rays (and
    the terrain without them from the card's own): camera directions
    renormalised by a division (a change of at most a few ulps on ~40 % of
    lanes, as the card's differ from the CPU's) part the 24^2 render of
    ten seeded cone sets, whose grazing hits move by ~1e-4, while the
    same terrain's spheres, cylinders and disks do not part."""
    import chip_smoke
    from mitsuba3_tpu_torch.render import integrator as ri
    T = mt.ScalarTransform4f
    plain = ri.sensors.sample_ray

    def renormalised(*args, **kw):
        r = plain(*args, **kw)
        n = torch.sqrt(r.d.x * r.d.x + r.d.y * r.d.y + r.d.z * r.d.z)
        return r.replace(d=TV3(r.d.x / n, r.d.y / n, r.d.z / n))
    close = {}
    for tag, kw in (("cones", dict(counts=(0, 0, 0), n_curves=10)),
                    ("shapes", dict(n_curves=0))):
        d = chip_smoke.analytic_terrain_dict(
            chip_smoke.small_terrain_dict, T, width=24, seed=11, **kw)
        d["integrator"] = dict(d["integrator"], max_depth=2)
        with pytest.MonkeyPatch.context() as mp:
            mp.setenv("MI3T_ACCEL", "cells")
            scene = mt.load_dict(d, device="cpu")
        img = mt.render(scene, seed=5, spp=4).numpy()
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(ri.sensors, "sample_ray", renormalised)
            img_ulp = mt.render(scene, seed=5, spp=4).numpy()
        close[tag] = np.isclose(img_ulp, img, rtol=1e-3, atol=1e-3).mean()
    assert close["cones"] < 0.995 and close["shapes"] == 1.0, close


ELLIPSOIDS = {
    "centers": np.random.default_rng(6).uniform(-1, 1, (20, 3)),
    "scales": np.random.default_rng(7).uniform(0.05, 0.2, (20, 3)),
    "quaternions": np.random.default_rng(8).normal(size=(20, 4)),
    "colors": np.random.default_rng(9).uniform(0, 1, (20, 3)),
    "extent": 2.0}


@pytest.mark.parametrize("shell", ["default", "box"])
def test_ellipsoids_mesh_bit_equal(shell):
    spec = dict(ELLIPSOIDS, type="ellipsoidsmesh", shell=shell)
    a, b = ellipsoids_j(spec), shapes_t.make_ellipsoids_mesh(spec)
    for f in ("vertices", "faces", "normals", "colors", "uvs"):
        x, y = getattr(a, f), getattr(b, f)
        assert (x is None) == (y is None), f
        if x is not None:
            np.testing.assert_array_equal(y, x, err_msg=f)


def _merge_dict(pkg):
    """A merge of a ground rectangle and an ellipsoid cloud, and a second
    (box-shell) cloud at the top level with its vertex-color default."""
    T = pkg.ScalarTransform4f
    return {
        "type": "scene",
        "integrator": {"type": "path", "max_depth": 3},
        "sensor": {"type": "perspective", "fov": 45.0,
                   "to_world": T().look_at(origin=[0, -4, 2],
                                           target=[0, 0, 0], up=[0, 0, 1]),
                   "film": {"width": 16, "height": 16,
                            "rfilter": {"type": "box"}},
                   "sampler": {"type": "independent", "sample_count": 4}},
        "m": {"type": "merge",
              "ground": {"type": "rectangle",
                         "to_world": T().translate([0, 0, -1]).scale(3)},
              "cloud": dict(ELLIPSOIDS, type="ellipsoidsmesh")},
        "cloud2": dict(ELLIPSOIDS, type="ellipsoidsmesh", shell="box",
                       to_world=T().translate([0, 0, 1])),
        "env": {"type": "constant", "radiance": 1.0},
    }


def test_merge_and_ellipsoidsmesh_scene_matches_jax():
    sj = mj.load_dict(_merge_dict(mj))
    st = mt.load_dict(_merge_dict(mt), device="cpu")
    for f in ("vertices", "faces", "face_shape", "face_bsdf", "face_colors",
              "face_normals", "face_uv", "bsdf_params"):
        np.testing.assert_array_equal(getattr(st, f).numpy(),
                                      np.asarray(getattr(sj, f)), err_msg=f)
    assert st.texture_ids("diffuse") == (-1,)   # the vertex-color default
    img_j = np.asarray(mj.render(sj, seed=0, spp=4))
    _assert_render_close(mt.render(st, seed=0, spp=4).numpy(), img_j)


def test_convert_carries_implicit_geometry():
    """scene_from_arrays(arrays_from_scene(JAX scene)) gives the port's
    load_dict scene: analytic rows, SDF grids and rows."""
    d_j, d_t = _analytic_dict(mj), _analytic_dict(mt)
    grid = _sdf_sphere_grid(12)
    d_j["blob"] = {"type": "sdfgrid", "grid": grid}
    d_t["blob"] = {"type": "sdfgrid", "grid": grid}
    conv = scene_from_arrays(*arrays_from_scene(mj.load_dict(d_j)),
                             device="cpu")
    own = mt.load_dict(d_t, device="cpu")
    for f in ("analytic_prims", "sdf_rows", "face_bsdf"):
        np.testing.assert_array_equal(getattr(conv, f).numpy(),
                                      getattr(own, f).numpy(), err_msg=f)
    np.testing.assert_array_equal(conv.sdf_grids[0].numpy(),
                                  own.sdf_grids[0].numpy())
    assert conv.bsdf_reach == own.bsdf_reach
    np.testing.assert_allclose(mt.render(conv, seed=1, spp=2).numpy(),
                               mt.render(own, seed=1, spp=2).numpy(),
                               rtol=0, atol=0)
