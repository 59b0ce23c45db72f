"""Port parity for textured scenes through the renderer: the loader's
leaves (textures, their metadata and mip levels, vertex colors, the
environment map and its tables) bit-equal to JAX's; 16^2 renders per
pixel against JAX for a bitmap, a mipmapped bitmap, a normalmap, a
bumpmap, a mask and a blendbsdf with textured opacity and weight, vertex
colors (mesh_attribute), a volume texture and an envmap read from an
``.hdr`` file, and the textured Cornell of ``chip_smoke`` read from its
XML file; PRB gradients of textures and env_data against ``jax.grad`` on
one scene with every texture type, of a normalmap's, a mask's and a
nested roughplastic's textures, and of a subset of the textures;
texture and BSDF-row edits through ``traverse``; an envmap scene file
and a ``.vol`` grid; the textured parameters the port refuses. Mirrors
tests/test_render.py:129-230,380, tests/test_ad.py:93 and
tests/test_emitters.py:82.

JAX renders run eagerly (``jax.disable_jit``): its jitted render of one
of these scenes takes longer to compile than its eager one to run."""
import os

import jax
import numpy as np
import pytest
import torch

import mitsuba3_tpu as mj
from mitsuba3_tpu.shapes import serialized_io as ser_j

import chip_smoke
import mitsuba3_tpu_torch as mt
from mitsuba3_tpu_torch.convert import arrays_from_scene, scene_from_arrays
from mitsuba3_tpu_torch.utils import image_io as io_t
from test_torch_prb import _grads_jax, _grads_port

torch.set_num_threads(1)
SIZE = 16
SPP = 4
KINDS = ("bitmap", "mipmap", "normalmap", "bumpmap", "mask", "blend",
         "mesh_attribute", "volume", "envmap")


def _images(root, seed=0):
    """The float and 8-bit images the scenes read, from a seed."""
    rng = np.random.default_rng(seed)
    env = (rng.random((16, 32, 3)) * 0.5).astype(np.float32)
    env[3:5, 20:24] = 30.0                       # a bright sun region
    io_t.write_image(os.path.join(root, "sky.hdr"), env)
    return {"color": rng.random((24, 20, 3)).astype(np.float32),
            "fine": np.indices((32, 32)).sum(0).astype(np.float32) % 2,
            "normals": np.concatenate(
                [rng.uniform(0.3, 0.7, (8, 8, 2)),
                 rng.uniform(0.8, 1.0, (8, 8, 1))], -1).astype(np.float32),
            "grid": rng.random((3, 4, 5, 3)).astype(np.float32)}


def textured_dict(pkg, kind, root, size=SIZE, max_depth=2):
    """A floor and a box under a constant environment (or, for "envmap",
    the map in root/sky.hdr), with `kind`'s texture on the box or the
    floor."""
    T = pkg.ScalarTransform4f
    img = _images(root)
    box = {"type": "diffuse", "reflectance": {"type": "rgb",
                                              "value": [0.7, 0.6, 0.5]}}
    floor = {"type": "diffuse"}
    d = {"type": "scene",
         "integrator": {"type": "path", "max_depth": max_depth},
         "sensor": {"type": "perspective", "fov": 50.0,
                    "to_world": T().look_at(origin=[0.3, 1.6, 3.2],
                                            target=[0, 0, 0], up=[0, 1, 0]),
                    "film": {"width": size, "height": size},
                    "sampler": {"type": "independent", "sample_count": SPP}},
         "env": {"type": "constant",
                 "radiance": {"type": "rgb", "value": [0.9, 1.0, 1.1]}}}
    if kind == "bitmap":
        floor["reflectance"] = {"type": "bitmap", "data": img["color"],
                                "wrap_mode": "mirror",
                                "to_uv": T().scale([2.0, 3.0, 1.0])}
    elif kind == "mipmap":
        floor["reflectance"] = {"type": "bitmap", "data": img["fine"],
                                "mipmap": True}
    elif kind == "normalmap":
        box = {"type": "normalmap",
               "normalmap": {"type": "bitmap", "data": img["normals"]},
               "bsdf": {"type": "roughplastic", "alpha": 0.3}}
    elif kind == "bumpmap":
        box = {"type": "bumpmap",
               "bumpmap": {"type": "bitmap", "data": img["normals"],
                           "filter_type": "nearest"},
               "bsdf": {"type": "diffuse"}}
        floor = {"type": "bumpmap", "bsdf": {"type": "diffuse"}}
    elif kind == "mask":
        box = {"type": "mask",
               "opacity": {"type": "bitmap", "data": img["color"][..., 0],
                           "wrap_mode": "clamp", "filter_type": "nearest"},
               "bsdf": box}
    elif kind == "blend":
        box = {"type": "blendbsdf",
               "weight": {"type": "checkerboard", "resolution": 3},
               "a": {"type": "diffuse"},
               "b": {"type": "roughconductor", "alpha": 0.2}}
    elif kind == "volume":
        floor["reflectance"] = {
            "type": "volume",
            "volume": {"type": "gridvolume", "grid": img["grid"],
                       "to_world": T().translate([-1, -1, -1]).scale(2.0)}}
    elif kind == "envmap":
        d["env"] = {"type": "envmap",
                    "filename": os.path.join(root, "sky.hdr"),
                    "scale": 0.5}
    if kind == "mesh_attribute":
        v = np.array([[-1, 0, -1], [1, 0, -1], [1, 0, 1], [-1, 0, 1]], float)
        d["floor"] = {"type": "mesh", "vertices": v * 2,
                      "faces": [[0, 2, 1], [2, 0, 3]],
                      "vertex_colors": [[1, 0, 0], [0, 1, 0], [0, 0, 1],
                                        [1, 1, 0]],
                      "bsdf": {"type": "diffuse", "reflectance": {
                          "type": "mesh_attribute", "name": "vertex_color"}}}
    else:
        d["floor"] = {"type": "rectangle",
                      "to_world": T().rotate([1, 0, 0], -90).scale(2.0),
                      "bsdf": floor}
    d["box"] = {"type": "cube",
                "to_world": T().translate([0, 0.6, 0]).rotate(
                    [0, 1, 0], 30).scale(0.5),
                "bsdf": box}
    return d


def _equal_leaves(st, sj):
    at, meta_t = arrays_from_scene(st)
    aj, meta_j = arrays_from_scene(sj)
    assert sorted(at) == sorted(aj)
    for k in at:
        assert at[k].dtype == aj[k].dtype and np.array_equal(at[k], aj[k]), k
    assert meta_t == meta_j


def _assert_images_close(img_j, img_t):
    """The Cornell render's tolerance: > 99.5 % of values isclose 1e-3,
    means rtol 1e-3."""
    assert img_t.shape == img_j.shape and np.isfinite(img_t).all()
    assert float(img_t.max()) > 0
    assert np.isclose(img_t, img_j, rtol=1e-3, atol=1e-3).mean() > 0.995
    assert np.allclose(img_t.mean(), img_j.mean(), rtol=1e-3)


@pytest.mark.parametrize("kind", KINDS)
def test_textured_scene_matches_jax(tmp_path, kind):
    """The loaded leaves bit-equal to JAX's, and a 16^2 render (4 spp,
    max_depth 2) per pixel against JAX's."""
    sj = mj.load_dict(textured_dict(mj, kind, str(tmp_path)))
    st = mt.load_dict(textured_dict(mt, kind, str(tmp_path)), device="cpu")
    _equal_leaves(st, sj)
    assert (st.face_colors is not None) == (kind == "mesh_attribute")
    with jax.disable_jit():
        img_j, rays_j = mj.render_with_stats(sj, seed=3)
    img_t, rays_t = mt.render_with_stats(st, seed=3)
    _assert_images_close(np.asarray(img_j), img_t.numpy())
    assert abs(rays_t - float(rays_j)) <= 1e-3 * float(rays_j)


def test_textured_cornell_xml_matches_jax(tmp_path):
    """chip_smoke's textured Cornell (EXR, PNG and PFM files, every wrap
    mode and filter, a mipmapped floor) written by the port's write_file
    and read back by each package's load_file: the leaves bit-equal, a
    16^2 render (prb primal, 4 spp, max_depth 2) per pixel, and the JAX
    scene's leaves carried into the port render the same image."""
    chip_smoke.write_cornell_textures(str(tmp_path), 32)
    path = chip_smoke.textured_cornell_xml(mt, str(tmp_path), SIZE, SIZE,
                                           max_depth=2, spp=SPP)
    sj, st = mj.load_file(path), mt.load_file(path, device="cpu")
    _equal_leaves(st, sj)
    assert len(st.textures) == 5 and st.bsdf_types[-3:] == (9, 8, 11)
    with jax.disable_jit():
        img_j = np.asarray(mj.render(sj, seed=5))
    img_t = mt.render(st, seed=5).numpy()
    _assert_images_close(img_j, img_t)
    carried = scene_from_arrays(*arrays_from_scene(sj), device="cpu")
    assert torch.equal(mt.render(carried, seed=5), torch.as_tensor(img_t))


def test_envmap_file_and_vol_grid_match_jax(tmp_path):
    """The envmap scene written by the port's write_file with its map
    named relative to the file: each package's load_file gives the same
    leaves (the map's tables included). A volume texture whose grid is a
    ``.vol`` file: load_dict's leaves likewise."""
    from mitsuba3_tpu_torch.utils import vol_io, xml as xml_t
    d = textured_dict(mt, "envmap", str(tmp_path))
    d["env"]["filename"] = "sky.hdr"
    path = str(tmp_path / "envmap.xml")
    xml_t.write_file(d, path)
    st = mt.load_file(path, device="cpu")
    _equal_leaves(st, mj.load_file(path))
    assert tuple(st.env_data.shape) == (16, 32, 3)

    grid = str(tmp_path / "grid.vol")
    vol_io.write_vol(grid, _images(str(tmp_path))["grid"])

    def make(pkg):
        d = textured_dict(pkg, "volume", str(tmp_path))
        vol = d["floor"]["bsdf"]["reflectance"]["volume"]
        vol.pop("grid")
        vol["filename"] = grid
        return d
    st = mt.load_dict(make(mt), device="cpu")
    _equal_leaves(st, mj.load_dict(make(mj)))
    assert st.texture_meta[0][0] == "3d"


def test_prb_texture_and_env_grads_match_jax(tmp_path):
    """One 8^2 scene with every texture type on diffuse surfaces (a
    mipmapped bitmap, a mirrored one, a clamped nearest one, a
    checkerboard and a volume) under an envmap read from an .hdr file,
    prb at max_depth 3, 4 spp: the gradients of mean(render) w.r.t.
    textures, env_data and bsdf_params within 1e-4 of each table's
    largest JAX gradient, every entry finite on both sides, and every
    texture's gradient nonzero."""
    names = ("textures", "env_data", "bsdf_params")
    root = str(tmp_path)

    def make(pkg):
        T = pkg.ScalarTransform4f
        d = textured_dict(pkg, "envmap", root, size=8, max_depth=3)
        d["integrator"]["type"] = "prb"
        d["floor"]["bsdf"]["reflectance"] = {
            "type": "bitmap", "mipmap": True,
            "data": np.random.default_rng(1).random((8, 8, 3))}
        d["box"]["bsdf"] = textured_dict(pkg, "bitmap", root)["floor"]["bsdf"]
        nearest = textured_dict(pkg, "mask", root)["box"]["bsdf"]["opacity"]
        for key, refl, place in (
                ("slab", nearest, T().translate([-0.9, 0.4, 0.6])),
                ("checks", {"type": "checkerboard", "resolution": 3},
                 T().translate([0.2, 0.4, 1.3])),
                ("wall", textured_dict(pkg, "volume", root)["floor"]["bsdf"][
                    "reflectance"], T().translate([0.9, 0.5, 0.2]))):
            d[key] = {"type": "rectangle", "bsdf": {
                "type": "diffuse", "reflectance": refl},
                "to_world": place.rotate([1, 0, 0], -60).scale(0.6)}
        return d

    sj = mj.load_dict(make(mj))
    st = mt.load_dict(make(mt), device="cpu")
    assert [m[:3] for m in st.texture_meta] == [
        ("repeat", "bilinear", True), ("mirror", "bilinear", False),
        ("clamp", "nearest", False), ("repeat", "bilinear", False),
        ("3d", "trilinear", False)]
    gj = _grads_jax(sj, names, SPP, 1)
    gt = _grads_port(st, names, SPP, 1)
    for k in names:
        pairs = (zip(gj[k], gt[k]) if isinstance(gt[k], tuple)
                 else [(gj[k], gt[k])])
        for a, b in pairs:
            a = np.asarray(a)
            assert np.isfinite(a).all() and np.isfinite(b.numpy()).all(), k
            np.testing.assert_allclose(b.numpy(), a, rtol=0,
                                       atol=1e-4 * np.abs(a).max() + 1e-12,
                                       err_msg=k)
    for g in gt["textures"]:
        assert float(g.abs().max()) > 0
    assert float(gt["env_data"].abs().max()) > 0


def test_prb_grad_of_some_textures_equals_theirs_of_all(tmp_path):
    """Differentiating some of a scene's textures gives each the gradient
    it gets when all are differentiated: the replay keeps every texture
    in its place."""
    chip_smoke.write_cornell_textures(str(tmp_path), 32)
    scene = mt.load_file(chip_smoke.textured_cornell_xml(
        mt, str(tmp_path), 8, 8, 3, SPP), device="cpu")

    def grads(which):
        leaves = tuple(t.detach().clone().requires_grad_(k in which)
                       for k, t in enumerate(scene.textures))
        mt.render(scene.replace(textures=leaves), seed=1).mean().backward()
        return [leaf.grad for leaf in leaves]
    every = grads(range(5))
    some = grads({1, 3})
    assert [g is None for g in some] == [True, False, True, False, True]
    for k in (1, 3):
        assert torch.equal(some[k], every[k]) and bool((some[k] != 0).any())


def _adapter_dict(pkg, root, nested):
    """8^2, prb at max_depth 2: the box a normalmap around `nested` with
    a bitmap reflectance (a roughplastic's diffuse_reflectance); beside a
    diffuse one, a mask with a bitmap opacity around a diffuse."""
    T = pkg.ScalarTransform4f
    d = textured_dict(pkg, "normalmap", root, size=8, max_depth=2)
    d["integrator"]["type"] = "prb"
    refl = {"type": "bitmap",
            "data": np.random.default_rng(2).random((6, 6, 3))}
    if nested == "diffuse":
        d["box"]["bsdf"]["bsdf"] = {"type": "diffuse", "reflectance": refl}
        d["veil"] = {"type": "rectangle", "bsdf": {
            "type": "mask", "bsdf": {"type": "diffuse"}, "opacity": {
                "type": "bitmap",
                "data": np.random.default_rng(3).random((5, 7))}},
            "to_world": T().translate([0.6, 1.0, 1.1]).rotate(
                [1, 0, 0], -60).scale(0.6)}
    else:
        d["box"]["bsdf"]["bsdf"]["diffuse_reflectance"] = refl
    return d


@pytest.mark.parametrize("nested", ["diffuse", "roughplastic"])
def test_prb_adapter_texture_grads_match_jax(tmp_path, nested):
    """The gradients of mean(render) w.r.t. a normalmap's normal texture,
    a bitmap reflectance nested in it (a roughplastic's
    diffuse_reflectance) and, beside a nested diffuse, a mask's bitmap
    opacity (``_adapter_dict``; 4 spp, JAX eager) within 1e-4 of each
    texture's largest JAX entry, finite and nonzero in the port. JAX's
    are finite too, but for its normal-map gradient around a
    roughplastic: NaN on most texels there (ROADMAP queue 3), so that
    texture is held on the texels where JAX's is finite."""
    sj = mj.load_dict(_adapter_dict(mj, str(tmp_path), nested))
    st = mt.load_dict(_adapter_dict(mt, str(tmp_path), nested),
                      device="cpu")
    assert len(st.textures) == (3 if nested == "diffuse" else 2)
    with jax.disable_jit():
        gj = _grads_jax(sj, ("textures",), SPP, 1)["textures"]
    gt = _grads_port(st, ("textures",), SPP, 1)["textures"]
    for k, (a, b) in enumerate(zip(gj, gt)):
        a, b = np.asarray(a), b.numpy()
        fin = np.isfinite(a)
        assert np.isfinite(b).all() and float(np.abs(b).max()) > 0, k
        if nested == "roughplastic" and k == 0:
            assert fin.any()
        else:
            assert fin.all(), k
        np.testing.assert_allclose(
            b[fin], a[fin], rtol=0, atol=1e-4 * np.abs(a[fin]).max() + 1e-12,
            err_msg=f"texture {k}")


@pytest.mark.parametrize("edit", ["texture_id", "nested_slot"])
def test_bsdf_structure_edit_through_traverse_matches_jax(tmp_path, edit):
    """bsdf_params written through traverse/update() that point the
    floor's diffuse row at the mask's opacity texture, or the mask at the
    floor's roughconductor slot: update() re-derives the textures each
    BSDF type looks up and the types each dispatch meets, and the edit
    renders as JAX's update() renders it."""
    def make(pkg):
        d = textured_dict(pkg, "mask", str(tmp_path))
        if edit == "nested_slot":
            d["floor"]["bsdf"] = {"type": "roughconductor", "alpha": 0.2}
        return d
    sj = mj.load_dict(make(mj))
    st = mt.load_dict(make(mt), device="cpu")
    floor = int(st.face_bsdf[st.face_shape == 0][0])
    rows = st.bsdf_params.numpy().copy()
    if edit == "texture_id":
        assert st.bsdf_types[floor] == 0 and rows[floor, 3] == 0
        rows[floor, 3] = 1.0
    else:
        assert st.bsdf_types[floor] == 2
        rows[st.bsdf_types.index(9), 15] = floor
    pj, pt = mj.traverse(sj), mt.traverse(st)
    pj["bsdf_params"] = rows
    pt["bsdf_params"] = rows
    sj2, st2 = pj.update(), pt.update()
    if edit == "texture_id":
        assert dict(st2.bsdf_textures)["diffuse"] == (1,)
    else:
        assert dict(st2.bsdf_reach)["mask"] == (2,)
    _equal_leaves(st2, sj2)
    with jax.disable_jit():
        img_j = np.asarray(mj.render(sj2, seed=2))
    _assert_images_close(img_j, mt.render(st2, seed=2).numpy())


def test_texture_edit_through_traverse_matches_jax(tmp_path):
    """texture{i}.data written through traverse/update(): the new texture
    renders as JAX's update() does, and, as there, the mip levels stay the
    loaded texture's."""
    sj = mj.load_dict(textured_dict(mj, "mipmap", str(tmp_path)))
    st = mt.load_dict(textured_dict(mt, "mipmap", str(tmp_path)),
                      device="cpu")
    pj, pt = mj.traverse(sj), mt.traverse(st)
    assert "texture0.data" in pt.keys()
    new = np.full((32, 32, 3), 0.3, np.float32)
    pj["texture0.data"] = new
    pt["texture0.data"] = new
    sj2, st2 = pj.update(), pt.update()
    assert np.array_equal(st2.textures[0].numpy(), new)
    assert all(torch.equal(a, b) for a, b in zip(st2.texture_mips[0],
                                                 st.texture_mips[0]))
    _equal_leaves(st2, sj2)
    with jax.disable_jit():
        img_j = np.asarray(mj.render(sj2, seed=2))
    _assert_images_close(img_j, mt.render(st2, seed=2).numpy())


def test_serialized_vertex_colors_match_jax(tmp_path):
    """A .serialized mesh's vertex colors (and a mesh dict's) reach
    face_colors as JAX's loader puts them there, padding included."""
    v = np.array([[-1, 0, -1], [1, 0, -1], [1, 0, 1], [-1, 0, 1]], float)
    colors = np.array([[1, 0, 0], [0, 1, 0], [0, 0, 1], [1, 1, 0]], float)
    path = str(tmp_path / "quad.serialized")
    ser_j.write_serialized(path, v, np.array([[0, 2, 1], [2, 0, 3]]),
                           colors=colors)

    def make(pkg):
        d = textured_dict(pkg, "mesh_attribute", str(tmp_path))
        d["quad"] = {"type": "serialized", "filename": path,
                     "bsdf": d["floor"]["bsdf"]}
        return d
    st = mt.load_dict(make(mt), device="cpu")
    _equal_leaves(st, mj.load_dict(make(mj)))
    assert st.face_colors.shape == (st.faces.shape[0], 3, 3)


@pytest.mark.parametrize("where,spec,what", [
    # principled's base_color texture loads; its other parameters take
    # none
    ("floor", {"type": "principled", "roughness": {
        "type": "bitmap", "data": np.ones((2, 2, 3))}}, "principled"),
    ("floor", {"type": "conductor", "specular_reflectance": {
        "type": "bitmap", "data": np.ones((2, 2, 3))}}, "specular"),
    ("floor", {"type": "diffuse", "reflectance": {
        "type": "mesh_attribute", "name": "uv"}}, "mesh_attribute"),
    ("floor", {"type": "diffuse", "reflectance": {
        "type": "bitmap", "data": np.ones((2, 2, 3)), "format": "x"}},
     "format"),
    ("floor", {"type": "mask", "opacity": {
        "type": "mesh_attribute"}, "bsdf": {"type": "diffuse"}},
     "mesh_attribute"),
    ("env", {"type": "envmap", "filename": "sky.exr",
             "to_world": np.eye(4)}, "to_world"),
    ("floor", {"type": "diffuse", "reflectance": {
        "type": "bitmap", "filename": "a.jpg"}}, "JPG"),
])
def test_refused_textures_raise(tmp_path, where, spec, what):
    """What the JAX loader ignores, crashes on or reads through PIL is
    refused by name."""
    d = textured_dict(mt, "bitmap", str(tmp_path))
    if where == "floor":
        d["floor"]["bsdf"] = spec
    else:
        d["env"] = spec
    with pytest.raises(NotImplementedError, match=what):
        mt.load_dict(d, device="cpu")
