"""Port parity for scene files: ``utils/xml.py``'s dicts (defaults,
``$param``, ``<include>``, ``<ref>`` with an inferred slot, the version-1
upgrade, a ``write_file`` round trip) equal JAX's; the OBJ, PLY (ascii
and binary, float and double, normals and each uv spelling) and
``.serialized`` readers return JAX's arrays; ``load_file`` scenes equal
JAX's leaf for leaf through ``convert.py`` (a file above 8192 faces with
``MI3T_ACCEL`` set on both sides, and a mesh with shading normals under a
non-uniform transform); and the loader's device rule and refusals hold
for files too. Every file is written by the test."""
import struct

import numpy as np
import pytest
import torch

import mitsuba3_tpu as mj
from mitsuba3_tpu.shapes import loaders as loaders_j
from mitsuba3_tpu.shapes import serialized_io as ser_j
from mitsuba3_tpu.utils import xml as xml_j

import chip_smoke
import mitsuba3_tpu_torch as mt
from mitsuba3_tpu_torch.convert import arrays_from_scene
from mitsuba3_tpu_torch.shapes import loaders as loaders_t
from mitsuba3_tpu_torch.shapes import serialized_io as ser_t
from mitsuba3_tpu_torch.utils import xml as xml_t

torch.set_num_threads(1)


def _plain(v):
    """A parsed dict with each package's Transform4f as its matrix."""
    if isinstance(v, dict):
        return {k: _plain(x) for k, x in v.items()}
    if hasattr(v, "matrix"):
        return ("Transform4f", np.asarray(v.matrix).tolist())
    return v


MAIN = """<scene version="3.0.0">
  <default name="depth" value="5"/>
  <default name="albedo" value="0.25"/>
  <include filename="parts/materials.xml"/>
  <integrator type="path"><integer name="max_depth" value="$depth"/>
    <boolean name="hide_emitters" value="true"/></integrator>
  <medium type="homogeneous" id="fog"><float name="sigma_t" value="0.5"/>
  </medium>
  <bsdf type="twosided" id="paint"><bsdf type="diffuse"/></bsdf>
  <shape type="obj" id="wall"><string name="filename" value="wall.obj"/>
    <ref id="paint"/><ref id="fog"/>
    <transform name="to_world"><translate x="1" z="-2"/>
      <rotate y="1" angle="30"/><scale value="2"/>
      <matrix value="1 0 0 0.5 0 1 0 0 0 0 1 0 0 0 0 1"/></transform>
  </shape>
  <shape type="ply"><string name="filename" value="$mesh"/>
    <bsdf type="diffuse"><spectrum name="reflectance" value="$albedo"/></bsdf>
    <point name="center" x="1" y="2"/><vector name="axis" value="0 0 1"/>
  </shape>
</scene>
"""
MATERIALS = """<scene version="3.0.0">
  <bsdf type="roughconductor" id="gold"><float name="alpha" value="0.2"/>
    <rgb name="eta" value="0.2, 0.9, 1.1"/>
    <spectrum name="k" value="400:1.0, 700:2.0"/></bsdf>
  <sensor type="thinlens"><float name="aperture_radius" value="0.1"/>
    <transform name="to_world"><lookat origin="0, 0, 4" target="0, 0, 0"
      up="0, 1, 0"/></transform>
    <film type="hdrfilm"><integer name="width" value="32"/>
      <rfilter type="tent"/></film>
    <sampler type="ldsampler"><integer name="sample_count" value="8"/>
    </sampler>
  </sensor>
</scene>
"""
V1 = """<scene version="0.6.0">
  <integrator type="path"><integer name="maxDepth" value="3"/></integrator>
  <bsdf type="diffuse" id="m"><rgb name="diffuseReflectance" value="0.3"/>
    <float name="uoffset" value="0.5"/><float name="vscale" value="2"/>
  </bsdf>
  <shape type="cube"><boolean name="flipNormals" value="false"/>
    <ref id="m"/></shape>
</scene>
"""


def test_parse_file_matches_jax(tmp_path):
    """``<default>``, ``$param`` (from the caller too), ``<include>``
    relative to the file, ``<ref>`` slots inferred from the target's kind
    (a BSDF's is ``bsdf``, a medium's ``interior``), transform chains,
    each value tag, relative filenames made absolute."""
    (tmp_path / "parts").mkdir()
    (tmp_path / "parts" / "materials.xml").write_text(MATERIALS)
    (tmp_path / "main.xml").write_text(MAIN)
    path = str(tmp_path / "main.xml")
    dt = xml_t.parse_file(path, {"mesh": "blob.ply"})
    dj = xml_j.parse_file(path, {"mesh": "blob.ply"})
    assert _plain(dt) == _plain(dj)
    assert dt["integrator"]["max_depth"] == 5
    assert dt["wall"]["bsdf"] == {"type": "ref", "id": "paint"}
    assert dt["wall"]["interior"] == {"type": "ref", "id": "fog"}
    assert dt["gold"]["type"] == "roughconductor"
    assert dt["shape"]["filename"] == str(tmp_path / "blob.ply")
    assert dt["shape"]["bsdf"]["reflectance"] == {"type": "uniform",
                                                  "value": 0.25}
    assert dt["sensor"]["sampler"]["type"] == "ldsampler"
    with pytest.raises(ValueError, match="Unresolved"):
        xml_t.parse_file(path)


def test_parse_string_v1_upgrade_matches_jax():
    """A version-0.6 scene: camelCase names, a diffuse's
    diffuse_reflectance and uoffset/vscale upgraded as JAX does."""
    dt, dj = xml_t.parse_string(V1), xml_j.parse_string(V1)
    assert _plain(dt) == _plain(dj)
    assert dt["integrator"] == {"type": "path", "max_depth": 3}
    assert "reflectance" in dt["m"] and "to_uv" in dt["m"]
    assert dt["shape"]["flip_normals"] is False
    assert xml_t._camel_to_underscore("sampleCount") == "sample_count"
    assert xml_t._camel_to_underscore("toWorldHDR") == "to_world_hdr"


def test_write_file_round_trip(tmp_path):
    """write_file of the Cornell box dict and parse_file of the result:
    the port's file parses to JAX's parse of JAX's file, and both load
    to equal leaves."""
    pt, pj = str(tmp_path / "t.xml"), str(tmp_path / "j.xml")
    xml_t.write_file(mt.cornell_box(8, 8, max_depth=2), pt)
    xml_j.write_file(mj.cornell_box(8, 8, max_depth=2), pj)
    dt, dj = xml_t.parse_file(pt), xml_j.parse_file(pj)
    assert _plain(dt) == _plain(dj)
    at, _ = arrays_from_scene(mt.load_dict(dt, device="cpu"))
    aj, _ = arrays_from_scene(mj.load_dict(dj))
    assert sorted(at) == sorted(aj)
    for k in at:
        assert np.array_equal(at[k], aj[k]), k
    with pytest.raises(ValueError, match="cannot serialize"):
        xml_t.write_file({"type": "scene", "m": {
            "type": "mesh", "vertices": np.zeros((3, 3))}}, pt)


def _mesh(np_rng, nv=9):
    v = np_rng.normal(size=(nv, 3))
    n = np_rng.normal(size=(nv, 3))
    n /= np.linalg.norm(n, axis=1, keepdims=True)
    uv = np_rng.uniform(size=(nv, 2))
    return v, n, uv


def _same(a, b):
    """Equal arrays of equal dtype, or both None."""
    if a is None or b is None:
        return a is None and b is None
    return a.dtype == b.dtype and a.shape == b.shape and np.array_equal(a, b)


def _write_obj(path, v, n, uv):
    """An OBJ of a quad, a triangle by negative indices, a corner shared
    and one split by another uv, and a pentagon; `n` None: no normals."""
    lines = [f"v {x!r} {y!r} {z!r}" for x, y, z in v.tolist()]
    lines += [f"vt {a!r} {b!r}" for a, b in uv.tolist()]
    if n is not None:
        lines += [f"vn {a!r} {b!r} {c!r}" for a, b, c in n.tolist()]
    faces = [((1, 1), (2, 2), (3, 3), (4, 4)), ((-1, -1), (-2, -2), (-3, -3)),
             ((1, 1), (3, 3), (5, 5)),
             ((1, 2), (6, 6), (7, 7), (8, 8), (9, 9))]
    for face in faces:
        lines.append("f " + " ".join(
            f"{a}/{b}/{a}" if n is not None else f"{a}/{b}" for a, b in face))
    lines += ["o rest", "# a comment"]
    path.write_text("\n".join(lines) + "\n")


def _write_ply(path, v, n, uv, fmt, dtype, uv_names, polys):
    props = [("x", "y", "z")] + ([("nx", "ny", "nz")] if n is not None
                                 else []) + [uv_names]
    cols = np.concatenate([v] + ([n] if n is not None else []) + [uv], 1)
    names = [c for group in props for c in group]
    ptype = {"<f4": "float", "<f8": "double"}[dtype]
    head = (f"ply\nformat {fmt} 1.0\ncomment test\nelement vertex {len(v)}\n"
            + "".join(f"property {ptype} {c}\n" for c in names)
            + f"element face {len(polys)}\n"
            "property list uchar int vertex_indices\nend_header\n")
    if fmt == "ascii":
        body = "".join(" ".join(repr(float(x)) for x in row) + "\n"
                       for row in cols)
        body += "".join(f"{len(p)} " + " ".join(map(str, p)) + "\n"
                        for p in polys)
        path.write_bytes((head + body).encode())
        return
    body = np.ascontiguousarray(cols, dtype).tobytes()
    for p in polys:
        body += struct.pack(f"<B{len(p)}i", len(p), *p)
    path.write_bytes(head.encode() + body)


TRIS = [(0, 1, 2), (2, 3, 4), (5, 6, 7), (1, 7, 8)]
MIXED = [(0, 1, 2, 3), (2, 3, 4), (4, 5, 6, 7, 8)]
PLY_CASES = {
    "ascii_float_normals_uv": ("ascii", "<f4", True, ("u", "v"), MIXED),
    "binary_float_st": ("binary_little_endian", "<f4", False, ("s", "t"),
                        TRIS),
    "binary_double_normals_texture_uv": ("binary_little_endian", "<f8",
                                         True, ("texture_u", "texture_v"),
                                         TRIS),
    "binary_double_mixed_polygons": ("binary_little_endian", "<f8", False,
                                     ("u", "v"), MIXED),
}


@pytest.mark.parametrize("case", sorted(PLY_CASES))
def test_load_ply_matches_jax(np_rng, tmp_path, case):
    fmt, dtype, normals, uv_names, polys = PLY_CASES[case]
    v, n, uv = _mesh(np_rng)
    path = tmp_path / "m.ply"
    _write_ply(path, v, n if normals else None, uv, fmt, dtype, uv_names,
               polys)
    out_t, out_j = loaders_t.load_ply(str(path)), loaders_j.load_ply(str(path))
    for a, b in zip(out_t, out_j):
        assert _same(a, b)
    assert out_t[1].shape[0] == sum(len(p) - 2 for p in polys)


@pytest.mark.parametrize("normals", ["normals", "zero_normals",
                                     "no_normals"])
def test_load_obj_matches_jax(np_rng, tmp_path, normals):
    """Corners split on their spec string, fan triangulation, negative
    indices, no v-flip; all-zero normals are dropped."""
    v, n, uv = _mesh(np_rng)
    path = tmp_path / "m.obj"
    _write_obj(path, v, None if normals == "no_normals"
               else n * (normals == "normals"), uv)
    out_t, out_j = loaders_t.load_obj(str(path)), loaders_j.load_obj(str(path))
    for a, b in zip(out_t, out_j):
        assert _same(a, b)
    assert (out_t[3] is None) == (normals != "normals")
    assert out_t[1].shape == (7, 3)


@pytest.mark.parametrize("parts", ["plain", "normals_uvs_colors"])
def test_serialized_matches_jax(np_rng, tmp_path, parts):
    """write_serialized (version 3, zlib) by each package, read by both."""
    v, n, uv = _mesh(np_rng)
    f = np.asarray(TRIS)
    extra = ({} if parts == "plain"
             else {"normals": n, "uvs": uv, "colors": np.abs(n)})
    pt, pj = str(tmp_path / "t.serialized"), str(tmp_path / "j.serialized")
    ser_t.write_serialized(pt, v, f, **extra)
    ser_j.write_serialized(pj, v, f, **extra)
    assert open(pt, "rb").read() == open(pj, "rb").read()
    rt, rj = ser_t.read_serialized(pj), ser_j.read_serialized(pt)
    assert sorted(rt) == sorted(rj)
    for k in rt:
        assert _same(rt[k], rj[k]), k
    with pytest.raises(ValueError, match="out of range"):
        ser_t.read_serialized(pt, shape_index=1)


def _equal_leaves(st, sj):
    at, mt_ = arrays_from_scene(st)
    aj, mj_ = arrays_from_scene(sj)
    assert sorted(at) == sorted(aj)
    for k in at:
        assert at[k].dtype == aj[k].dtype and np.array_equal(at[k], aj[k]), k
    assert mt_ == mj_


def test_load_file_terrain_matches_jax(tmp_path, monkeypatch):
    """The small terrain (8,978 faces) as a binary PLY and XML file: the
    port's load_file leaves (cellserve arrays included, MI3T_ACCEL=cells
    on both sides) equal JAX's and the port's load_dict of the dict."""
    monkeypatch.setenv("MI3T_ACCEL", "cells")
    d = chip_smoke.small_terrain_dict(mt.ScalarTransform4f)
    path = chip_smoke.terrain_xml(str(tmp_path), d, "terrain")
    st = mt.load_file(path, device="cpu")
    assert st.accel is not None and st.faces.shape[0] > 8192
    _equal_leaves(st, mj.load_file(path))
    _equal_leaves(st, mt.load_dict(d, device="cpu"))


def test_load_file_normals_and_spectra_match_jax(np_rng, tmp_path):
    """A Cornell file (OBJ walls, batch sensor, crop) plus a PLY mesh with
    shading normals under a non-uniform, rotated to_world, a serialized
    mesh, a thinlens-free ``<spectrum>`` color and a uniform emitter
    radiance: leaves equal JAX's; face_normals carry the normals through
    the inverse transpose."""
    base = chip_smoke.cornell_xml(mt, str(tmp_path), 16, 16, spp=4,
                                  sampler="orthogonal", sensor="batch",
                                  rfilter="box", crop=(10, 6, 3, 5))
    v, n, uv = _mesh(np_rng)
    _write_ply(tmp_path / "blob.ply", 0.2 * v, n, uv, "binary_little_endian",
               "<f4", ("u", "v"), TRIS)
    ser_t.write_serialized(str(tmp_path / "blob.serialized"), 0.1 * v,
                           np.asarray(TRIS), normals=n)
    extra = """  <shape type="ply"><string name="filename" value="blob.ply"/>
    <transform name="to_world"><scale value="1, 0.5, 2"/>
      <rotate z="1" angle="40"/><translate value="0, 0.2, 0"/></transform>
    <bsdf type="diffuse"><spectrum name="reflectance" value="0.5"/></bsdf>
    <emitter type="area"><spectrum name="radiance" value="2"/></emitter>
  </shape>
  <shape type="serialized"><string name="filename" value="blob.serialized"/>
    <integer name="shape_index" value="0"/></shape>
</scene>
"""
    text = open(base).read().replace("</scene>\n", extra)
    path = tmp_path / "scene.xml"
    path.write_text(text)
    st = mt.load_file(str(path), device="cpu")
    assert isinstance(st.sensor, tuple) and len(st.sensor) == 2
    assert st.film.full_width == 16 and st.film.width == 10
    ns = st.face_normals.numpy()
    assert (np.abs(ns).sum(axis=(1, 2)) > 0).sum() == 2 * len(TRIS)
    _equal_leaves(st, mj.load_file(str(path)))


def test_load_file_device_rule_and_refusals(tmp_path, monkeypatch):
    """load_file and load_string put the scene on the card by default and
    raise without one (never falling back); plugins that stay unported
    raise NotImplementedError naming them."""
    path = chip_smoke.cornell_xml(mt, str(tmp_path), 8, 8, max_depth=2)
    monkeypatch.chdir(tmp_path)          # load_string's relative files
    text = open(path).read()
    if torch.cuda.is_available():
        assert mt.load_file(path).device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="CUDA"):
            mt.load_file(path)
        with pytest.raises(RuntimeError, match="CUDA"):
            mt.load_string(text)
    assert mt.load_string(text, device="cpu").device.type == "cpu"
    for old, new, name in (
            ('<rfilter type="gaussian"/>',
             '<rfilter type="gaussian"><float name="stddev" value="0.3"/>'
             '</rfilter>', "rfilter parameters"),
            # a sampled spectrum where a scalar is read
            ('<bsdf type="diffuse" id="white"><rgb name="reflectance" '
             'value="0.885809, 0.698859, 0.666422"/>',
             '<bsdf type="principled" id="white"><spectrum '
             'name="roughness" value="400:0.2, 700:0.8"/>',
             "'irregular'"),
            ('<sampler type="independent">',
             '<sampler type="independent"><integer name="seed" value="3"/>',
             r"sampler properties \['seed'\]")):
        assert old in text
        with pytest.raises(NotImplementedError, match=name):
            mt.load_string(text.replace(old, new, 1), device="cpu")
