"""Mitsuba XML scene files — counterpart of ``mitsuba3_tpu/utils/xml.py``
(the XML front-end of src/core/parser.cpp).

Host-side: lowers the XML DOM to the nested dict that ``load_dict``
takes. Supports ``<default>`` declarations and ``$key`` substitution,
``<ref id>`` (a nameless ref's slot inferred from its target's kind),
nested ``<transform>`` chains, ``<include>``, the upgrade of version-1
scenes (camelCase names, ``uoffset``/``uscale``) and relative
``filename``s resolved against the file's directory. ``load_file`` and
``load_string`` put the scene on the card unless the caller passes
``device="cpu"``; ``write_file`` writes a scene dict back as XML (a
BSDF registered with ``register_bsdf`` as a ``<bsdf>``).
"""
from __future__ import annotations

import os
import xml.etree.ElementTree as ET

import numpy as np

from ..bsdfs import custom_type
from ..core.transform import Transform4f
from ..loader import BSDF_NAMES as _BSDF_TYPES
from ..loader import load_dict

# the JAX loader's plugin names that the parser and the writer sort by
_MEDIUM_TYPES = ("homogeneous", "heterogeneous")
_SHAPE_TYPES = ("rectangle", "cube", "sphere", "disk", "cylinder", "obj",
                "ply", "mesh", "serialized", "linearcurve", "bsplinecurve",
                "sdfgrid", "ellipsoids", "ellipsoidsmesh")

_VALUE_TAGS = {"integer": int, "float": float, "boolean": None,
               "string": str}


def _parse_vec(text):
    parts = [p for p in text.replace(",", " ").split() if p]
    vals = [float(p) for p in parts]
    return vals[0] if len(vals) == 1 else vals


def _subst(value: str, params: dict) -> str:
    """$key substitution (parser.cpp:parameter resolution)."""
    if "$" not in value:
        return value
    for k, v in sorted(params.items(), key=lambda kv: -len(kv[0])):
        value = value.replace("$" + k, str(v))
    if "$" in value:
        raise ValueError(f"Unresolved scene parameter in {value!r}")
    return value


def _parse_transform(node, params) -> Transform4f:
    t = Transform4f()
    for child in node:
        tag = child.tag
        g = lambda a, d=None: (
            _subst(child.get(a), params) if child.get(a) is not None else d)
        if tag == "translate":
            v = g("value")
            vec = (_parse_vec(v) if v is not None else
                   [float(g("x", 0)), float(g("y", 0)), float(g("z", 0))])
            t = Transform4f().translate(vec) @ t
        elif tag == "scale":
            v = g("value")
            if v is not None:
                vec = _parse_vec(v)
            else:
                vec = [float(g("x", 1)), float(g("y", 1)), float(g("z", 1))]
            t = Transform4f().scale(vec) @ t
        elif tag == "rotate":
            v = g("value")
            axis = (_parse_vec(v) if v is not None else
                    [float(g("x", 0)), float(g("y", 0)), float(g("z", 0))])
            t = Transform4f().rotate(axis, float(g("angle", 0))) @ t
        elif tag in ("lookat", "look_at"):
            t = Transform4f().look_at(
                origin=_parse_vec(g("origin")),
                target=_parse_vec(g("target")),
                up=_parse_vec(g("up", "0 1 0"))) @ t
        elif tag == "matrix":
            vals = [float(x) for x in _subst(child.get("value"),
                                             params).split()]
            mtx = np.asarray(vals, np.float64).reshape(4, 4)
            t = Transform4f(mtx) @ t
        else:
            raise ValueError(f"Unknown transform op <{tag}>")
    return t


def _node_to_dict(node, params, base_dir, named):
    """Object element (scene/bsdf/shape/...) -> plugin dict."""
    d = {"type": _subst(node.get("type", ""), params)}
    anon = 0
    for child in node:
        tag = child.tag
        name = child.get("name")
        if tag == "default":
            params.setdefault(child.get("name"), child.get("value"))
            continue
        if tag == "include":
            sub = parse_file(os.path.join(
                base_dir, _subst(child.get("filename"), params)), params)
            for k, v in sub.items():
                if k != "type":
                    d[k] = v
            continue
        if tag in _VALUE_TAGS:
            val = _subst(child.get("value"), params)
            if tag == "integer":
                d[name] = int(float(val))
            elif tag == "float":
                d[name] = float(val)
            elif tag == "boolean":
                d[name] = val.lower() in ("true", "1")
            else:
                d[name] = val
        elif tag == "rgb":
            d[name] = {"type": "rgb",
                       "value": _parse_vec(_subst(child.get("value"),
                                                  params))}
        elif tag == "spectrum":
            val = _subst(child.get("value"), params)
            d[name] = {"type": "uniform", "value": _parse_vec(val)} \
                if "," not in val and ":" not in val else \
                {"type": "irregular", "value": val}
        elif tag in ("point", "vector"):
            v = child.get("value")
            if v is not None:
                d[name] = _parse_vec(_subst(v, params))
            else:
                d[name] = [float(_subst(child.get(a, "0"), params))
                           for a in "xyz"]
        elif tag == "transform":
            d[name] = _parse_transform(child, params)
        elif tag == "ref":
            rid = child.get("id")
            if name is None:
                # infer the slot from the referenced object's category
                # (parser.cpp resolves refs by type at instantiation)
                tgt = named.get(rid, {})
                if tgt.get("type") in _BSDF_TYPES:
                    name = "bsdf"
                elif tgt.get("type") in _MEDIUM_TYPES:
                    name = "interior"
                else:
                    name = f"_ref_{anon}"
                    anon += 1
            d[name] = {"type": "ref", "id": rid}
        else:
            # nested object (bsdf/emitter/film/sampler/texture/medium/...)
            sub = _node_to_dict(child, params, base_dir, named)
            obj_id = child.get("id")
            if obj_id:
                named[obj_id] = sub
            key = name or child.get("id") or tag
            while key in d:
                anon += 1
                key = f"{tag}_{anon}"
            d[key] = sub
    return d


def parse_file(path: str, params: dict | None = None) -> dict:
    """Parse a mitsuba XML scene file into a load_dict-compatible dict."""
    root = ET.parse(path).getroot()
    base_dir = os.path.dirname(os.path.abspath(path))
    return _parse_root(root, base_dir, params)


def parse_string(text: str, params: dict | None = None) -> dict:
    """Parse a mitsuba XML scene from a string (parser.cpp load_string);
    relative filenames resolve against the current directory."""
    return _parse_root(ET.fromstring(text), os.getcwd(), params)


def _parse_root(root, base_dir: str, params: dict | None) -> dict:
    params = dict(params or {})
    if root.tag != "scene":
        raise ValueError(f"Root element must be <scene>, got <{root.tag}>")
    # first pass: collect <default>s so later $refs resolve
    for child in root:
        if child.tag == "default":
            params.setdefault(child.get("name"), child.get("value"))
    named: dict = {}
    d = _node_to_dict(root, params, base_dir, named)
    d["type"] = "scene"
    # resolve filename-relative resources
    _absolutize_filenames(d, base_dir)
    # legacy-version upgrade pass (parser.cpp:transform_upgrade)
    ver = (root.get("version") or "3.0.0").split(".")
    try:
        major = int(ver[0])
    except ValueError:
        major = 3
    if major < 2:
        _upgrade_v1(d)
    return d


def _camel_to_underscore(name: str) -> str:
    """camelCase -> underscore_case (parser.cpp:1166); runs of capitals
    collapse to one lowercase group."""
    out = []
    i = 0
    while i < len(name):
        c = name[i]
        if i > 0 and name[i - 1].islower() and c.isupper():
            out.append("_")
            out.append(c.lower())
            while i + 1 < len(name) and name[i + 1].isupper():
                i += 1
                out.append(name[i].lower())
        else:
            out.append(c)
        i += 1
    return "".join(out)


def _upgrade_v1(d: dict):
    """Upgrade a parsed node dict from scene version < 2.0
    (parser.cpp:upgrade_from_v1): camelCase property names,
    diffuse_reflectance -> reflectance on diffuse BSDFs, and
    uoffset/voffset/uscale/vscale -> a to_uv transform."""
    for key in list(d.keys()):
        nk = _camel_to_underscore(key)
        if nk != key and nk not in d:
            d[nk] = d.pop(key)
    if d.get("type") == "diffuse" and "diffuse_reflectance" in d:
        d["reflectance"] = d.pop("diffuse_reflectance")
    if any(k in d for k in ("uoffset", "voffset", "uscale", "vscale")):
        ox = float(d.pop("uoffset", 0.0))
        oy = float(d.pop("voffset", 0.0))
        sx = float(d.pop("uscale", 1.0))
        sy = float(d.pop("vscale", 1.0))
        d["to_uv"] = (Transform4f().scale([sx, sy, 1.0])
                      @ Transform4f().translate([ox, oy, 0.0]))
    for v in d.values():
        if isinstance(v, dict):
            _upgrade_v1(v)


def _absolutize_filenames(d, base_dir):
    for k, v in d.items():
        if isinstance(v, dict):
            _absolutize_filenames(v, base_dir)
        elif k == "filename" and isinstance(v, str) and not os.path.isabs(v):
            d[k] = os.path.join(base_dir, v)


def load_file(path: str, device=None, **params):
    """mi.load_file (src/core/python/parser.cpp:469): the scene of an XML
    file on `device` (the card by default); `params` fill its ``$key``s."""
    return load_dict(parse_file(path, params), device=device)


def load_string(text: str, device=None, **params):
    """mi.load_string: the scene of XML source text on `device` (the card
    by default)."""
    return load_dict(parse_string(text, params), device=device)


# ---------------------------------------------------------------------------
# Scene write-back (parser.h:434-448 write_file): emit the nested-dict
# scene representation as Mitsuba XML, round-trippable through parse_file.
# ---------------------------------------------------------------------------

_SPECTRUM_TYPES = ("rgb", "uniform", "d65", "srgb", "blackbody", "regular",
                   "irregular", "rawconstant")


def _emit_value(parent, name, value):
    if isinstance(value, bool):
        ET.SubElement(parent, "boolean",
                      {"name": name, "value": str(value).lower()})
    elif isinstance(value, int):
        ET.SubElement(parent, "integer",
                      {"name": name, "value": str(value)})
    elif isinstance(value, float):
        ET.SubElement(parent, "float", {"name": name, "value": repr(value)})
    elif isinstance(value, str):
        ET.SubElement(parent, "string", {"name": name, "value": value})
    elif isinstance(value, Transform4f):
        t = ET.SubElement(parent, "transform", {"name": name})
        mtx = " ".join(repr(float(x))
                       for x in np.asarray(value.matrix).reshape(-1))
        ET.SubElement(t, "matrix", {"value": mtx})
    elif isinstance(value, (list, tuple, np.ndarray)):
        arr = np.asarray(value)
        if arr.ndim == 1 and arr.size in (1, 3):
            ET.SubElement(parent, "rgb", {
                "name": name,
                "value": ", ".join(repr(float(x)) for x in arr.reshape(-1))
            })
        else:
            raise ValueError(
                f"write_file: cannot serialize array property {name!r} "
                f"of shape {arr.shape} (in-memory data has no file form)")
    elif isinstance(value, dict):
        _emit_dict(parent, value, name)
    else:
        raise ValueError(f"write_file: unsupported property {name!r}: "
                         f"{type(value)}")


def _emit_dict(parent, d: dict, name=None):
    dtype = d.get("type")
    if dtype == "ref":
        attrs = {"id": d["id"]}
        if name:
            attrs["name"] = name
        ET.SubElement(parent, "ref", attrs)
        return
    if dtype == "rgb":
        v = np.asarray(d.get("value", 0.5), np.float64).reshape(-1)
        attrs = {"value": ", ".join(repr(float(x)) for x in v)}
        if name:
            attrs["name"] = name
        ET.SubElement(parent, "rgb", attrs)
        return
    if dtype in _SPECTRUM_TYPES:
        attrs = {"type": dtype}
        if name:
            attrs["name"] = name
        node = ET.SubElement(parent, "spectrum", attrs)
        for k, v in d.items():
            if k != "type":
                _emit_value(node, k, v)
        return
    tag_by_type = {
        "perspective": "sensor", "thinlens": "sensor",
        "orthographic": "sensor", "radiancemeter": "sensor",
        "irradiancemeter": "sensor", "distant": "sensor", "batch": "sensor",
        "area": "emitter", "point": "emitter", "constant": "emitter",
        "envmap": "emitter", "spot": "emitter", "projector": "emitter",
        "directional": "emitter", "directionalarea": "emitter",
        "sunsky": "emitter", "timed_sunsky": "emitter",
        "independent": "sampler", "stratified": "sampler",
        "multijitter": "sampler", "ldsampler": "sampler",
        "orthogonal": "sampler",
        "hdrfilm": "film", "specfilm": "film",
        "homogeneous": "medium", "heterogeneous": "medium",
        "gridvolume": "volume", "constvolume": "volume",
    }
    if dtype in _SHAPE_TYPES:
        tag = "shape"
    elif dtype in _BSDF_TYPES or custom_type(dtype) is not None:
        tag = "bsdf"
    elif dtype in ("isotropic", "hg", "rayleigh", "sggx", "tabphase",
                   "blendphase"):
        tag = "phase"
    elif dtype in ("bitmap", "checkerboard", "mesh_attribute"):
        tag = "texture"
    else:
        tag = tag_by_type.get(dtype, "integrator" if name == "integrator"
                              or dtype in ("path", "direct", "volpath",
                                           "volpathmis", "prb",
                                           "prbvolpath", "aov", "depth",
                                           "moment", "stokes", "ptracer",
                                           "prb_projective",
                                           "direct_projective",
                                           "volprim_rf_basic")
                              else None)
    if tag is None:
        raise ValueError(f"write_file: unknown node type {dtype!r}")
    attrs = {"type": dtype}
    if name and tag in ("bsdf", "texture", "medium", "volume", "phase",
                        "film", "sampler"):
        attrs["name"] = name
    node = ET.SubElement(parent, tag, attrs)
    for k, v in d.items():
        if k == "type":
            continue
        if k == "film" and isinstance(v, dict) and "type" not in v:
            v = {"type": "hdrfilm", **v}
        if k == "rfilter" and isinstance(v, dict):
            ET.SubElement(node, "rfilter", {"type": v.get("type", "box")})
            continue
        _emit_value(node, k, v)


def write_file(scene_dict: dict, path: str):
    """Serialize a scene dict as Mitsuba XML (the parser.write_file
    round-trip role; in-memory array payloads are rejected since XML has
    no representation for them)."""
    if scene_dict.get("type") != "scene":
        raise ValueError("write_file expects a scene dict")
    root = ET.Element("scene", {"version": "3.0.0"})
    for key, val in scene_dict.items():
        if key == "type" or not isinstance(val, dict):
            continue
        before = len(root)
        _emit_dict(root, val, key if key == "integrator" else None)
        # top-level nodes keep their dict key as the id (ref targets)
        if len(root) > before:
            root[-1].set("id", key)
    tree = ET.ElementTree(root)
    ET.indent(tree)
    tree.write(path, encoding="unicode", xml_declaration=True)
