"""Host-side texture loading — counterpart of
``mitsuba3_tpu/render/texture_io.py`` (src/textures/bitmap.cpp construction
and checkerboard.cpp, lowered to plain [H, W, 3] float32 arrays while the
scene dict is lowered).

``load_texture_spec`` returns a ``Texture``: the array and its metadata
``(wrap_mode, filter_type, mipmap, (sx, sy, ox, oy))``, the tuple the JAX
package carries on its ``TexArray`` into the scene's ``texture_meta``.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from ..core.transform import as_transform
from ..utils import image_io

WRAP_MODES = ("repeat", "clamp", "mirror")
FILTER_TYPES = ("bilinear", "nearest")
_META_KEYS = ("wrap_mode", "filter_type", "mipmap", "to_uv")
TEXTURE_KEYS = {
    "bitmap": ("type", "filename", "data", "raw") + _META_KEYS,
    "checkerboard": ("type", "color0", "color1", "resolution") + _META_KEYS,
}


@dataclasses.dataclass(frozen=True)
class Texture:
    """A texture's array ([H, W, 3], or [D, H, W, 3] for a ``volume``) and
    its metadata tuple (``texture_meta`` entry)."""
    data: np.ndarray
    meta: tuple


def _uv_transform(spec):
    """'to_uv' -> (sx, sy, ox, oy) (bitmap.cpp m_transform; only the
    axis-aligned scale and offset, the upgrade path's uoffset/uscale)."""
    t = spec.get("to_uv")
    if t is None:
        return (1.0, 1.0, 0.0, 0.0)
    m = np.asarray(as_transform(t).matrix, np.float64)
    return (float(m[0, 0]), float(m[1, 1]), float(m[0, 3]),
            float(m[1, 3]))


def _with_meta(arr, spec) -> Texture:
    wrap = str(spec.get("wrap_mode", "repeat"))
    filt = str(spec.get("filter_type", "bilinear"))
    if wrap not in WRAP_MODES:
        raise ValueError(f"texture wrap_mode {wrap!r} (one of {WRAP_MODES})")
    if filt not in FILTER_TYPES:
        raise ValueError(
            f"texture filter_type {filt!r} (one of {FILTER_TYPES})")
    out = np.ascontiguousarray(arr, np.float32)
    if out.ndim != 3 or out.shape[-1] != 3:
        raise NotImplementedError(
            f"a texture of shape {out.shape} (a {out.shape[-1]}-channel "
            f"image) is not ported to mitsuba3_tpu_torch; textures are "
            f"gray or RGB")
    return Texture(out, (wrap, filt, bool(spec.get("mipmap", False)),
                         _uv_transform(spec)))


def _color(v, default):
    """A checkerboard color: a number, an RGB triple or an ``rgb`` dict."""
    if v is None:
        v = default
    if isinstance(v, dict):
        if v.get("type") != "rgb":
            raise NotImplementedError(
                f"a checkerboard color of type {v.get('type')!r} is not "
                f"ported to mitsuba3_tpu_torch")
        v = v["value"]
    c = np.asarray(v, np.float32).reshape(-1)
    return np.repeat(c, 3) if c.size == 1 else c


def load_texture_spec(spec: dict) -> Texture:
    ttype = spec.get("type")
    if ttype not in TEXTURE_KEYS:
        raise NotImplementedError(
            f"texture type {ttype!r} is not ported to mitsuba3_tpu_torch")
    extra = sorted(set(spec) - set(TEXTURE_KEYS[ttype]))
    if extra:
        raise NotImplementedError(
            f"{ttype} properties {extra} are not ported to "
            f"mitsuba3_tpu_torch")
    if ttype == "checkerboard":
        c0 = _color(spec.get("color0"), 0.4)
        c1 = _color(spec.get("color1"), 0.2)
        res = int(spec.get("resolution", 2))  # 2x2 = one checker period
        tex = np.zeros((res * 2, res * 2, 3), np.float32)
        yy, xx = np.meshgrid(np.arange(res * 2), np.arange(res * 2),
                             indexing="ij")
        mask = ((xx // res + yy // res) % 2) == 0
        tex[mask] = c0
        tex[~mask] = c1
        return _with_meta(tex, spec)
    if "data" in spec:  # a raw array (tests, procedural textures)
        arr = np.asarray(spec["data"], np.float32)
        if arr.ndim == 2:
            arr = np.repeat(arr[..., None], 3, axis=-1)
        return _with_meta(arr, spec)
    arr = image_io.read_image(spec["filename"])
    if not spec.get("raw", False) and arr.dtype == np.uint8:
        arr = arr.astype(np.float32) / 255.0
        # sRGB -> linear for LDR inputs (bitmap.cpp)
        arr = np.where(arr <= 0.04045, arr / 12.92,
                       ((arr + 0.055) / 1.055) ** 2.4)
    if arr.ndim == 2:
        arr = np.repeat(arr[..., None], 3, axis=-1)
    return _with_meta(arr[..., :3], spec)
