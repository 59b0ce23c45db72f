"""Texture evaluation — counterpart of ``mitsuba3_tpu/render/texture.py``
(src/textures/bitmap.cpp: wrap modes, nearest and bilinear filtering, raw
channels; checkerboard.cpp; mesh_attribute.cpp; volume.cpp).

Scene textures live in ``scene.textures`` (a tuple of [H, W, 3] tensors,
each differentiable: PRB's texture gradients), their static metadata in
``scene.texture_meta`` (wrap mode, filter, mip flag, uv transform; a
``volume`` texture's is ``("3d", "trilinear", False, world->local 3x4)``)
and their mip levels in ``scene.texture_mips``. A BSDF row's texture slot
holds 0 for its constant color, k > 0 for ``scene.textures[k-1]`` and -1
for the interpolated vertex color (``si.vcolor``).

Bilinear lookups with repeat or clamp wrap gather one row of a [H*W, 12]
quad table per lane (the texel and its wrapped +x, +y and +xy
neighbours), as the JAX package does. XLA folds that table away; eager
torch would rebuild it at every lookup, so ``quad_table`` builds it once
per texture tensor and keeps it while the tensor lives. A tensor that
requires grad gets a fresh table per lookup, unless ``ad/prb.py`` has
registered its pass's table for it (``register_quad``). A mipmapped
texture's levels are looked up together, in one gather from their quad
tables stacked once (``_level_tables``).
"""
from __future__ import annotations

import numpy as np
import torch
from torch.utils.weak import WeakTensorKeyDictionary

from ..core import spectral
from ..core.gather import take_rows
from ..core.vec import Vec2, Vec3
from .film import film_full

# texture tensor -> (version, wrap, [H*W, 12] quad table); a texture's
# first mip level -> (version, wrap, the levels' tables)
_QUADS = WeakTensorKeyDictionary()
_LEVELS = WeakTensorKeyDictionary()


def _wrap_idx(i, n, mode: str):
    if mode == "clamp":
        return torch.clamp(i, 0, n - 1)
    if mode == "mirror":
        p = i % (2 * n)
        p = torch.where(p < 0, p + 2 * n, p)
        return torch.where(p < n, p, 2 * n - 1 - p)
    return i % n  # repeat


def build_quad(tex, wrap: str):
    """[H*W, 12] rows: the texel at (y, x), then its wrapped +x, +y and +xy
    neighbours."""
    h, w = tex.shape[0], tex.shape[1]
    ix1 = _wrap_idx(torch.arange(w, device=tex.device) + 1, w, wrap)
    iy1 = _wrap_idx(torch.arange(h, device=tex.device) + 1, h, wrap)
    return torch.cat([tex, tex[:, ix1], tex[iy1, :], tex[iy1][:, ix1]],
                     dim=-1).reshape(h * w, 12)


def register_quad(tex, wrap: str, quad):
    """Make `quad` the table that lookups in `tex` use while `tex` lives."""
    _QUADS[tex] = (tex._version, wrap, quad)


def quad_table(tex, wrap: str):
    """The quad table of `tex`: the one registered or built before for it,
    else a new one (kept unless it carries an autograd graph)."""
    needs_graph = tex.requires_grad and torch.is_grad_enabled()
    hit = _QUADS.get(tex)
    if (hit is not None and hit[0] == tex._version and hit[1] == wrap
            and (hit[2].requires_grad or not needs_graph)):
        return hit[2]
    if needs_graph:
        return build_quad(tex, wrap)
    with torch.no_grad():
        quad = build_quad(tex, wrap)
    register_quad(tex, wrap, quad)
    return quad


def eval_texture(tex, uv: Vec2, wrap: str = "repeat",
                 filt: str = "bilinear") -> Vec3:
    """Sample tex [H, W, 3] at uv with the given wrap and filter modes
    (bitmap.cpp eval). The uv origin is the bottom left (v runs against
    the row index)."""
    h, w = tex.shape[0], tex.shape[1]
    u = uv.x * w - 0.5
    v = (1.0 - uv.y) * h - 0.5
    if wrap == "clamp":
        # pre-clamp the continuous coordinate: outside [0, n-1] both
        # bilinear taps are the edge texel, and floor(u) stays in range,
        # so the +1 quad table is exact at the low edge too
        u = torch.clamp(u, 0.0, w - 1.0)
        v = torch.clamp(v, 0.0, h - 1.0)

    def fetch(iy, ix):
        r = take_rows(tex.reshape(h * w, 3),
                      _wrap_idx(iy, h, wrap) * w + _wrap_idx(ix, w, wrap))
        return Vec3(r[:, 0], r[:, 1], r[:, 2])

    if filt == "nearest":
        return fetch(torch.floor(v + 0.5).to(torch.int32),
                     torch.floor(u + 0.5).to(torch.int32))

    x0f = torch.floor(u)
    y0f = torch.floor(v)
    fu = u - x0f
    fv = v - y0f
    x0 = x0f.to(torch.int32)
    y0 = y0f.to(torch.int32)
    if wrap in ("repeat", "clamp"):
        # mirror wrap keeps the four gathers: a mirrored base reverses the
        # neighbour direction at the folds, where a +1 table is wrong
        rows = take_rows(quad_table(tex, wrap),
                         _wrap_idx(y0, h, wrap) * w + _wrap_idx(x0, w, wrap))
        r = _blend_quad(rows, fu, fv)
        return Vec3(r[:, 0], r[:, 1], r[:, 2])
    t00 = fetch(y0, x0)
    t10 = fetch(y0, x0 + 1)
    t01 = fetch(y0 + 1, x0)
    t11 = fetch(y0 + 1, x0 + 1)
    return (t00 * ((1 - fu) * (1 - fv)) + t10 * (fu * (1 - fv))
            + t01 * ((1 - fu) * fv) + t11 * (fu * fv))


def _blend_quad(rows, fu, fv):
    """Bilinear weights of quad rows [..., 12] at fractions fu, fv [...]
    -> [..., 3]."""
    gu, gv = 1 - fu, 1 - fv
    return (rows[..., 0:3] * (gu * gv)[..., None]
            + rows[..., 3:6] * (fu * gv)[..., None]
            + rows[..., 6:9] * (gu * fv)[..., None]
            + rows[..., 9:12] * (fu * fv)[..., None])


def _level_tables(levels, wrap: str):
    """The quad tables of mip `levels` stacked ([sum H_l W_l, 12]) with
    each level's width, height and first row, made once per level tuple."""
    hit = _LEVELS.get(levels[0])
    if hit is not None and hit[0] == levels[0]._version and hit[1] == wrap:
        return hit[2]
    dev = levels[0].device
    with torch.no_grad():
        quads = [build_quad(lv, wrap) for lv in levels]
    sizes = [q.shape[0] for q in quads]
    tables = (torch.cat(quads, 0),
              torch.tensor([lv.shape[1] for lv in levels], device=dev),
              torch.tensor([lv.shape[0] for lv in levels], device=dev),
              torch.tensor(np.cumsum([0] + sizes[:-1]), device=dev))
    _LEVELS[levels[0]] = (levels[0]._version, wrap, tables)
    return tables


def _eval_levels(levels, uv: Vec2, wrap: str):
    """Bilinear lookups at uv in every mip level at once (repeat or clamp
    wrap) -> [N, L, 3]; each level's value is eval_texture's."""
    table, wl, hl, first = _level_tables(levels, wrap)
    wf, hf = wl.to(torch.float32), hl.to(torch.float32)
    u = uv.x[:, None] * wf - 0.5
    v = (1.0 - uv.y)[:, None] * hf - 0.5
    if wrap == "clamp":
        u = torch.minimum(torch.clamp(u, min=0.0), wf - 1.0)
        v = torch.minimum(torch.clamp(v, min=0.0), hf - 1.0)
    x0f = torch.floor(u)
    y0f = torch.floor(v)
    x0 = x0f.to(torch.int64)
    y0 = y0f.to(torch.int64)
    if wrap == "clamp":
        x0 = torch.minimum(torch.clamp(x0, min=0), wl - 1)
        y0 = torch.minimum(torch.clamp(y0, min=0), hl - 1)
    else:
        x0, y0 = x0 % wl, y0 % hl
    rows = take_rows(table, (first + y0 * wl + x0).reshape(-1))
    return _blend_quad(rows.reshape(u.shape + (12,)), u - x0f, v - y0f)


def eval_bilinear(tex, uv: Vec2) -> Vec3:
    """Bilinear repeat-wrap sample."""
    return eval_texture(tex, uv, "repeat", "bilinear")


def build_mips(tex):
    """Host-side 2x box-filter pyramid (dr::Texture's mip role)."""
    levels = []
    cur = np.asarray(tex, np.float32)
    while min(cur.shape[0], cur.shape[1]) >= 2:
        h2, w2 = cur.shape[0] // 2, cur.shape[1] // 2
        cur = cur[:2 * h2, :2 * w2].reshape(h2, 2, w2, 2, 3).mean((1, 3))
        levels.append(cur)
    return tuple(levels)


def _footprint_lod(scene, si, tex_h):
    """Isotropic LOD heuristic: texels covered by one pixel footprint =
    (hit distance x pixel angle / cos) x |duv/dp| x resolution."""
    sd = scene.sensor
    if isinstance(sd, tuple):
        raise NotImplementedError(
            "mipmapped textures seen by a batch sensor are not ported to "
            "mitsuba3_tpu_torch")
    pix_angle = 2.0 * sd.tan_half_x / film_full(scene.film)[0]
    cos_g = torch.clamp(torch.abs(si.wi.z), min=0.1)
    footprint = si.t * pix_angle / cos_g           # world units
    duv = si.duv_scale if si.duv_scale is not None else 1.0
    lod = torch.log2(torch.clamp(footprint * duv * tex_h, min=1e-6))
    return torch.clamp(lod, 0.0, 16.0)


def eval_color(scene, base_rgb: Vec3, tex_id_f, si, ids,
               raw: bool = False) -> Vec3:
    """Resolve a color parameter: the constant `base_rgb` where the lane's
    texture id is 0; a lookup in scene.textures[id-1] (with its mips when
    enabled); the interpolated vertex color where the id is -1. `ids`
    (``Scene.texture_ids``) are the ids the lanes' rows can hold: a
    texture no row names is not looked up, since every lane would discard
    its value. In the spectral variant (si.wavelengths set) the color is a
    reflectance upsampled to the path's wavelengths, unless `raw` (normal
    maps, opacities, blend weights), and id -(k + 2) evaluates the sampled
    reflectance scene.bsdf_spd[k] there."""
    out = _lookup_color(scene, base_rgb, tex_id_f, si, ids)
    wavelengths = getattr(si, "wavelengths", None)
    if raw or wavelengths is None:
        return out
    out = spectral.rgb_to_spectrum(out, wavelengths, reflectance=True)
    spd = getattr(scene, "bsdf_spd", None)
    if spd is not None:
        tex_id = tex_id_f.to(torch.int32)
        for k in range(spd.shape[0]):
            if -(k + 2) in ids:
                out = Vec3.where(tex_id == -(k + 2),
                                 spectral.eval_spd(spd[k], wavelengths), out)
    return out


def _lookup_color(scene, base_rgb: Vec3, tex_id_f, si, ids) -> Vec3:
    """eval_color's RGB: the constant, texture or vertex color per lane."""
    out = base_rgb
    if not ids:
        return out
    tex_id = tex_id_f.to(torch.int32)
    metas = scene.texture_meta
    mips = scene.texture_mips
    for k, tex in enumerate(scene.textures):
        if k + 1 not in ids:
            continue
        wrap, filt, mip, extra = metas[k]
        if wrap == "3d":
            # the `volume` adapter: the grid at the world hit point mapped
            # through the volume's world->local transform (volume.cpp)
            a = extra
            pl = Vec3(
                a[0] * si.p.x + a[1] * si.p.y + a[2] * si.p.z + a[3],
                a[4] * si.p.x + a[5] * si.p.y + a[6] * si.p.z + a[7],
                a[8] * si.p.x + a[9] * si.p.y + a[10] * si.p.z + a[11])
            out = Vec3.where(tex_id == (k + 1), eval_texture3d(tex, pl), out)
            continue
        sx, sy, ox, oy = extra
        uv_k = si.uv if (sx, sy, ox, oy) == (1.0, 1.0, 0.0, 0.0) else \
            Vec2(si.uv.x * sx + ox, si.uv.y * sy + oy)
        val = eval_texture(tex, uv_k, wrap, filt)
        if mip and mips[k]:
            lvl = torch.clamp(_footprint_lod(scene, si, tex.shape[0]), 0.0,
                              float(len(mips[k])))
            if filt == "bilinear" and wrap in ("repeat", "clamp"):
                v_all = _eval_levels(mips[k], uv_k, wrap)
                acc = val.to_array()
                for li in range(len(mips[k])):
                    f = torch.clamp(lvl - li, 0.0, 1.0)[:, None]
                    acc = torch.where((lvl > li)[:, None],
                                      acc * (1.0 - f) + v_all[:, li] * f, acc)
                val = Vec3(acc[:, 0], acc[:, 1], acc[:, 2])
            else:
                for li, mtex in enumerate(mips[k]):
                    v_l = eval_texture(mtex, uv_k, wrap, filt)
                    f = torch.clamp(lvl - li, 0.0, 1.0)
                    val = Vec3.where(lvl > li, val * (1.0 - f) + v_l * f,
                                     val)
        out = Vec3.where(tex_id == (k + 1), val, out)
    if si.vcolor is not None and -1 in ids:
        out = Vec3.where(tex_id == -1, si.vcolor, out)
    return out


def eval_texture3d(grid, p: Vec3) -> Vec3:
    """Trilinear sample of a [D, H, W, 3] grid at local coordinates in
    [0,1]^3 (gridvolume.cpp's trilinear path); outside the unit cube the
    boundary value (the reference's default wrap)."""
    d, h, w = grid.shape[0], grid.shape[1], grid.shape[2]
    flat = grid.reshape(-1, 3)
    x = torch.clamp(p.x, 0.0, 1.0) * (w - 1)
    y = torch.clamp(p.y, 0.0, 1.0) * (h - 1)
    z = torch.clamp(p.z, 0.0, 1.0) * (d - 1)
    x0 = torch.clamp(x.to(torch.int32), 0, w - 1)
    y0 = torch.clamp(y.to(torch.int32), 0, h - 1)
    z0 = torch.clamp(z.to(torch.int32), 0, d - 1)
    x1 = torch.clamp(x0 + 1, max=w - 1)
    y1 = torch.clamp(y0 + 1, max=h - 1)
    z1 = torch.clamp(z0 + 1, max=d - 1)
    tx = (x - x0)[:, None]
    ty = (y - y0)[:, None]
    tz = (z - z0)[:, None]

    def at(zi, yi, xi):
        return take_rows(flat, (zi * h + yi) * w + xi)

    c00 = at(z0, y0, x0) * (1 - tx) + at(z0, y0, x1) * tx
    c01 = at(z0, y1, x0) * (1 - tx) + at(z0, y1, x1) * tx
    c10 = at(z1, y0, x0) * (1 - tx) + at(z1, y0, x1) * tx
    c11 = at(z1, y1, x0) * (1 - tx) + at(z1, y1, x1) * tx
    c0 = c00 * (1 - ty) + c01 * ty
    c1 = c10 * (1 - ty) + c11 * ty
    out = c0 * (1 - tz) + c1 * tz
    return Vec3(out[:, 0], out[:, 1], out[:, 2])
