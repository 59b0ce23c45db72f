"""Port parity for textures and image I/O, piece by piece: texture lookups
(every wrap mode and filter, uvs inside and outside [0, 1]) and the
trilinear 3D lookup against JAX to 1e-6; mip levels, texture specs (a
checkerboard, a ``data`` array, ``.exr``, ``.pfm``, ``.hdr``, ``.npy`` and
``.png`` files), ``.vol`` grids and the environment's sampling tables at
2048x1024 bit-equal to JAX's; the port's PNG codec against PIL (gray,
gray+alpha, RGB and RGBA at 8 and 16 bits, every scanline filter) and its
other readers and writers against the JAX package's; the formats it
refuses. Mirrors tests/test_image_io.py and tests/test_render.py:129."""
import struct
import zlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from mitsuba3_tpu.core.vec import Vec2 as Vec2_j
from mitsuba3_tpu.core.vec import Vec3 as Vec3_j
from mitsuba3_tpu.emitters import envmap as env_j
from mitsuba3_tpu.render import texture as tex_j
from mitsuba3_tpu.render import texture_io as tio_j
from mitsuba3_tpu.utils import image_io as io_j
from mitsuba3_tpu.utils import vol_io as vol_j

from mitsuba3_tpu_torch.core.vec import Vec2, Vec3
from mitsuba3_tpu_torch.emitters import envmap as env_t
from mitsuba3_tpu_torch.render import texture as tex_t
from mitsuba3_tpu_torch.render import texture_io as tio_t
from mitsuba3_tpu_torch.utils import image_io as io_t
from mitsuba3_tpu_torch.utils import vol_io as vol_t

torch.set_num_threads(1)
N_LOOKUPS = 4096


def _uv(rng, n=N_LOOKUPS):
    """uvs inside and outside [0, 1] (down to -0.8, up to 1.9)."""
    return rng.uniform(-0.8, 1.9, (2, n)).astype(np.float32)


@pytest.mark.parametrize("filt", ["bilinear", "nearest"])
@pytest.mark.parametrize("wrap", ["repeat", "clamp", "mirror"])
def test_eval_texture_matches_jax(np_rng, wrap, filt):
    tex = np_rng.random((7, 5, 3)).astype(np.float32)
    u, v = _uv(np_rng)
    out_j = tex_j.eval_texture(jnp.asarray(tex), Vec2_j(jnp.asarray(u),
                                                         jnp.asarray(v)),
                               wrap, filt)
    out_t = tex_t.eval_texture(torch.as_tensor(tex),
                               Vec2(torch.as_tensor(u), torch.as_tensor(v)),
                               wrap, filt)
    for a, b in zip((out_j.x, out_j.y, out_j.z), (out_t.x, out_t.y, out_t.z)):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=0,
                                   atol=1e-6)


@pytest.mark.parametrize("wrap", ["repeat", "clamp"])
def test_mip_levels_in_one_gather_equal_each_lookup(np_rng, wrap):
    """The mips looked up together give each level's own lookup, bit for
    bit."""
    levels = tuple(torch.as_tensor(lv) for lv in tex_t.build_mips(
        np_rng.random((32, 16, 3)).astype(np.float32)))
    u, v = (torch.as_tensor(a) for a in _uv(np_rng))
    together = tex_t._eval_levels(levels, Vec2(u, v), wrap)
    for li, lv in enumerate(levels):
        one = tex_t.eval_texture(lv, Vec2(u, v), wrap, "bilinear")
        assert torch.equal(together[:, li], one.to_array()), li


def test_eval_texture3d_matches_jax(np_rng):
    grid = np_rng.random((3, 4, 5, 3)).astype(np.float32)
    p = np_rng.uniform(-0.2, 1.2, (3, N_LOOKUPS)).astype(np.float32)
    out_j = tex_j.eval_texture3d(jnp.asarray(grid),
                                 Vec3_j(*map(jnp.asarray, p)))
    out_t = tex_t.eval_texture3d(torch.as_tensor(grid),
                                 Vec3(*map(torch.as_tensor, p)))
    for a, b in zip((out_j.x, out_j.y, out_j.z), (out_t.x, out_t.y, out_t.z)):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=0,
                                   atol=1e-6)


@pytest.mark.parametrize("shape", [(64, 64), (37, 20), (1, 9)])
def test_build_mips_bit_equal(np_rng, shape):
    tex = np_rng.random(shape + (3,)).astype(np.float32)
    lj, lt = tex_j.build_mips(tex), tex_t.build_mips(tex)
    assert len(lj) == len(lt)
    for a, b in zip(lj, lt):
        assert a.dtype == b.dtype and np.array_equal(a, b)


def _write_spec_file(tmp_path, kind, rng):
    """A texture spec of `kind` and, for a file, the file written by the
    JAX package's writer (PNG: by PIL)."""
    img = rng.random((6, 9, 3)).astype(np.float32)
    if kind == "checkerboard":
        return {"type": "checkerboard", "color0": [0.9, 0.5, 0.1],
                "color1": 0.25, "resolution": 3, "wrap_mode": "clamp"}
    if kind == "data":
        return {"type": "bitmap", "data": img[..., 0], "mipmap": True,
                "filter_type": "nearest"}
    if kind.startswith("png"):
        mode, raw = kind[4:].split("_") if "_" in kind[4:] else (kind[4:],
                                                                None)
        arr = (img[..., :{"L": 1, "RGB": 3, "RGBA": 3}[mode]] * 255).astype(
            np.uint8)
        if mode == "RGBA":
            arr = np.concatenate([arr, arr[..., :1]], -1)
        if mode == "L":
            arr = arr[..., 0]
        path = str(tmp_path / f"t_{mode}.png")
        Image.fromarray(arr, mode).save(path)
        return {"type": "bitmap", "filename": path, "raw": raw == "raw",
                "wrap_mode": "mirror"}
    path = str(tmp_path / f"t.{kind}")
    io_j.write_image(path, img * 4.0)
    return {"type": "bitmap", "filename": path, "wrap_mode": "repeat"}


@pytest.mark.parametrize("kind", ["checkerboard", "data", "exr", "pfm",
                                  "hdr", "npy", "png_L", "png_RGB",
                                  "png_RGBA", "png_RGB_raw"])
def test_load_texture_spec_bit_equal(tmp_path, np_rng, kind):
    """The texture array and its metadata tuple (wrap, filter, mip flag,
    uv transform) equal JAX's TexArray: sRGB-decoded 8-bit PNGs (raw ones
    kept as they are), float files and arrays as float32."""
    spec = _write_spec_file(tmp_path, kind, np_rng)
    spec["to_uv"] = np.diag([2.0, 0.5, 1.0, 1.0]) + np.eye(4, k=3) * 0.25
    a, b = tio_j.load_texture_spec(spec), tio_t.load_texture_spec(spec)
    assert b.data.dtype == np.float32 and b.data.shape == a.shape
    assert np.array_equal(np.asarray(a), b.data)
    assert b.meta == a.meta


def _png_bytes(arr, depth, ctype, filters):
    """A PNG of `arr` ([H, W, C] unsigned) with scanline filter
    filters[y % len(filters)] on row y (so every filter occurs)."""
    h, w = arr.shape[:2]
    data = arr.astype(">u2" if depth == 16 else np.uint8).reshape(h, -1)
    rows = data.view(np.uint8).astype(np.int64)
    bpp = max(1, arr.shape[2] * depth // 8)
    out = b""
    prev = np.zeros(rows.shape[1], np.int64)
    for y in range(h):
        cur = rows[y]
        ft = filters[y % len(filters)]
        left = np.concatenate([np.zeros(bpp, np.int64), cur[:-bpp]])
        upleft = np.concatenate([np.zeros(bpp, np.int64), prev[:-bpp]])
        p = left + prev - upleft
        pa, pb, pc = np.abs(p - left), np.abs(p - prev), np.abs(p - upleft)
        paeth = np.where((pa <= pb) & (pa <= pc), left,
                         np.where(pb <= pc, prev, upleft))
        pred = [0, left, prev, (left + prev) // 2, paeth][ft]
        out += bytes([ft]) + ((cur - pred) & 255).astype(np.uint8).tobytes()
        prev = cur

    return _png_file(w, h, depth, ctype, 0, out)


def _png_file(w, h, depth, ctype, interlace, scanlines: bytes):
    def chunk(kind, body):
        return (struct.pack(">I", len(body)) + kind + body
                + struct.pack(">I", zlib.crc32(kind + body) & 0xFFFFFFFF))
    return (b"\x89PNG\r\n\x1a\n"
            + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, depth, ctype,
                                         0, 0, interlace))
            + chunk(b"IDAT", zlib.compress(scanlines))
            + chunk(b"IEND", b""))


@pytest.mark.parametrize("depth", [8, 16])
@pytest.mark.parametrize("ctype,channels", [(0, 1), (4, 2), (2, 3), (6, 4)])
def test_png_reader_equals_pil_every_filter(tmp_path, np_rng, depth, ctype,
                                            channels):
    """Gray, gray+alpha, RGB and RGBA at 8 and 16 bits, rows filtered
    None, Sub, Up, Average and Paeth in turn: the port's reader gives
    PIL's array (dtype, shape and values)."""
    arr = np_rng.integers(0, 2 ** depth, (11, 7, channels))
    path = tmp_path / "f.png"
    path.write_bytes(_png_bytes(arr, depth, ctype, (0, 1, 2, 3, 4)))
    ref = np.asarray(Image.open(path))
    got = io_t.read_png(str(path))
    assert got.dtype == ref.dtype and got.shape == ref.shape
    assert np.array_equal(got, ref)


@pytest.mark.parametrize("mode,depth", [("L", 8), ("RGB", 8), ("RGBA", 8),
                                        ("I;16", 16)])
def test_png_reader_reads_what_pil_writes(tmp_path, np_rng, mode, depth):
    """PNGs PIL writes (its own adaptive filters) in gray, RGB and RGBA at
    8 bits and gray at 16 bits (the widest PIL writes) read as PIL reads
    them."""
    shape = {"L": (23, 31), "RGB": (23, 31, 3), "RGBA": (23, 31, 4),
             "I;16": (23, 31)}[mode]
    yy, xx = np.mgrid[0:23, 0:31]
    smooth = (yy * 37 + xx * 11) % (2 ** depth)
    arr = (smooth.reshape(smooth.shape + (1,) * (len(shape) - 2))
           + np_rng.integers(0, 3, shape)) % (2 ** depth)
    arr = arr.astype(np.uint16 if depth == 16 else np.uint8)
    path = str(tmp_path / "p.png")
    Image.fromarray(arr, None if depth == 16 else mode).save(path)
    ref = np.asarray(Image.open(path))
    got = io_t.read_png(path)
    assert got.dtype == ref.dtype and np.array_equal(got, ref)


@pytest.mark.parametrize("channels", [1, 3, 4])
def test_png_writer_equals_jax_through_pil(tmp_path, np_rng, channels):
    """The port writes what the JAX package saves through PIL (8-bit,
    sRGB-encoded): PIL reads both files to the same array."""
    img = np_rng.uniform(-0.1, 1.2, (9, 14, channels)).astype(np.float32)
    img = img[..., 0] if channels == 1 else img
    pj, pt = str(tmp_path / "j.png"), str(tmp_path / "t.png")
    io_j.write_image(pj, img)
    io_t.write_image(pt, img)
    a, b = np.asarray(Image.open(pj)), np.asarray(Image.open(pt))
    assert Image.open(pt).mode == Image.open(pj).mode
    assert a.dtype == b.dtype and np.array_equal(a, b)
    assert np.array_equal(io_t.read_png(pt), b)


@pytest.mark.parametrize("ext", ["exr", "pfm", "hdr", "npy"])
def test_float_images_cross_read(tmp_path, np_rng, ext):
    """Each package reads the other's file to the same array."""
    img = (np_rng.gamma(1.0, 1.0, (5, 8, 3)) * 10).astype(np.float32)
    img[0, 0] = 0.0
    pj, pt = str(tmp_path / f"j.{ext}"), str(tmp_path / f"t.{ext}")
    io_j.write_image(pj, img)
    io_t.write_image(pt, img)
    assert open(pj, "rb").read() == open(pt, "rb").read()
    for p in (pj, pt):
        a, b = io_j.read_image(p), io_t.read_image(p)
        assert a.dtype == b.dtype and np.array_equal(a, b)


def test_rgbe_rle_and_async_write(tmp_path):
    """A hand-made RLE scanline (runs and literals) reads as JAX reads it;
    write_image_async writes the same file as write_image."""
    w = 16
    payload = bytes([2, 2, 0, w])
    for c in range(4):
        # a run of 10, then 6 literals
        payload += bytes([128 + 10, 100 + c]) + bytes([6]) + bytes(
            range(120, 126))
    p = tmp_path / "rle.hdr"
    p.write_bytes(b"#?RADIANCE\nFORMAT=32-bit_rle_rgbe\n\n"
                  + f"-Y 1 +X {w}\n".encode() + payload)
    assert np.array_equal(io_j.read_image(str(p)), io_t.read_image(str(p)))
    img = np.linspace(0, 2, 30, dtype=np.float32).reshape(2, 5, 3)
    io_t.write_image_async(str(tmp_path / "a.exr"), img).join()
    io_t.write_image(str(tmp_path / "b.exr"), img)
    assert (tmp_path / "a.exr").read_bytes() == (
        tmp_path / "b.exr").read_bytes()


def test_read_vol_matches_jax(tmp_path, np_rng):
    for shape in ((3, 4, 5), (2, 3, 4, 3)):
        g = np_rng.random(shape).astype(np.float32)
        p = str(tmp_path / "g.vol")
        vol_t.write_vol(p, g, (-1, 0, 0), (1, 2, 3))
        for a, b in zip(vol_j.read_vol(p), vol_t.read_vol(p)):
            assert a.dtype == b.dtype and np.array_equal(a, b)


def test_env_tables_and_warp_match_jax_at_2048x1024(np_rng):
    """build_tables of a 2048x1024 radiance map (a bright sun region, a
    black band): density and both CDFs bit-equal to JAX's; the warp's
    samples (positions, pdfs) and densities at 4,096 points as JAX's."""
    h, w = 1024, 2048
    data = (np_rng.random((h, w, 3)) * 0.5).astype(np.float32)
    data[100:120, 300:330] += 80.0
    data[600:640] = 0.0
    wj = env_j.build_tables(data)
    wt = env_t.build_tables(data, "cpu")
    for name in ("density", "marg_cdf", "cond_cdf"):
        a, b = np.asarray(getattr(wj, name)), getattr(wt, name).numpy()
        assert a.dtype == b.dtype and np.array_equal(a, b), name
    u = np_rng.random((2, 4096)).astype(np.float32)
    u[:, :4] = [[0.0, 1.0 - 2 ** -24, 0.5, 0.25], [0.0, 0.999, 0.5, 0.0]]
    k_j, k_t = jnp.zeros(4096, jnp.int32), torch.zeros(4096, dtype=torch.int64)
    pos_j, pdf_j = wj.sample(k_j, Vec2_j(jnp.asarray(u[0]), jnp.asarray(u[1])))
    pos_t, pdf_t = wt.sample(k_t, Vec2(torch.as_tensor(u[0]),
                                       torch.as_tensor(u[1])))
    for a, b in ((pos_j.x, pos_t.x), (pos_j.y, pos_t.y), (pdf_j, pdf_t)):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=1e-6)
    np.testing.assert_array_equal(
        wt.eval(k_t, Vec2(torch.as_tensor(u[0]), torch.as_tensor(u[1]))),
        np.asarray(wj.eval(k_j, Vec2_j(jnp.asarray(u[0]),
                                       jnp.asarray(u[1])))))


@pytest.mark.parametrize("name", ["a.jpg", "a.jpeg", "a.bmp", "a.tga"])
def test_unported_formats_raise(tmp_path, name):
    p = str(tmp_path / name)
    Image.new("RGB", (4, 4)).save(p)
    with pytest.raises(NotImplementedError, match=name.rsplit(".")[1].upper()):
        io_t.read_image(p)
    with pytest.raises(NotImplementedError, match="writing"):
        io_t.write_image(p, np.zeros((2, 2, 3), np.float32))


@pytest.mark.parametrize("kind,depth,ctype,interlace", [
    ("interlaced", 8, 2, 1), ("palette", 8, 3, 0), ("4-bit", 4, 0, 0)])
def test_unported_png_variants_raise(tmp_path, kind, depth, ctype,
                                     interlace):
    """The header decides: an interlaced, palette or sub-byte PNG is
    refused by name before its data is read."""
    p = tmp_path / "v.png"
    p.write_bytes(_png_file(9, 9, depth, ctype, interlace, b"\0" * 90))
    if kind == "palette":   # PIL's palette file too
        Image.new("P", (9, 9)).save(p)
    with pytest.raises(NotImplementedError, match=kind):
        io_t.read_png(str(p))
