"""Image I/O — counterpart of ``mitsuba3_tpu/utils/image_io.py`` (the
host-side slice of the reference's Bitmap, src/core/bitmap.cpp).

Reads and writes ``.npy``, PFM, Radiance RGBE (``.hdr``/``.rgbe``, flat
and RLE scanlines) and uncompressed scanline OpenEXR with numpy, ``struct``
and ``zlib`` only, as the JAX package does. PNG, which the JAX package
reads and writes through PIL, has its own codec here (``read_png``,
``write_png``):

- it reads 8- and 16-bit gray, gray+alpha, RGB and RGBA, non-interlaced,
  with all five scanline filters, into the array PIL gives: 8-bit data as
  uint8; 16-bit gray as uint16; 16-bit RGB and RGBA as uint8 holding each
  sample's high byte (PIL's 8-bit modes for them), and 16-bit gray+alpha
  likewise as RGBA (gray, gray, gray, alpha);
- it writes 8-bit gray, RGB or RGBA by the array's channels, sRGB-encoded
  as the JAX package encodes before PIL saves.

JPEG, BMP and TGA, interlaced PNG, palette PNG and PNG bit depths below 8
raise ``NotImplementedError`` naming the format.
"""
from __future__ import annotations

import struct
import threading
import zlib

import numpy as np

_PNG_MAGIC = b"\x89PNG\r\n\x1a\n"
# PNG colour type -> channels: gray, RGB, gray+alpha, RGBA
_PNG_CHANNELS = {0: 1, 2: 3, 4: 2, 6: 4}
_PIL_ONLY = (".jpg", ".jpeg", ".bmp", ".tga")


def _not_ported(what: str):
    return NotImplementedError(f"{what} is not ported to mitsuba3_tpu_torch")


def read_image(path: str) -> np.ndarray:
    p = str(path)
    if p.endswith(".npy"):
        return np.load(p)
    if p.endswith(".pfm"):
        return _read_pfm(p)
    if p.endswith(".exr"):
        return read_exr(p)
    if p.endswith((".hdr", ".rgbe")):
        return _read_rgbe(p)
    if p.lower().endswith(".png"):
        return read_png(p)
    if p.lower().endswith(_PIL_ONLY):
        raise _not_ported(f"reading {p.rsplit('.', 1)[-1].upper()} images")
    raise ValueError(f"Unsupported image format: {p}")


def write_image(path: str, img: np.ndarray):
    p = str(path)
    img = np.asarray(img)
    if p.endswith(".npy"):
        np.save(p, img.astype(np.float32))
    elif p.endswith(".pfm"):
        _write_pfm(p, img.astype(np.float32))
    elif p.endswith(".exr"):
        write_exr(p, img.astype(np.float32))
    elif p.endswith((".hdr", ".rgbe")):
        _write_rgbe(p, img.astype(np.float32))
    elif p.endswith(".png"):
        x = np.clip(img, 0.0, 1.0)
        x = np.where(x <= 0.0031308, x * 12.92,
                     1.055 * np.maximum(x, 1e-8) ** (1 / 2.4) - 0.055)
        write_png(p, (x * 255 + 0.5).astype(np.uint8))
    elif p.endswith(_PIL_ONLY):
        raise _not_ported(f"writing {p.rsplit('.', 1)[-1].upper()} images")
    else:
        raise ValueError(f"Unsupported image format: {p}")


def write_image_async(path: str, img: np.ndarray):
    """Fire-and-forget write on a worker thread (bitmap write_async). The
    array is copied synchronously; returns the Thread (join() to block)."""
    snapshot = np.array(img, copy=True)
    t = threading.Thread(target=write_image, args=(path, snapshot),
                         daemon=True)
    t.start()
    return t


# ---------------------------------------------------------------------------
# PNG
# ---------------------------------------------------------------------------

def _png_chunks(data: bytes):
    if data[:8] != _PNG_MAGIC:
        raise ValueError("not a PNG file")
    pos = 8
    while pos + 8 <= len(data):
        (n,) = struct.unpack_from(">I", data, pos)
        kind = data[pos + 4:pos + 8]
        yield kind, data[pos + 8:pos + 8 + n]
        pos += 12 + n
        if kind == b"IEND":
            return


def _unfilter(raw: np.ndarray, h: int, stride: int, bpp: int) -> np.ndarray:
    """Reverse the scanline filters of `raw` ([h, 1 + stride] bytes, the
    filter type first) -> [h, stride] uint8. Pixel (r, x) needs (r, x-1),
    (r-1, x) and (r-1, x-1), so the anti-diagonals r + x = k are
    independent: each is one vector step over all five filters, selected
    by its row's type."""
    types = raw[:, 0].astype(np.int64)
    if types.max(initial=0) > 4:
        raise ValueError(f"PNG: unknown filter type {int(types.max())}")
    w = stride // bpp
    filt = raw[:, 1:].reshape(h, w, bpp).astype(np.int64)
    if not (types >= 3).any():
        # None, Sub and Up only: row by row (Sub is a running sum)
        out = np.zeros((h + 1, w, bpp), np.int64)
        for r in range(h):
            t = types[r]
            row = filt[r]
            if t == 1:
                row = np.cumsum(row, axis=0)
            elif t == 2:
                row = row + out[r]
            out[r + 1] = row & 255
        return out[1:].reshape(h, stride).astype(np.uint8)
    # padded reconstruction: row 0 and column 0 are the zero border
    rec = np.zeros((h + 1, w + 1, bpp), np.int64)
    for k in range(h + w - 1):
        r = np.arange(max(0, k - w + 1), min(h - 1, k) + 1)
        x = k - r
        a = rec[r + 1, x]          # left
        b = rec[r, x + 1]          # up
        c = rec[r, x]              # up-left
        p = a + b - c
        pa, pb, pc = np.abs(p - a), np.abs(p - b), np.abs(p - c)
        paeth = np.where((pa <= pb) & (pa <= pc), a,
                         np.where(pb <= pc, b, c))
        t = types[r][:, None]
        pred = np.select([t == 1, t == 2, t == 3, t == 4],
                         [a, b, (a + b) >> 1, paeth], 0)
        rec[r + 1, x + 1] = (filt[r, x] + pred) & 255
    return rec[1:, 1:].reshape(h, stride).astype(np.uint8)


def read_png(path: str) -> np.ndarray:
    """A non-interlaced 8- or 16-bit gray, gray+alpha, RGB or RGBA PNG ->
    the array PIL's ``np.asarray(Image.open(path))`` gives."""
    with open(path, "rb") as f:
        data = f.read()
    header, idat = None, []
    for kind, body in _png_chunks(data):
        if kind == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif kind == b"IDAT":
            idat.append(body)
    if header is None:
        raise ValueError("PNG: no IHDR chunk")
    w, h, depth, ctype, _, _, interlace = header
    if ctype == 3:
        raise _not_ported("reading palette PNG")
    if ctype not in _PNG_CHANNELS:
        raise ValueError(f"PNG: unknown colour type {ctype}")
    if interlace:
        raise _not_ported("reading interlaced PNG")
    if depth not in (8, 16):
        raise _not_ported(f"reading {depth}-bit PNG")
    ch = _PNG_CHANNELS[ctype]
    nbytes = depth // 8
    bpp = ch * nbytes
    stride = w * bpp
    raw = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8)
    img = _unfilter(raw[:h * (stride + 1)].reshape(h, stride + 1), h,
                    stride, bpp)
    img = img.reshape(h, w, ch, nbytes)
    if depth == 8:
        img = img[..., 0]
    elif ch == 1:
        img = img[..., 0].astype(np.uint16) << 8 | img[..., 1]
    else:
        img = img[..., 0]
        if ch == 2:
            img = img[..., [0, 0, 0, 1]]
    return np.ascontiguousarray(img[..., 0] if img.shape[-1] == 1 else img)


def write_png(path: str, img: np.ndarray):
    """Write a uint8 [H, W] (gray), [H, W, 3] (RGB) or [H, W, 4] (RGBA)
    array as an 8-bit PNG (filter None on every scanline)."""
    img = np.asarray(img)
    if img.dtype != np.uint8:
        raise ValueError(f"write_png takes uint8 data, not {img.dtype}")
    if img.ndim == 3 and img.shape[2] == 1:
        img = img[..., 0]
    ctype = {2: 0, 3: {3: 2, 4: 6}.get(img.shape[-1])}.get(img.ndim)
    if ctype is None:
        raise ValueError(f"write_png: cannot write shape {img.shape}")
    h, w = img.shape[:2]
    rows = np.zeros((h, 1 + img[0].size), np.uint8)
    rows[:, 1:] = img.reshape(h, -1)

    def chunk(kind, body):
        return (struct.pack(">I", len(body)) + kind + body
                + struct.pack(">I", zlib.crc32(kind + body) & 0xFFFFFFFF))

    with open(path, "wb") as f:
        f.write(_PNG_MAGIC)
        f.write(chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, ctype, 0, 0,
                                           0)))
        f.write(chunk(b"IDAT", zlib.compress(rows.tobytes(), 6)))
        f.write(chunk(b"IEND", b""))


# ---------------------------------------------------------------------------
# Radiance RGBE (.hdr) — shared-exponent HDR (bitmap.cpp RGBE path)
# ---------------------------------------------------------------------------

def _write_rgbe(path, img):
    if img.ndim == 2:
        img = np.repeat(img[..., None], 3, axis=-1)
    img = np.ascontiguousarray(img[..., :3], np.float32)
    h, w = img.shape[:2]
    v = img.max(axis=-1)
    # v = m * 2^e with m in [0.5, 1): components scale to c/v * m * 256
    m, e = np.frexp(v)
    factor = np.where(v >= 1e-32, m * 256.0 / np.maximum(v, 1e-32), 0.0)
    rgbe = np.zeros((h, w, 4), np.uint8)
    rgbe[..., :3] = np.clip(img * factor[..., None] + 0.5, 0,
                            255).astype(np.uint8)
    rgbe[..., 3] = np.where(v >= 1e-32, e + 128, 0).astype(np.uint8)
    with open(path, "wb") as f:
        f.write(b"#?RADIANCE\nFORMAT=32-bit_rle_rgbe\n\n")
        f.write(f"-Y {h} +X {w}\n".encode())
        f.write(rgbe.tobytes())  # flat (non-RLE) scanlines


def _read_rgbe(path):
    with open(path, "rb") as f:
        line = f.readline()
        if not line.startswith((b"#?RADIANCE", b"#?RGBE")):
            raise ValueError("not a Radiance RGBE file")
        while True:
            line = f.readline()
            if line in (b"\n", b"\r\n", b""):
                break
        dims = f.readline().split()
        if dims[0] != b"-Y" or dims[2] != b"+X":
            raise ValueError(f"unsupported RGBE orientation {dims!r}")
        h, w = int(dims[1]), int(dims[3])
        data = f.read()
    rgbe = np.zeros((h, w, 4), np.uint8)
    pos = 0
    for y in range(h):
        if (len(data) - pos >= 4 and data[pos] == 2 and data[pos + 1] == 2
                and ((data[pos + 2] << 8) | data[pos + 3]) == w
                and 8 <= w <= 0x7FFF):
            # new-style RLE: 4 component planes per scanline
            pos += 4
            for c in range(4):
                x = 0
                while x < w:
                    count = data[pos]
                    pos += 1
                    if count > 128:  # run
                        rgbe[y, x:x + count - 128, c] = data[pos]
                        pos += 1
                        x += count - 128
                    else:  # literal
                        rgbe[y, x:x + count, c] = np.frombuffer(
                            data, np.uint8, count, pos)
                        pos += count
                        x += count
        else:  # flat scanline
            rgbe[y] = np.frombuffer(
                data, np.uint8, 4 * w, pos).reshape(w, 4)
            pos += 4 * w
    e = rgbe[..., 3].astype(np.int32)
    scale = np.where(e > 0, np.ldexp(1.0, e - 136), 0.0).astype(np.float32)
    return rgbe[..., :3].astype(np.float32) * scale[..., None]


# ---------------------------------------------------------------------------
# PFM
# ---------------------------------------------------------------------------

def _read_pfm(path):
    with open(path, "rb") as f:
        header = f.readline().strip()
        color = header == b"PF"
        w, h = map(int, f.readline().split())
        scale = float(f.readline())
        data = np.frombuffer(f.read(), "<f4" if scale < 0 else ">f4")
        img = data.reshape(h, w, 3 if color else 1)
        return img[::-1]  # PFM is bottom-up


def _write_pfm(path, img):
    if img.ndim == 2:
        img = img[..., None]
    color = img.shape[-1] == 3
    with open(path, "wb") as f:
        f.write(b"PF\n" if color else b"Pf\n")
        f.write(f"{img.shape[1]} {img.shape[0]}\n".encode())
        f.write(b"-1.0\n")
        f.write(img[::-1].astype("<f4").tobytes())


# ---------------------------------------------------------------------------
# Minimal OpenEXR: version 2, scanline, no compression
# ---------------------------------------------------------------------------

def write_exr(path: str, img: np.ndarray):
    """Write [H, W, 3] float32 as an uncompressed scanline EXR."""
    if img.ndim == 2:
        img = np.repeat(img[..., None], 3, -1)
    h, w, c = img.shape
    assert c >= 3
    channels = [("B", img[..., 2]), ("G", img[..., 1]), ("R", img[..., 0])]

    def attr(name, typ, data):
        return (name.encode() + b"\x00" + typ.encode() + b"\x00"
                + struct.pack("<I", len(data)) + data)

    chlist = b""
    for name, _ in channels:
        chlist += (name.encode() + b"\x00" + struct.pack("<I", 2)  # FLOAT
                   + b"\x00" + b"\x00\x00\x00"                   # pLinear+fill
                   + struct.pack("<II", 1, 1))                     # sampling
    chlist += b"\x00"

    header = b""
    header += attr("channels", "chlist", chlist)
    header += attr("compression", "compression", b"\x00")  # NO_COMPRESSION
    header += attr("dataWindow", "box2i", struct.pack("<iiii", 0, 0, w - 1,
                                                      h - 1))
    header += attr("displayWindow", "box2i", struct.pack("<iiii", 0, 0,
                                                         w - 1, h - 1))
    header += attr("lineOrder", "lineOrder", b"\x00")
    header += attr("pixelAspectRatio", "float", struct.pack("<f", 1.0))
    header += attr("screenWindowCenter", "v2f", struct.pack("<ff", 0.0, 0.0))
    header += attr("screenWindowWidth", "float", struct.pack("<f", 1.0))
    header += b"\x00"

    magic = struct.pack("<I", 20000630) + struct.pack("<I", 2)
    offset_table_pos = len(magic) + len(header)
    scanline_size = 4 + 4 + w * 4 * 3  # y + pixel-data-size + data
    first_scanline = offset_table_pos + 8 * h
    offsets = b"".join(struct.pack("<Q", first_scanline + i * scanline_size)
                       for i in range(h))
    with open(path, "wb") as f:
        f.write(magic)
        f.write(header)
        f.write(offsets)
        for y in range(h):
            f.write(struct.pack("<i", y))
            f.write(struct.pack("<I", w * 4 * 3))
            for _, chan in channels:
                f.write(chan[y].astype("<f4").tobytes())


def read_exr(path: str) -> np.ndarray:
    """Read the subset of EXR that write_exr produces (uncompressed
    scanline float32 RGB)."""
    with open(path, "rb") as f:
        data = f.read()
    magic, _ = struct.unpack_from("<II", data, 0)
    assert magic == 20000630, "not an EXR file"
    pos = 8
    attrs = {}
    while data[pos] != 0:
        e = data.index(b"\x00", pos)
        name = data[pos:e].decode()
        pos = e + 1
        e = data.index(b"\x00", pos)
        typ = data[pos:e].decode()
        pos = e + 1
        (size,) = struct.unpack_from("<I", data, pos)
        pos += 4
        attrs[name] = (typ, data[pos:pos + size])
        pos += size
    pos += 1
    x0, y0, x1, y1 = struct.unpack("<iiii", attrs["dataWindow"][1])
    w, h = x1 - x0 + 1, y1 - y0 + 1
    comp = attrs["compression"][1][0]
    assert comp == 0, "only uncompressed EXR supported by this reader"
    # the channel list (names in file order)
    ch = []
    cdata = attrs["channels"][1]
    cpos = 0
    while cdata[cpos] != 0:
        e = cdata.index(b"\x00", cpos)
        ch.append(cdata[cpos:e].decode())
        cpos = e + 1 + 16
    img = {c: np.zeros((h, w), np.float32) for c in ch}
    pos += 8 * h  # skip the offset table
    for _ in range(h):
        y, _ = struct.unpack_from("<iI", data, pos)
        pos += 8
        for c in ch:
            img[c][y] = np.frombuffer(data[pos:pos + w * 4], "<f4")
            pos += w * 4
    if all(k in img for k in "RGB"):
        return np.stack([img["R"], img["G"], img["B"]], -1)
    return np.stack([img[c] for c in ch], -1)
