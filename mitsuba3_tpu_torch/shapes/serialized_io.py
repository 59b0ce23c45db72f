"""Mitsuba ``.serialized`` meshes — counterpart of
``mitsuba3_tpu/shapes/serialized_io.py`` (src/shapes/serialized.cpp): the
zlib-compressed Mitsuba 0.6 format, versions 3-5, with the end-of-file
sub-mesh dictionary.
"""
from __future__ import annotations

import struct
import zlib

import numpy as np

MAGIC = 0x041C

HAS_NORMALS_V5 = 0x0001
HAS_TANGENTS_V5 = 0x0002
HAS_UV_V5 = 0x0004
# v3/v4 flag bits
V3_NORMALS = 0x0001
V3_UV = 0x0002
V3_COLORS = 0x0008
V3_DOUBLE = 0x2000


def _mesh_offsets(buf):
    (count,) = struct.unpack_from("<I", buf, len(buf) - 4)
    return list(struct.unpack_from(f"<{count}Q", buf,
                                   len(buf) - 4 - 8 * count))


def read_serialized(filename, shape_index: int = 0) -> dict:
    """-> dict(vertices [V,3], faces [F,3], and normals, uvs, colors
    where the file has them)."""
    with open(filename, "rb") as f:
        buf = f.read()
    offsets = _mesh_offsets(buf)
    if shape_index >= len(offsets):
        raise ValueError(f"{filename}: shape_index {shape_index} out of "
                         f"range ({len(offsets)} meshes)")
    off = offsets[shape_index]
    magic, version = struct.unpack_from("<HH", buf, off)
    if magic != MAGIC:
        raise ValueError(f"{filename}: bad magic {magic:#x}")
    end = (offsets[shape_index + 1] if shape_index + 1 < len(offsets)
           else len(buf) - 4 - 8 * len(offsets))
    raw = zlib.decompress(buf[off + 4:end])
    pos = 0

    def take(fmt):
        nonlocal pos
        vals = struct.unpack_from("<" + fmt, raw, pos)
        pos += struct.calcsize("<" + fmt)
        return vals if len(vals) > 1 else vals[0]

    def take_arr(dtype, count):
        nonlocal pos
        a = np.frombuffer(raw, dtype, count=count, offset=pos)
        pos += a.nbytes
        return a

    flags = take("I")
    if version >= 5:
        pos += take("I")                   # shape name (utf-8)
    elif version == 4:
        pos = raw.index(b"\0", pos) + 1    # null-terminated name

    if version >= 5:
        nv, nf = take("Q"), take("Q")
        take("QQ")                         # sample and normal group counts
        rec = take_arr(np.float32, 8 * nv).reshape(nv, 8)
        faces4 = take_arr(np.uint32, 4 * nf).reshape(nf, 4)
        out = {"vertices": rec[:, 0:3].astype(np.float64),
               "faces": faces4[:, 0:3].astype(np.int64)}
        if (flags & HAS_NORMALS_V5) and not (flags & HAS_TANGENTS_V5):
            out["normals"] = rec[:, 3:6].astype(np.float64)
        if flags & HAS_UV_V5:
            out["uvs"] = rec[:, 6:8].astype(np.float64)
        return out

    # versions 3 and 4: separate arrays
    dt = np.float64 if flags & V3_DOUBLE else np.float32
    nv, nf = take("Q"), take("Q")

    def rows(width):
        return take_arr(dt, width * nv).reshape(nv, width).astype(np.float64)

    out = {"vertices": rows(3)}
    if flags & V3_NORMALS:
        out["normals"] = rows(3)
    if flags & V3_UV:
        out["uvs"] = rows(2)
    if flags & V3_COLORS:
        out["colors"] = rows(3)
    out["faces"] = take_arr(np.uint32, 3 * nf).reshape(nf, 3).astype(
        np.int64)
    return out


def write_serialized(filename, vertices, faces, normals=None, uvs=None,
                     colors=None):
    """Write one mesh as a version-3 .serialized file."""
    flags = ((V3_NORMALS if normals is not None else 0)
             | (V3_UV if uvs is not None else 0)
             | (V3_COLORS if colors is not None else 0))
    v = np.asarray(vertices, np.float32)
    f = np.asarray(faces, np.uint32)
    body = struct.pack("<I", flags) + struct.pack("<QQ", v.shape[0],
                                                   f.shape[0])
    body += v.tobytes()
    for extra in (normals, uvs, colors):
        if extra is not None:
            body += np.asarray(extra, np.float32).tobytes()
    body += f.tobytes()
    with open(filename, "wb") as fo:
        fo.write(struct.pack("<HH", MAGIC, 3) + zlib.compress(body))
        fo.write(struct.pack("<Q", 0))
        fo.write(struct.pack("<I", 1))
