"""Mitsuba ``.vol`` grid I/O — counterpart of ``mitsuba3_tpu/utils/vol_io.py``
(src/render/volumegrid.cpp's binary format: 'VOL' magic, version 3, int32
data type (1 = float32), xyz resolution, channel count, world bounding
box, then x-fastest float data)."""
from __future__ import annotations

import struct

import numpy as np


def read_vol(filename):
    """-> (data [D, H, W] or [D, H, W, C], bbox_min [3], bbox_max [3]).

    The file stores z slowest (x fastest); the axes returned are [z, y, x],
    the renderer's [D, H, W] grid convention."""
    with open(filename, "rb") as f:
        buf = f.read()
    if buf[:3] != b"VOL":
        raise ValueError(f"{filename}: not a .vol file")
    version = buf[3]
    if version != 3:
        raise ValueError(f"{filename}: unsupported .vol version {version}")
    dtype, sx, sy, sz, ch = struct.unpack_from("<iiiii", buf, 4)
    if dtype != 1:
        raise ValueError(".vol: only float32 (type 1) data is supported")
    bbox = struct.unpack_from("<6f", buf, 24)
    data = np.frombuffer(buf, np.float32, count=sx * sy * sz * ch,
                         offset=48)
    data = data.reshape(sz, sy, sx, ch)
    if ch == 1:
        data = data[..., 0]
    return data.copy(), np.array(bbox[:3], np.float32), \
        np.array(bbox[3:], np.float32)


def write_vol(filename, data, bbox_min=(0, 0, 0), bbox_max=(1, 1, 1)):
    """Write [D, H, W] or [D, H, W, C] float data as .vol version 3."""
    data = np.asarray(data, np.float32)
    if data.ndim == 3:
        data = data[..., None]
    sz, sy, sx, ch = data.shape
    with open(filename, "wb") as f:
        f.write(b"VOL" + bytes([3]))
        f.write(struct.pack("<iiiii", 1, sx, sy, sz, ch))
        f.write(struct.pack("<6f", *np.asarray(bbox_min, np.float32),
                            *np.asarray(bbox_max, np.float32)))
        f.write(data.tobytes())
