"""RGL ``tensor_file`` reading and writing — the port's copy of
``mitsuba3_tpu/utils/tensor_io.py`` (numpy and ``struct`` only).

Binary layout (little-endian):
  bytes 0-11   magic ``tensor_file\\0``
  bytes 12-13  version (1, 0)
  uint32       field count
  per field:   uint16 name length, name bytes, uint16 ndim, uint8 dtype,
               uint64 data offset, ndim x uint64 shape
  field data at the recorded offsets.

The measured BSDF reads its ``.bsdf`` files (rgl.epfl.ch/materials) with
it; ``write`` makes such files (the tests' and ``chip_smoke.py``'s
synthetic tables).
"""
from __future__ import annotations

import struct

import numpy as np

_MAGIC = b"tensor_file\x00"

# dtype enum of the reference's sj::Type (tensor.cpp:44)
_DTYPES = {
    1: np.uint8, 2: np.int8, 3: np.uint16, 4: np.int16,
    5: np.uint32, 6: np.int32, 7: np.uint64, 8: np.int64,
    9: np.float16, 10: np.float32, 11: np.float64,
}
_DTYPE_IDS = {np.dtype(v): k for k, v in _DTYPES.items()}


def read(filename):
    """-> dict name -> np.ndarray."""
    with open(filename, "rb") as f:
        buf = f.read()
    if buf[:12] != _MAGIC:
        raise ValueError(f"{filename}: not a tensor_file")
    n_fields = struct.unpack_from("<I", buf, 14)[0]
    pos = 18
    out = {}
    for _ in range(n_fields):
        (name_len,) = struct.unpack_from("<H", buf, pos)
        pos += 2
        name = buf[pos:pos + name_len].decode()
        pos += name_len
        ndim, dtype_id = struct.unpack_from("<HB", buf, pos)
        pos += 3
        (offset,) = struct.unpack_from("<Q", buf, pos)
        pos += 8
        shape = struct.unpack_from(f"<{ndim}Q", buf, pos)
        pos += 8 * ndim
        dt = np.dtype(_DTYPES[dtype_id])
        count = int(np.prod(shape)) if ndim else 1
        arr = np.frombuffer(buf, dt, count=count, offset=offset)
        out[name] = arr.reshape(shape).copy()
    return out


def write(filename, **fields):
    """Write arrays as a tensor_file (tensor_io.py write counterpart)."""
    names = sorted(fields)
    header = bytearray()
    header += _MAGIC
    header += struct.pack("<BB", 1, 0)
    header += struct.pack("<I", len(names))
    # first pass to size the header
    fixed = len(header)
    for name in names:
        fixed += 2 + len(name.encode()) + 3 + 8 + 8 * fields[name].ndim
    offset = fixed
    body = bytearray()
    metas = []
    for name in names:
        arr = np.ascontiguousarray(fields[name])
        dt = np.dtype(arr.dtype)
        if dt not in _DTYPE_IDS:
            arr = arr.astype(np.float32)
            dt = np.dtype(np.float32)
        metas.append((name, arr, _DTYPE_IDS[dt], offset))
        body += arr.tobytes()
        offset += arr.nbytes
    for name, arr, dtype_id, off in metas:
        nb = name.encode()
        header += struct.pack("<H", len(nb)) + nb
        header += struct.pack("<HB", arr.ndim, dtype_id)
        header += struct.pack("<Q", off)
        header += struct.pack(f"<{arr.ndim}Q", *arr.shape)
    assert len(header) == fixed
    with open(filename, "wb") as f:
        f.write(bytes(header) + bytes(body))
