"""ctypes bindings for the repository's LASzip codec (`native/laszip.cpp`) —
the port's own copy of pixelspointspolygons_tpu/native/laz.py
(`read_laz`, `write_laz`).

It decodes the x, y, z of COPC / LAS 1.4 `.laz` files (compressor 3
"layered chunked", POINT14 v3), the format the P3 dataset ships its LiDAR in
(the reference reads it through laspy[lazrs], datasets/p3_coco.py:78), and
encodes points in the same format (for fixtures and round trips; the
attributes that JAX's copy also reads and writes are not needed here). A
decode whose coordinates leave the header's bounding box by more than a
grid step raises instead of returning skewed points.

The library is compiled at first use, as the geometry library is
(`native.py::build_shared`): with g++ into `build/torch_kernels/` under the
repository root, named with a hash of the source, never into `native/`. A
failed build raises; there is no switch that turns the LAZ path off.
"""

from __future__ import annotations

import ctypes
import functools
import os
import struct

import numpy as np

from . import native

SOURCE = os.path.join(os.path.dirname(native.SOURCE), "laszip.cpp")
CHUNK_SIZE = 50000  # points per LASzip chunk, as JAX's writer


@functools.cache
def load() -> ctypes.CDLL:
    lib = ctypes.CDLL(native.build_shared(SOURCE, "libp3laszip"))
    lib.p3laz_npoints.restype = ctypes.c_int64
    lib.p3laz_npoints.argtypes = [ctypes.c_void_p, ctypes.c_int64]
    lib.p3laz_read_points.restype = ctypes.c_int64
    lib.p3laz_read_points.argtypes = [ctypes.c_void_p] * 9 + [ctypes.c_void_p, ctypes.c_int64]
    lib.p3laz_write_points.restype = ctypes.c_int64
    lib.p3laz_write_points.argtypes = [
        ctypes.c_void_p,  # XYZ int32
        ctypes.c_void_p,  # intensity u16
        ctypes.c_void_p,  # return numbers u8
        ctypes.c_void_p,  # classification u8
        ctypes.c_void_p,  # gps time f64
        ctypes.c_int64,
        ctypes.c_void_p,  # scale f64[3]
        ctypes.c_void_p,  # offset f64[3]
        ctypes.c_uint32,
        ctypes.c_void_p,  # map6 override
        ctypes.c_void_p,  # lvl8 override
        ctypes.c_void_p,  # out
        ctypes.c_int64,
    ]
    lib.p3laz_last_error.restype = ctypes.c_char_p
    return lib


def _header_bbox(buf: bytes):
    """(mins, maxs, scale) from the LAS header (max_x, min_x, ... order)."""
    bb = struct.unpack("<6d", buf[179:227])
    scale = struct.unpack("<3d", buf[131:155])
    return np.array([bb[1], bb[3], bb[5]]), np.array([bb[0], bb[2], bb[4]]), np.array(scale)


def _ptr(a: np.ndarray):
    return a.ctypes.data_as(ctypes.c_void_p)


def read_laz(path: str) -> np.ndarray:
    """The (N, 3) float64 x, y, z of a .laz/.copc.laz (or point-format >= 6
    .las) file."""
    lib = load()
    with open(path, "rb") as f:
        raw = np.frombuffer(f.read(), np.uint8)
    pbuf = raw.ctypes.data_as(ctypes.c_void_p)
    n = lib.p3laz_npoints(pbuf, len(raw))
    if n < 0:
        raise ValueError(f"{path}: {lib.p3laz_last_error().decode()}")
    xyz = np.empty((n, 3), np.float64)
    got = lib.p3laz_read_points(pbuf, len(raw), None, None, _ptr(xyz), None, None, None, None, None, n)
    if got != n:
        raise ValueError(f"{path}: {lib.p3laz_last_error().decode()}")
    if n:
        # the decoded extent must match the header's box up to one grid step
        # (writers quantize the box to the grid)
        mins, maxs, scale = _header_bbox(raw[:375].tobytes())
        tol = np.maximum(np.abs(scale) * 2, 1e-6)
        lo, hi = xyz.min(axis=0), xyz.max(axis=0)
        if np.any(lo < mins - tol) or np.any(hi > maxs + tol):
            raise ValueError(f"{path}: decoded extent {lo}..{hi} violates the header's box {mins}..{maxs}; "
                             "refusing a possibly corrupt decode")
    return xyz


def write_laz(path: str, xyz: np.ndarray, scale=(0.01, 0.01, 0.01), offset=None) -> int:
    """Encode float64 (N, 3) points, on a grid of `scale` from `offset` (the
    floor of their minimum by default), into a .laz file with no other
    attributes. Returns the bytes written."""
    lib = load()
    xyz = np.asarray(xyz, np.float64)
    n = len(xyz)
    scale = np.asarray(scale, np.float64)
    if offset is None:
        offset = np.floor(xyz.min(axis=0)) if n else np.zeros(3)
    offset = np.asarray(offset, np.float64)
    XYZ = np.ascontiguousarray(np.round((xyz - offset) / scale).astype(np.int32))
    cap = n * 64 + 65536
    out = np.empty(cap, np.uint8)
    size = lib.p3laz_write_points(_ptr(XYZ), None, None, None, None, n, _ptr(scale), _ptr(offset), CHUNK_SIZE, None,
                                  None, _ptr(out), cap)
    if size <= 0:
        raise ValueError(lib.p3laz_last_error().decode() or f"buffer: need {-size}")
    with open(path, "wb") as f:
        f.write(out[:size].tobytes())
    return int(size)
