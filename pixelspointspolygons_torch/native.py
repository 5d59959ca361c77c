"""ctypes bindings for the repository's native geometry code
(`native/geometry.cpp`) — the port's own copy of
pixelspointspolygons_tpu/native/__init__.py (:76-121).

- `find_contours(image, level)`: subpixel marching squares, skimage-style
  (y, x) polylines with closed-ring detection;
- `douglas_peucker_native(points, tol)`: polyline simplification.

The library is compiled at first use with `g++ -O3 -shared -fPIC
-std=c++17` into `build/torch_kernels/` under the repository root, under a
name that carries a hash of the source and flags (as `ops/build.py` names
the CUDA kernels), so an edited source is never served by a stale build.
Nothing is written under `native/`. A failed build raises: the cv2 tracing
that could stand in gives other contours, so the polygons would differ from
the JAX package's.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import subprocess

import numpy as np

from .ops.build import BUILD_DIR

SOURCE = os.path.join(os.path.dirname(os.path.dirname(BUILD_DIR)), "native", "geometry.cpp")
CXX_FLAGS = ("-O3", "-shared", "-fPIC", "-std=c++17")
# output capacity of one find_contours call (JAX :81-83)
MAX_CONTOURS = 4096


def library_path() -> str:
    h = hashlib.sha1()
    with open(SOURCE, "rb") as f:
        h.update(f.read())
    h.update(" ".join(CXX_FLAGS).encode())
    return os.path.join(BUILD_DIR, f"libp3geometry-{h.hexdigest()[:12]}.so")


def build() -> str:
    """Compile the library unless it is built; returns its path. Raises
    RuntimeError when g++ is missing or fails."""
    out = library_path()
    if os.path.isfile(out):
        return out
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{out}.tmp{os.getpid()}"
    try:
        proc = subprocess.run(["g++", *CXX_FLAGS, "-o", tmp, SOURCE], capture_output=True, text=True)
    except FileNotFoundError as e:
        raise RuntimeError("the native geometry library needs g++, which is not installed") from e
    if proc.returncode != 0:
        raise RuntimeError(f"g++ exited {proc.returncode} building {SOURCE}:\n{proc.stderr}")
    os.replace(tmp, out)  # atomic: a concurrent build never loads a partial file
    return out


@functools.cache
def load() -> ctypes.CDLL:
    lib = ctypes.CDLL(build())
    lib.p3_marching_squares.restype = ctypes.c_int
    lib.p3_marching_squares.argtypes = [
        ctypes.POINTER(ctypes.c_float),
        ctypes.c_int,
        ctypes.c_int,
        ctypes.c_float,
        ctypes.POINTER(ctypes.c_double),
        ctypes.c_int64,
        ctypes.POINTER(ctypes.c_int32),
        ctypes.POINTER(ctypes.c_uint8),
        ctypes.c_int32,
    ]
    lib.p3_douglas_peucker.restype = ctypes.c_int
    lib.p3_douglas_peucker.argtypes = [
        ctypes.POINTER(ctypes.c_double),
        ctypes.c_int,
        ctypes.c_double,
        ctypes.POINTER(ctypes.c_int32),
    ]
    return lib


class ContourOverflow(RuntimeError):
    """More contour points or contours than one call's buffers hold."""


def find_contours(image: np.ndarray, level: float) -> list[tuple[np.ndarray, bool]]:
    """Subpixel iso-contours of a 2-D map. Returns [((V, 2) float64 (y, x),
    closed)]; a closed ring repeats its first point. Raises ContourOverflow
    (a RuntimeError, as JAX's overflow is) past the buffers' capacity."""
    lib = load()
    img = np.ascontiguousarray(image, np.float32)
    if img.ndim != 2:
        raise ValueError(f"find_contours takes a 2-D map, got shape {img.shape}")
    H, W = img.shape
    max_pts = 4 * H * W + 1024
    pts = np.empty((max_pts, 2), np.float64)
    sizes = np.empty((MAX_CONTOURS,), np.int32)
    closed = np.empty((MAX_CONTOURS,), np.uint8)
    n = lib.p3_marching_squares(
        img.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        H,
        W,
        ctypes.c_float(level),
        pts.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
        max_pts,
        sizes.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        closed.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        MAX_CONTOURS,
    )
    if n < 0:
        raise ContourOverflow("marching squares output overflow")
    out = []
    off = 0
    for i in range(n):
        k = int(sizes[i])
        out.append((pts[off : off + k].copy(), bool(closed[i])))
        off += k
    return out


def douglas_peucker_native(points: np.ndarray, tol: float) -> np.ndarray:
    lib = load()
    pts = np.ascontiguousarray(points, np.float64)
    if pts.ndim != 2 or pts.shape[1] != 2:
        raise ValueError(f"douglas_peucker_native takes (N, 2) points, got shape {pts.shape}")
    keep = np.empty((len(pts),), np.int32)
    m = lib.p3_douglas_peucker(
        pts.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
        len(pts),
        ctypes.c_double(tol),
        keep.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
    )
    return pts[keep[:m]]
