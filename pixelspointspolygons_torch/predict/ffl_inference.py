"""FFL sliding-window (patched) inference with distance-weighted blending —
the port's copy of pixelspointspolygons_tpu/predict/ffl_inference.py.

Behavioral spec: reference predict/ffl/inference.py:57-118 — a large raster
is split into overlapping patches (stride = patch_size − patch_overlap),
each patch's seg/crossfield predictions are accumulated with an EDT-based
weight window (zero at patch borders, growing inward), then normalized by
the accumulated weight map. Patch weights use cv2.distanceTransform (the
scipy EDT equivalent)."""

from __future__ import annotations

import cv2
import numpy as np


def compute_patch_boundingboxes(shape: tuple[int, int], stride: int, patch_res: int):
    """(y0, x0, y2, x2) boxes covering `shape`, last row/col snapped inside
    (reference lydorn_utils image_utils.compute_patch_boundingboxes)."""
    h, w = shape
    ys = list(range(0, max(h - patch_res, 0) + 1, stride))
    xs = list(range(0, max(w - patch_res, 0) + 1, stride))
    if not ys or ys[-1] + patch_res < h:
        ys.append(max(h - patch_res, 0))
    if not xs or xs[-1] + patch_res < w:
        xs.append(max(w - patch_res, 0))
    return [(y, x, min(y + patch_res, h), min(x + patch_res, w)) for y in ys for x in xs]


def patch_weight_window(patch_res: int) -> np.ndarray:
    """EDT window: distance from the (padded) patch border."""
    w = np.ones((patch_res + 2, patch_res + 2), np.uint8)
    w[0, :] = 0
    w[-1, :] = 0
    w[:, 0] = 0
    w[:, -1] = 0
    d = cv2.distanceTransform(w, cv2.DIST_L2, 5).astype(np.float32)
    return d[1:-1, 1:-1]


def inference_with_patching(forward_fn, images: np.ndarray, patch_size: int, patch_overlap: int):
    """forward_fn(patch (1, p, p, 3)) → {"seg": (1, Cs, p, p), "crossfield":
    (1, 4, p, p)}. images: (1, H, W, 3). Returns blended full-size outputs."""
    assert images.shape[0] == 1, "patched inference runs single-tile"
    H, W = images.shape[1:3]
    stride = patch_size - patch_overlap
    boxes = compute_patch_boundingboxes((H, W), stride, patch_size)
    weights = patch_weight_window(patch_size)[None, None]

    acc: dict[str, np.ndarray] = {}
    wmap = np.zeros((1, 1, H, W), np.float32)
    for y0, x0, y1, x1 in boxes:
        patch = images[:, y0:y1, x0:x1]
        out = forward_fn(patch)
        pw = weights[:, :, : y1 - y0, : x1 - x0]
        for k, v in out.items():
            v = np.asarray(v, np.float32)
            if k not in acc:
                acc[k] = np.zeros((1, v.shape[1], H, W), np.float32)
            acc[k][:, :, y0:y1, x0:x1] += pw * v
        wmap[:, :, y0:y1, x0:x1] += pw
    return {k: v / np.maximum(wmap, 1e-6) for k, v in acc.items()}


def save_geojson(polygons: list[np.ndarray], path: str) -> None:
    """Polygon list ((V, 2) xy open rings) → GeoJSON GeometryCollection
    (reference save_utils.save_geojson)."""
    import json
    import os

    geoms = []
    for poly in polygons:
        ring = np.asarray(poly, np.float64)
        closed = np.concatenate([ring, ring[:1]], axis=0)
        geoms.append(
            {"type": "Polygon", "coordinates": [np.round(closed, 2).tolist()]}
        )
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with open(path, "w") as f:
        json.dump({"type": "GeometryCollection", "geometries": geoms}, f)
