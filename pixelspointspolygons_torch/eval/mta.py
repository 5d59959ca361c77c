"""Max tangent-angle error (MTA) — the port's own copy of
pixelspointspolygons_tpu/eval/mta.py.

Behavioral spec: reference eval/angle_eval.py:30-200 — predicted polygons
with ≥0.5 pixel-precision against the GT union are contour-sampled at 2.0 px
spacing, each sample is projected to the nearest point on the GT contours,
consecutive-sample edge directions are compared (dropping zero-length and
>2x-stretched projections), and the per-polygon MAX angle difference is
collected; the metric reports the mean of those maxima in degrees.

shapely-free implementation: precision via cv2 raster masks, projection via
exact point-to-segment nearest points. (The reference's unary_union polygon
"fixing" is skipped — self-touching predictions are evaluated as-is.)
"""

from __future__ import annotations

import numpy as np
import cv2

from ..utils.coco import CocoIndex
from .metrics import _ann_rings, densify_ring

SAMPLING_SPACING = 2.0
MIN_PRECISION = 0.5
MAX_STRETCH = 2.0


def _project_to_rings(points: np.ndarray, rings: list[np.ndarray]) -> np.ndarray:
    """Nearest point on any ring for each query point."""
    best_d = np.full(len(points), np.inf)
    best_p = np.zeros_like(points)
    for ring in rings:
        a = ring
        b = np.roll(ring, -1, axis=0)
        d = b - a
        norm2 = np.maximum((d**2).sum(1), 1e-12)
        ap = points[:, None, :] - a[None]
        t = np.clip((ap * d[None]).sum(-1) / norm2[None], 0.0, 1.0)
        proj = a[None] + t[..., None] * d[None]  # (P, V, 2)
        dist = ((points[:, None, :] - proj) ** 2).sum(-1)
        j = dist.argmin(1)
        dmin = dist[np.arange(len(points)), j]
        upd = dmin < best_d
        best_d = np.where(upd, dmin, best_d)
        best_p[upd] = proj[np.arange(len(points)), j][upd]
    return best_p


def _polygon_max_angle(pred_ring: np.ndarray, gt_rings: list[np.ndarray]) -> float | None:
    samples = densify_ring(pred_ring, SAMPLING_SPACING)
    samples = np.concatenate([samples, samples[:1]], axis=0)  # closed
    proj = _project_to_rings(samples, gt_rings)
    edges = np.diff(samples, axis=0)
    proj_edges = np.diff(proj, axis=0)
    en = np.linalg.norm(edges, axis=1)
    pn = np.linalg.norm(proj_edges, axis=1)
    ok = (en * pn) > 0
    edges, proj_edges, en, pn = edges[ok], proj_edges[ok], en[ok], pn[ok]
    if len(edges) == 0:
        return None
    stretch = en / pn
    ok = (1 / MAX_STRETCH < stretch) & (stretch < MAX_STRETCH)
    edges, proj_edges, en, pn = edges[ok], proj_edges[ok], en[ok], pn[ok]
    if len(edges) == 0:
        return None
    cos = (edges * proj_edges).sum(1) / (en * pn)
    angles = np.arccos(np.clip(cos, -1.0, 1.0))
    return float(angles.max())


def compute_mta(coco_gt: CocoIndex, coco_dt: CocoIndex) -> dict:
    max_angles: list[float] = []
    for img_id in coco_gt.imgs:
        info = coco_gt.imgs[img_id]
        h, w = info["height"], info["width"]
        gt_rings = [
            r for ann in coco_gt.imgToAnns.get(img_id, []) for r in _ann_rings(ann)
        ]
        dt_rings = [
            r for ann in coco_dt.imgToAnns.get(img_id, []) for r in _ann_rings(ann)
        ]
        if not gt_rings or not dt_rings:
            continue
        gt_mask = np.zeros((h, w), np.uint8)
        for r in gt_rings:
            cv2.fillPoly(gt_mask, [np.round(r).astype(np.int32)], 1)
        for ring in dt_rings:
            m = np.zeros((h, w), np.uint8)
            cv2.fillPoly(m, [np.round(ring).astype(np.int32)], 1)
            area = m.sum()
            if area == 0:
                continue
            precision = (m & gt_mask).sum() / area
            if precision <= MIN_PRECISION:
                continue
            v = _polygon_max_angle(ring, gt_rings)
            if v is not None:
                max_angles.append(v)
    arr = np.degrees(np.asarray(max_angles))
    return {
        "mta": float(arr.mean()) if len(arr) else float("nan"),
        "mta_median": float(np.median(arr)) if len(arr) else float("nan"),
        "num_polygons": int(len(arr)),
    }
