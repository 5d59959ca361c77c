"""The port's own copy of pixelspointspolygons_tpu/eval/juncs.py.

Junction AP: precision/recall of predicted polygon vertices against GT
vertices (reference eval/juncs_eval.py, HiSup legacy): a predicted vertex is
a true positive if within `thresh` px of an unmatched GT vertex; AP is
computed over score-ranked vertices (scores inherit the polygon score)."""

from __future__ import annotations

import numpy as np
from scipy.spatial.distance import cdist

from ..utils.coco import CocoIndex


def _vertices(anns) -> tuple[np.ndarray, np.ndarray]:
    pts, scores = [], []
    for a in anns:
        for seg in a.get("segmentation", []):
            p = np.asarray(seg, np.float64).reshape(-1, 2)
            if len(p) > 1 and np.allclose(p[0], p[-1]):
                p = p[:-1]
            pts.append(p)
            scores.append(np.full(len(p), a.get("score", 1.0)))
    if not pts:
        return np.zeros((0, 2)), np.zeros((0,))
    return np.concatenate(pts), np.concatenate(scores)


def compute_junction_metrics(coco_gt: CocoIndex, coco_dt: CocoIndex, thresh: float = 5.0) -> dict:
    all_tp, all_scores = [], []
    n_gt = 0
    for img_id in coco_gt.imgs:
        gt_pts, _ = _vertices(coco_gt.imgToAnns.get(img_id, []))
        dt_pts, dt_scores = _vertices(coco_dt.imgToAnns.get(img_id, []))
        n_gt += len(gt_pts)
        if len(dt_pts) == 0:
            continue
        order = np.argsort(-dt_scores)
        matched = np.zeros(len(gt_pts), bool)
        tp = np.zeros(len(dt_pts), bool)
        if len(gt_pts):
            d = cdist(dt_pts, gt_pts)
            for i in order:
                j = int(np.argmin(d[i] + matched * 1e9))
                if d[i, j] < thresh and not matched[j]:
                    matched[j] = True
                    tp[i] = True
        all_tp.append(tp[order])
        all_scores.append(dt_scores[order])
    if not all_scores or n_gt == 0:
        return {"junc_AP": 0.0, "junc_precision": 0.0, "junc_recall": 0.0}
    tp = np.concatenate(all_tp)
    scores = np.concatenate(all_scores)
    order = np.argsort(-scores, kind="mergesort")
    tp = tp[order]
    cum_tp = np.cumsum(tp)
    cum_fp = np.cumsum(~tp)
    rec = cum_tp / n_gt
    prec = cum_tp / np.maximum(cum_tp + cum_fp, 1)
    # 101-pt interpolated AP
    ap = 0.0
    for t in np.linspace(0, 1, 101):
        mask = rec >= t
        ap += prec[mask].max() if mask.any() else 0.0
    return {
        "junc_AP": float(ap / 101),
        "junc_precision": float(prec[-1]) if len(prec) else 0.0,
        "junc_recall": float(rec[-1]) if len(rec) else 0.0,
    }
