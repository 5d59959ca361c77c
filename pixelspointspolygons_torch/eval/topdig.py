"""The port's own copy of pixelspointspolygons_tpu/eval/topdig.py.

TopDIG-style pixel metrics: accuracy / precision / recall / F1 / mask IoU
on rasterized prediction vs GT masks (reference eval/topdig_metrics.py,
which uses torchmetrics — here plain numpy over the same rasterization)."""

from __future__ import annotations

import numpy as np

from ..utils.coco import CocoIndex, seg_to_mask


def compute_topdig_metrics(coco_gt: CocoIndex, coco_dt: CocoIndex) -> dict:
    tp = fp = fn = tn = 0
    for img_id in coco_gt.imgs:
        info = coco_gt.imgs[img_id]
        h, w = info["height"], info["width"]
        gt = np.zeros((h, w), bool)
        for a in coco_gt.imgToAnns.get(img_id, []):
            gt |= seg_to_mask(a["segmentation"], h, w).astype(bool)
        dt = np.zeros((h, w), bool)
        for a in coco_dt.imgToAnns.get(img_id, []):
            dt |= seg_to_mask(a["segmentation"], h, w).astype(bool)
        tp += int((dt & gt).sum())
        fp += int((dt & ~gt).sum())
        fn += int((~dt & gt).sum())
        tn += int((~dt & ~gt).sum())
    prec = tp / max(tp + fp, 1)
    rec = tp / max(tp + fn, 1)
    return {
        "pixel_acc": (tp + tn) / max(tp + tn + fp + fn, 1),
        "pixel_precision": prec,
        "pixel_recall": rec,
        "pixel_f1": 2 * prec * rec / max(prec + rec, 1e-9),
        "mask_iou": tp / max(tp + fp + fn, 1),
    }
