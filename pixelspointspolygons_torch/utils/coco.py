"""MS-COCO annotation handling: the subset of
pixelspointspolygons_tpu/utils/coco.py that the HiSup training slice needs
(`CocoIndex`, `seg_to_mask`, `poly_area`, `CATEGORY_ID`), as the port's own
copy. pycocotools is not used; polygons rasterize through cv2.fillPoly.
"""

from __future__ import annotations

import json
from typing import Any

import cv2
import numpy as np

CATEGORY_ID = 100  # the reference's fixed building category (coco_conversions.py:30)


class CocoIndex:
    def __init__(self, data: dict | str):
        if isinstance(data, str):
            with open(data) as f:
                data = json.load(f)
        self.dataset = data
        self.imgs = {img["id"]: img for img in data.get("images", [])}
        self.anns = {ann["id"]: ann for ann in data.get("annotations", [])}
        self.imgToAnns: dict[Any, list] = {img_id: [] for img_id in self.imgs}
        for ann in data.get("annotations", []):
            self.imgToAnns.setdefault(ann["image_id"], []).append(ann)
        self.cats = {c["id"]: c for c in data.get("categories", [])}

    def get_img_ids(self) -> list:
        return list(self.imgs.keys())


def seg_to_mask(segmentation, height: int, width: int) -> np.ndarray:
    """COCO polygon list → uint8 binary mask (RLE segmentations are not
    produced by the synthetic or P3 annotation files this slice reads)."""
    if isinstance(segmentation, dict):
        raise NotImplementedError("RLE segmentations: not needed by the HiSup training slice")
    mask = np.zeros((height, width), np.uint8)
    polys = [
        np.round(np.asarray(s, np.float64).reshape(-1, 2)).astype(np.int32)
        for s in segmentation
        if len(s) >= 6
    ]
    if polys:
        cv2.fillPoly(mask, polys, 1)
    return mask


def poly_area(pts: np.ndarray) -> float:
    """Signed shoelace area; pts (V, 2) as (x, y)."""
    x, y = pts[:, 0], pts[:, 1]
    return 0.5 * float(np.dot(x, np.roll(y, -1)) - np.dot(y, np.roll(x, -1)))
