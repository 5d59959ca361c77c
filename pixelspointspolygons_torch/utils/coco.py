"""MS-COCO annotation handling — the port's own copy of
pixelspointspolygons_tpu/utils/coco.py. pycocotools is not used:

- `CocoIndex`: imgs / anns / imgToAnns index over a COCO dict or json file,
  and `load_res` (COCO.loadRes) for prediction files;
- polygon → binary mask rasterization (cv2.fillPoly, crowd-free);
- RLE encode/decode (uncompressed counts, and the pycocotools string form);
- `generate_coco_ann` / `save_annotations` for writing predictions.
"""

from __future__ import annotations

import json
import os
from typing import Any, Iterable

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

    def load_imgs(self, ids) -> list:
        if not isinstance(ids, (list, tuple)):
            ids = [ids]
        return [self.imgs[i] for i in ids]

    def ann_to_mask(self, ann: dict, height: int | None = None, width: int | None = None) -> np.ndarray:
        img = self.imgs.get(ann["image_id"], {})
        h = height or img.get("height")
        w = width or img.get("width")
        return seg_to_mask(ann["segmentation"], h, w)

    def load_res(self, results: list[dict] | str) -> "CocoIndex":
        """Build a prediction index sharing this GT's images (COCO.loadRes)."""
        if isinstance(results, str):
            with open(results) as f:
                results = json.load(f)
        data = {
            "images": list(self.imgs.values()),
            "categories": list(self.cats.values()) or [{"id": CATEGORY_ID, "name": "building"}],
            "annotations": [],
        }
        for i, r in enumerate(results):
            r = dict(r)
            r.setdefault("id", i + 1)
            if "area" not in r and isinstance(r.get("segmentation"), list):
                r["area"] = sum(abs(poly_area(np.asarray(s).reshape(-1, 2))) for s in r["segmentation"])
            if "bbox" not in r and isinstance(r.get("segmentation"), list):
                pts = np.concatenate([np.asarray(s).reshape(-1, 2) for s in r["segmentation"]])
                x0, y0 = pts.min(0)
                x1, y1 = pts.max(0)
                r["bbox"] = [float(x0), float(y0), float(x1 - x0), float(y1 - y0)]
            data["annotations"].append(r)
        return CocoIndex(data)


def seg_to_mask(segmentation, height: int, width: int) -> np.ndarray:
    """COCO polygon list (or RLE dict) → uint8 binary mask."""
    if isinstance(segmentation, dict):
        return rle_decode(segmentation)
    mask = np.zeros((height, width), np.uint8)
    polys = [
        np.round(np.asarray(s, np.float64).reshape(-1, 2)).astype(np.int32)
        for s in segmentation
        if len(s) >= 6
    ]
    if polys:
        cv2.fillPoly(mask, polys, 1)
    return mask


def rle_encode(mask: np.ndarray, compressed: bool = False) -> dict:
    """Column-major RLE (pycocotools layout); compressed=True emits the
    pycocotools 6-bit string encoding."""
    h, w = mask.shape
    flat = np.asarray(mask, np.uint8).flatten(order="F")
    # counts alternate 0-runs and 1-runs, starting with a 0-run
    change = np.nonzero(np.diff(flat))[0] + 1
    runs = np.diff(np.concatenate([[0], change, [flat.size]]))
    counts = runs.tolist()
    if flat.size and flat[0] == 1:
        counts = [0] + counts
    if compressed:
        return {"size": [h, w], "counts": rle_string_encode(counts)}
    return {"size": [h, w], "counts": counts}


def rle_string_encode(counts: list[int]) -> str:
    """pycocotools rleToString: delta-coded counts (from the 3rd element) in
    6-bit ascii chunks (base char 48, 0x20 continuation, sign-extended)."""
    out = []
    for i, x in enumerate(counts):
        if i > 2:
            x -= counts[i - 2]
        more = True
        while more:
            c = x & 0x1F
            x >>= 5
            more = (x != -1) if (c & 0x10) else (x != 0)
            if more:
                c |= 0x20
            out.append(chr(c + 48))
    return "".join(out)


def rle_string_decode(s: str | bytes) -> list[int]:
    """pycocotools rleFrString, the inverse of rle_string_encode."""
    if isinstance(s, bytes):
        s = s.decode("ascii")
    counts: list[int] = []
    i = 0
    while i < len(s):
        x = 0
        k = 0
        more = True
        while more:
            c = ord(s[i]) - 48
            x |= (c & 0x1F) << (5 * k)
            more = bool(c & 0x20)
            i += 1
            k += 1
            if not more and (c & 0x10):
                x |= -1 << (5 * k)
        if len(counts) > 2:
            x += counts[-2]
        counts.append(x)
    return counts


def rle_decode(rle: dict) -> np.ndarray:
    h, w = rle["size"]
    counts = rle["counts"]
    if isinstance(counts, (bytes, str)):
        counts = rle_string_decode(counts)  # compressed RLE (pycocotools _mask.pyx)
    flat = np.zeros(h * w, np.uint8)
    pos = 0
    val = 0
    for c in counts:
        flat[pos : pos + c] = val
        pos += c
        val ^= 1
    return flat.reshape((h, w), order="F")


def poly_area(pts: np.ndarray) -> float:
    """Signed shoelace area; pts (V, 2) as (x, y)."""
    x, y = pts[:, 0], pts[:, 1]
    return 0.5 * float(np.dot(x, np.roll(y, -1)) - np.dot(y, np.roll(x, -1)))


def generate_coco_ann(polygons: Iterable[np.ndarray], image_id, scores=None) -> list[dict]:
    """Polygons → COCO prediction dicts (reference coco_conversions.py:21-38:
    category_id=100, score 1.0 unless given).

    polygons: iterable of (V, 2) arrays in (x, y) pixel coords, open rings.
    """
    anns = []
    for k, poly in enumerate(polygons):
        poly = np.asarray(poly, np.float64)
        if len(poly) < 3:
            continue
        seg = poly.reshape(-1).tolist()
        x0, y0 = poly.min(0)
        x1, y1 = poly.max(0)
        anns.append(
            {
                "image_id": int(image_id),
                "category_id": CATEGORY_ID,
                "segmentation": [seg],
                "bbox": [float(x0), float(y0), float(x1 - x0), float(y1 - y0)],
                "area": abs(poly_area(poly)),
                "score": float(scores[k]) if scores is not None else 1.0,
            }
        )
    return anns


def save_annotations(anns: list[dict], path: str) -> None:
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with open(path, "w") as f:
        json.dump(anns, f)
