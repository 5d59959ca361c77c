"""Self-contained COCO segm AP/AR evaluation (pycocotools COCOeval subset) —
the port's own copy of pixelspointspolygons_tpu/eval/cocoeval.py.

pycocotools is not used; this implements the exact protocol the
reference relies on (eval/evaluator.py:89-118: COCOeval iouType='segm',
catIds=[100] → AP, AP50, AP75, AP_S/M/L, AR1/10/100/S/M/L):

- IoU thresholds 0.50:0.05:0.95, recall thresholds 0:0.01:1 (101-pt),
- area ranges all/[0,32²]/[32²,96²]/[96²,1e10], maxDets 1/10/100,
- score-sorted greedy matching per threshold; unmatched dts outside the area
  range are ignored rather than counted as FPs,
- accumulate → precision envelope → AP = mean over recall grid.

Masks are rasterized from polygon segmentations per image (cv2).
"""

from __future__ import annotations

import numpy as np

from ..utils.coco import CocoIndex, seg_to_mask

IOU_THRS = np.round(np.arange(0.5, 1.0, 0.05), 2)
REC_THRS = np.round(np.linspace(0.0, 1.0, 101), 2)
AREA_RNG = {
    "all": (0.0, 1e10),
    "small": (0.0, 32.0**2),
    "medium": (32.0**2, 96.0**2),
    "large": (96.0**2, 1e10),
}
MAX_DETS = (1, 10, 100)


def _mask_iou(dt_masks: np.ndarray, gt_masks: np.ndarray, iscrowd=None) -> np.ndarray:
    """dt (D, H*W) bool, gt (G, H*W) bool → (D, G) IoU. For crowd gts the
    denominator is the dt area alone (pycocotools maskUtils.iou iscrowd
    semantics: a dt fully inside a crowd region scores IoU 1)."""
    if dt_masks.shape[0] == 0 or gt_masks.shape[0] == 0:
        return np.zeros((dt_masks.shape[0], gt_masks.shape[0]))
    inter = (dt_masks.astype(np.float32) @ gt_masks.T.astype(np.float32))
    a_dt = dt_masks.sum(1)[:, None].astype(np.float32)
    a_gt = gt_masks.sum(1)[None, :].astype(np.float32)
    union = a_dt + a_gt - inter
    if iscrowd is not None and np.any(iscrowd):
        union = np.where(np.asarray(iscrowd, bool)[None, :], a_dt, union)
    return inter / np.maximum(union, 1e-9)


def mask_to_boundary(mask: np.ndarray, dilation_ratio: float = 0.02) -> np.ndarray:
    """Boundary region of a binary mask: mask minus its erosion by
    `round(dilation_ratio · image_diagonal)` 3×3-erosion iterations, with 1px
    zero padding so mask truncated at the image border counts as boundary.
    This is the boundary-iou-api `mask_to_boundary` protocol the reference's
    `boundary-coco` mode relies on (reference eval/evaluator.py:121-141)."""
    import cv2

    h, w = mask.shape
    dilation = max(int(round(dilation_ratio * np.sqrt(h**2 + w**2))), 1)
    padded = np.pad(mask.astype(np.uint8), 1)
    kernel = np.ones((3, 3), np.uint8)
    eroded = cv2.erode(padded, kernel, iterations=dilation)[1 : h + 1, 1 : w + 1]
    return mask.astype(np.uint8) - eroded


def _evaluate_img(dts, gts, ious, area_rng, max_dets):
    """pycocotools evaluateImg logic for one (image, areaRng, maxDets)."""
    T = len(IOU_THRS)
    crowd = np.array([bool(g.get("iscrowd", 0)) for g in gts], bool)
    gt_ignore = crowd | np.array(
        [not (area_rng[0] <= g["area"] <= area_rng[1]) for g in gts], bool
    )
    # sort gts: non-ignored first
    g_order = np.argsort(gt_ignore, kind="stable")
    gts = [gts[i] for i in g_order]
    gt_ignore = gt_ignore[g_order]
    crowd = crowd[g_order]
    dts = dts[:max_dets]
    G, D = len(gts), len(dts)
    ious = ious[:D][:, g_order] if D and G else np.zeros((D, G))

    dt_matches = np.zeros((T, D), int)
    gt_matches = np.zeros((T, G), int)
    dt_ignore = np.zeros((T, D), bool)
    for t, thr in enumerate(IOU_THRS):
        for d in range(D):
            best_iou = min(thr, 1 - 1e-10)
            best_g = -1
            for g in range(G):
                # crowd gts may be matched by multiple dts (COCOeval :criteria)
                if gt_matches[t, g] and not crowd[g]:
                    continue
                # stop at ignored gts if a real match was already found
                if best_g > -1 and not gt_ignore[best_g] and gt_ignore[g]:
                    break
                if ious[d, g] < best_iou:
                    continue
                best_iou = ious[d, g]
                best_g = g
            if best_g == -1:
                continue
            dt_ignore[t, d] = gt_ignore[best_g]
            dt_matches[t, d] = 1
            gt_matches[t, best_g] = 1
    # unmatched dt outside area range → ignore
    dt_areas = np.array([d["area"] for d in dts])
    out_of_rng = (dt_areas < area_rng[0]) | (dt_areas > area_rng[1]) if D else np.zeros(0, bool)
    dt_ignore = dt_ignore | (dt_matches == 0) & out_of_rng[None, :]
    return {
        "dt_matches": dt_matches,
        "dt_ignore": dt_ignore,
        "dt_scores": np.array([d["score"] for d in dts]),
        "num_gt": int((~gt_ignore).sum()),
    }


class COCOEval:
    def __init__(
        self,
        coco_gt: CocoIndex,
        coco_dt: CocoIndex,
        cat_id: int = 100,
        iou_type: str = "segm",
        dilation_ratio: float = 0.02,
    ):
        """iou_type 'segm' (default) or 'boundary'. Boundary mode scores pairs
        by min(mask IoU, boundary IoU) — the Boundary AP protocol of the
        boundary-iou-api used by the reference's `boundary-coco` eval mode
        (reference eval/evaluator.py:121-141,259); stats keys get a 'b' prefix."""
        self.gt = coco_gt
        self.dt = coco_dt
        self.cat_id = cat_id
        self.iou_type = iou_type
        self.dilation_ratio = dilation_ratio

    def run(self) -> dict:
        img_ids = list(self.gt.imgs.keys())
        # per-image IoUs and per-(area, maxdet) eval results
        evals: dict = {}
        per_img = {}
        for img_id in img_ids:
            info = self.gt.imgs[img_id]
            h, w = info["height"], info["width"]
            gts = [g for g in self.gt.imgToAnns.get(img_id, []) if g.get("category_id", self.cat_id) == self.cat_id]
            dts = [d for d in self.dt.imgToAnns.get(img_id, []) if d.get("category_id", self.cat_id) == self.cat_id]
            dts = sorted(dts, key=lambda d: -d.get("score", 1.0))
            gm = np.stack(
                [seg_to_mask(g["segmentation"], h, w).reshape(-1) for g in gts]
            ) if gts else np.zeros((0, h * w), np.uint8)
            dm = np.stack(
                [seg_to_mask(d["segmentation"], h, w).reshape(-1) for d in dts]
            ) if dts else np.zeros((0, h * w), np.uint8)
            iscrowd = [bool(g.get("iscrowd", 0)) for g in gts]
            ious = _mask_iou(dm.astype(bool), gm.astype(bool), iscrowd)
            if self.iou_type == "boundary":
                gb = np.stack(
                    [mask_to_boundary(m.reshape(h, w), self.dilation_ratio).reshape(-1) for m in gm]
                ) if gts else gm
                db = np.stack(
                    [mask_to_boundary(m.reshape(h, w), self.dilation_ratio).reshape(-1) for m in dm]
                ) if dts else dm
                b_ious = _mask_iou(db.astype(bool), gb.astype(bool), iscrowd)
                ious = np.minimum(ious, b_ious)
            per_img[img_id] = (dts, gts, ious)

        stats = {}
        precision = {}
        recall = {}
        for a_name, a_rng in AREA_RNG.items():
            for md in MAX_DETS:
                results = [
                    _evaluate_img(d, g, i, a_rng, md) for (d, g, i) in per_img.values()
                ]
                precision[(a_name, md)], recall[(a_name, md)] = self._accumulate(results)

        def ap(a="all", md=100, thr=None):
            p = precision[(a, md)]  # (T, R)
            if thr is not None:
                p = p[np.isclose(IOU_THRS, thr)]
            valid = p > -1
            return float(p[valid].mean()) if valid.any() else -1.0

        def ar(a="all", md=100):
            r = recall[(a, md)]  # (T,)
            valid = r > -1
            return float(r[valid].mean()) if valid.any() else -1.0

        stats = {
            "AP": ap(),
            "AP50": ap(thr=0.5),
            "AP75": ap(thr=0.75),
            "AP_small": ap("small"),
            "AP_medium": ap("medium"),
            "AP_large": ap("large"),
            "AR1": ar(md=1),
            "AR10": ar(md=10),
            "AR100": ar(md=100),
            "AR_small": ar("small"),
            "AR_medium": ar("medium"),
            "AR_large": ar("large"),
        }
        if self.iou_type == "boundary":
            stats = {f"b{k}": v for k, v in stats.items()}
        return stats

    @staticmethod
    def _accumulate(results: list[dict]):
        T = len(IOU_THRS)
        R = len(REC_THRS)
        scores = np.concatenate([r["dt_scores"] for r in results]) if results else np.zeros(0)
        order = np.argsort(-scores, kind="mergesort")
        dtm = np.concatenate([r["dt_matches"] for r in results], axis=1)[:, order] if results else np.zeros((T, 0))
        dti = np.concatenate([r["dt_ignore"] for r in results], axis=1)[:, order] if results else np.zeros((T, 0), bool)
        npig = sum(r["num_gt"] for r in results)
        precision = -np.ones((T, R))
        recall = -np.ones((T,))
        if npig == 0:
            return precision, recall
        tps = (dtm == 1) & ~dti
        fps = (dtm == 0) & ~dti
        tp_sum = np.cumsum(tps, axis=1).astype(float)
        fp_sum = np.cumsum(fps, axis=1).astype(float)
        for t in range(T):
            tp, fp = tp_sum[t], fp_sum[t]
            nd = len(tp)
            rc = tp / npig
            pr = tp / np.maximum(tp + fp, np.finfo(float).eps)
            recall[t] = rc[-1] if nd else 0.0
            q = np.zeros(R)
            # precision envelope (monotone decreasing from the right)
            pr = pr.tolist()
            for i in range(nd - 1, 0, -1):
                if pr[i] > pr[i - 1]:
                    pr[i - 1] = pr[i]
            inds = np.searchsorted(rc, REC_THRS, side="left")
            for ri, pi in enumerate(inds):
                if pi < nd:
                    q[ri] = pr[pi]
            precision[t] = q
        return precision, recall
