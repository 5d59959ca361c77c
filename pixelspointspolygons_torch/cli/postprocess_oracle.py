"""Polygonization-quality oracle: each family's full post-processing on
outputs that the ground truth implies, scored against that ground truth
— twin of scripts/postprocess_oracle.py. The numbers are the ceiling any
trained model can reach through that post-processing.

- ffl: the ground truth's interior (blurred) as seg and the analytic
  crossfield of its angle field through the `Polygonizer` (the config's
  methods: acm, asm, simple), one row per method and tolerance;
- hisup: the ground truth's mask and polygon vertices through
  `polygons_from_masks`;
- pix2poly: the ground truth's tokens and one-hot permutation through the
  Hungarian assignment and the chain merge.

The Pix2Poly branch composes its own config from four overrides, as the
script's does: the command line does not reach its dataset, whose root
comes from `P3_DATASET_ROOT` or `./data` (ROADMAP 3.20).

Usage: python -m pixelspointspolygons_torch.cli.postprocess_oracle [model=ffl|hisup|pix2poly|all]
    [n=12] [channels=1] [key.path=value ...] [device=cpu]

The FFL branch's ACM and ASM run on the card; `device=cpu` runs them on
the CPU. The HiSup and Pix2Poly branches are host code.
"""

from __future__ import annotations

import json

import cv2
import numpy as np
import torch

from ..config.engine import compose
from ..device import resolve_device, set_deterministic
from ..utils.coco import CocoIndex, generate_coco_ann
from ._common import print_line, run, split_device


def _subset_index(gt: CocoIndex, img_ids: list) -> CocoIndex:
    return CocoIndex(
        {
            "images": [gt.imgs[i] for i in img_ids],
            "annotations": [a for i in img_ids for a in gt.imgToAnns[i]],
            "categories": list(gt.cats.values()),
        }
    )


def _score(gt_sub: CocoIndex, preds: list[dict]) -> dict:
    from ..eval.metrics import compute_iou_ciou

    return {k: round(v, 4) for k, v in compute_iou_ciou(gt_sub, gt_sub.load_res(preds)).items()}


def ffl_maps(cfg, gt: CocoIndex, img_ids: list, n_ch: int = 1) -> tuple[np.ndarray, np.ndarray]:
    """seg (B, n_ch, S, S) and crossfield (B, 4, S, S), float32, with the
    script's numpy and cv2 calls in its order: the same bits."""
    from ..data.ffl_gt import compute_ffl_gt

    S = int(cfg.experiment.encoder.in_size)
    B = len(img_ids)
    # n_ch=1 is the production config (model.seg.compute_edge: false);
    # channels=2 drives the ASM's edge-channel path
    seg = np.zeros((B, n_ch, S, S), np.float32)
    cf = np.zeros((B, 4, S, S), np.float32)
    for i, img_id in enumerate(img_ids):
        polys = [np.asarray(a["segmentation"][0], np.float64).reshape(-1, 2) for a in gt.imgToAnns[img_id]]
        g = compute_ffl_gt(polys, S, S)
        interior = g["gt_polygons_image"][..., 0].astype(np.float32) / 255.0
        seg[i, 0] = cv2.GaussianBlur(interior, (5, 5), 1.2)
        if n_ch > 1:
            edge = g["gt_polygons_image"][..., 1].astype(np.float32) / 255.0
            seg[i, 1] = cv2.GaussianBlur(edge, (5, 5), 1.2)
        angle = g["gt_crossfield_angle"].astype(np.float32) * np.pi / 255.0
        u = np.exp(1j * angle)
        v = 1j * u
        cf[i] = np.stack(
            [((u**2) * (v**2)).real, ((u**2) * (v**2)).imag, (-(u**2 + v**2)).real, (-(u**2 + v**2)).imag]
        )
    return seg, cf


def oracle_ffl(cfg, gt: CocoIndex, img_ids: list, n_ch: int = 1, device: str | torch.device | None = None) -> dict:
    """The `Polygonizer` on `device`, the maps uploaded to it."""
    from ..predict.ffl_polygonize import Polygonizer

    dev = resolve_device(device)
    seg, cf = ffl_maps(cfg, gt, img_ids, n_ch)
    polyg = Polygonizer(cfg.experiment.polygonization, seg_threshold=0.5, device=dev)
    res = polyg(seg, cf, maps=(torch.from_numpy(seg).to(dev), torch.from_numpy(cf).to(dev)))
    out = {}
    gt_sub = _subset_index(gt, img_ids)
    for method, tols in res.items():
        for tol, per_sample in tols.items():
            preds = []
            for i, img_id in enumerate(img_ids):
                preds.extend(generate_coco_ann(per_sample[i], img_id))
            out[f"ffl.{method}.{tol}"] = _score(gt_sub, preds)
    return out


def oracle_hisup(cfg, gt: CocoIndex, img_ids: list) -> dict:
    from ..predict.hisup_polygon import polygons_from_masks
    from ..utils.coco import seg_to_mask

    S = int(cfg.experiment.encoder.in_size)
    ev = cfg.experiment.model.get("eval") or {}
    dp_tol = float(ev.get("dp_tolerance", 1.0)) if hasattr(ev, "get") else 1.0
    preds = []
    for img_id in img_ids:
        mask = np.zeros((S, S), np.float32)
        juncs = []
        for a in gt.imgToAnns[img_id]:
            mask = np.maximum(mask, seg_to_mask(a["segmentation"], S, S).astype(np.float32))
            juncs.extend(np.asarray(a["segmentation"][0], np.float64).reshape(-1, 2))
        juncs = np.asarray(juncs, np.float64).reshape(-1, 2)
        polys, scores = polygons_from_masks(mask, juncs, dp_tol=dp_tol)
        preds.extend(generate_coco_ann(polys, img_id, scores))
    return {"hisup": _score(_subset_index(gt, img_ids), preds)}


def oracle_pix2poly(cfg, gt: CocoIndex, img_ids: list) -> dict:
    """The ground truth's tokens and one-hot permutation through the
    predictor's assembly (Hungarian and chain merge): the ceiling of the
    token-to-polygon stage."""
    from ..data import P3Dataset
    from ..models.pix2poly import Tokenizer
    from ..predict.predictor_pix2poly import permutations_to_polygons, scores_to_permutations

    cfg = compose(["experiment=p2p_image", "dataset=synthetic", "run_type=debug",
                   f"experiment.encoder.in_size={int(cfg.experiment.encoder.in_size)}"])
    tok = Tokenizer(cfg)
    ds = P3Dataset(cfg, "val", tokenizer=tok, eval_mode=True)
    rng = np.random.RandomState(0)
    by_id = {ds.tile_ids[i]: i for i in range(len(ds))}
    preds = []
    for img_id in img_ids:
        item = ds.get_item(by_id[img_id], rng)
        coords = tok.decode(item["y"])[:, ::-1]  # (y, x) → (x, y), as the predictor's assembly
        n = len(coords)
        if n == 0:
            continue
        scores = item["y_perm"][None, :n, :n].astype(np.float64)
        perm = scores_to_permutations(scores)
        polys = permutations_to_polygons(perm, coords[None])[0]
        polys = [np.asarray(p, np.float64).reshape(-1, 2) for p in polys]
        preds.extend(generate_coco_ann([p for p in polys if len(p) >= 3], img_id))
    return {"pix2poly": _score(_subset_index(gt, img_ids), preds)}


def main(argv: list[str] | None = None) -> dict:
    from ..data.synthetic import ensure_synthetic_dataset

    overrides, device = split_device(argv)
    set_deterministic(resolve_device(device))
    kv = dict(a.split("=", 1) for a in overrides if "=" in a)
    which = kv.pop("model", "all")
    n = int(kv.pop("n", "12"))
    n_ch = int(kv.pop("channels", "1"))
    cfg = compose(["experiment=ffl_image", "dataset=synthetic", "run_type=debug"] + [f"{k}={v}" for k, v in kv.items()])
    ensure_synthetic_dataset(cfg)
    gt = CocoIndex(cfg.experiment.dataset.annotations["val"])
    img_ids = list(gt.imgs)[:n]

    report: dict = {}
    if which in ("ffl", "all"):
        report.update(oracle_ffl(cfg, gt, img_ids, n_ch=n_ch, device=device))
    if which in ("hisup", "all"):
        report.update(oracle_hisup(cfg, gt, img_ids))
    if which in ("pix2poly", "all"):
        report.update(oracle_pix2poly(cfg, gt, img_ids))
    print_line(json.dumps(report, indent=1))
    return report


if __name__ == "__main__":
    run(main)
