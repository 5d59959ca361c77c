"""The ground truth evaluated as if it were the prediction — twin of
scripts/evaluate_gt.py (reference scripts/evaluate_gt.py and
config/evaluation/gt_eval.yaml). A sound metric stack reports AP = AP50 =
IoU = C-IoU = 1 and POLIS = Chamfer = Hausdorff = MTA = 0; anything else
is a fault in the metrics, and the command exits naming it.

Usage: python -m pixelspointspolygons_torch.cli.evaluate_gt experiment=debug dataset=synthetic \
    [key.path=value ...] [device=cpu]

Host code, but it takes `device` as the other entry points do: without a
card it runs only when given `device=cpu`.
"""

from __future__ import annotations

import json

from ..config.engine import compose
from ..device import resolve_device
from ..eval.evaluator import Evaluator
from ._common import format_results, print_line, split_device

# metric, the value a perfect prediction gives, tolerance
PERFECT = (
    ("AP", 1.0, 1e-6),
    ("AP50", 1.0, 1e-6),
    ("IoU", 1.0, 1e-6),
    ("C-IoU", 1.0, 1e-6),
    ("polis", 0.0, 1e-6),
    ("chamfer", 0.0, 1e-6),
    ("hausdorff", 0.0, 1e-6),
    ("mta", 0.0, 1e-6),
)


def gt_as_predictions(ann_file: str) -> list[dict]:
    with open(ann_file) as f:
        gt = json.load(f)
    return [
        {
            "image_id": ann["image_id"],
            "category_id": ann.get("category_id", 100),
            "segmentation": ann["segmentation"],
            "bbox": ann.get("bbox"),
            "area": ann.get("area"),
            "score": 1.0,
        }
        for ann in gt.get("annotations", [])
    ]


def main(argv: list[str] | None = None) -> dict:
    overrides, device = split_device(argv)
    resolve_device(device)
    cfg = compose(["evaluation=gt_eval"] + overrides)
    split = cfg.evaluation.split
    ann_file = cfg.experiment.dataset.annotations[split]

    evaluator = Evaluator(cfg)
    evaluator.load_gt(ann_file)
    evaluator.coco_dt = evaluator.coco_gt.load_res(gt_as_predictions(ann_file))
    results = evaluator.evaluate()
    evaluator.to_csv(results)

    print_line(format_results(results))
    problems = [f"{k}={results[k]:.6f} (want {want})" for k, want, tol in PERFECT
                if k in results and abs(results[k] - want) > tol]
    if problems:
        raise SystemExit("GT self-eval NOT perfect: " + ", ".join(problems))
    print_line("GT self-eval perfect ✓")
    return results


if __name__ == "__main__":
    main()
