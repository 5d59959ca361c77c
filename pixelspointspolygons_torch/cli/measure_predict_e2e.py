"""Time `predict_dataset` end to end, from the loader to the COCO file —
twin of scripts/measure_predict_e2e.py: the split predicted once cold and
three times warm in one process, and one JSON line with the median warm
pass's tiles per second. It counts the tiles the passes predicted, where
the script counts the config's `num_{split}` (ROADMAP 3.22).

`predict_dataset` returns once the host holds every prediction and has
written the file, so each pass's host clock covers the card's work; no
extra synchronize is needed. The cold pass pays what the first batch sets
up (cuDNN's and cuBLAS's handles, the allocator's first blocks); there is
no compile to amortize.

Usage: python -m pixelspointspolygons_torch.cli.measure_predict_e2e experiment=p2p_image \
    dataset=synthetic evaluation=test checkpoint=best_val_iou [evaluation.batch_size=32] \
    [key.path=value ...] [device=cpu]

Runs on the card; `device=cpu` runs on the CPU instead.
"""

from __future__ import annotations

import json
import time

from ..data.dataset import P3Dataset
from ._common import compose_from_argv, print_line, process_group, run
from .predict import get_predictor


def main(argv: list[str] | None = None) -> dict:
    cfg, device = compose_from_argv(argv)
    with process_group(device) as device:
        predictor = get_predictor(cfg, device)
        split = cfg.evaluation.split
        t0 = time.time()
        predictor.predict_dataset(split)
        cold = time.time() - t0
        times = []
        for _ in range(3):
            t0 = time.time()
            predictor.predict_dataset(split)
            times.append(time.time() - t0)
    # the tiles each pass predicted: the split as the dataset holds it, cut
    # to `run_type.{split}_subset`. The script divides the config's
    # `num_{split}` instead, which overstates the rate under a subset
    # (ROADMAP 3.22, a standing divergence)
    n = len(P3Dataset(cfg, split, eval_mode=True))
    warm = sorted(times)[len(times) // 2]
    report = {
        "experiment": str(cfg.experiment.name),
        "split": split,
        "tiles": n,
        "cold_s": round(cold, 2),
        "warm_s_median": round(warm, 2),
        "warm_tiles_per_s": round(n / warm, 2) if n else None,
        "spread_pct": round(100 * (max(times) - min(times)) / warm, 1),
        "batch_size": cfg.evaluation.get("batch_size"),
        "checkpoint": str(cfg.get("checkpoint") or ""),
    }
    print_line(json.dumps(report))
    return report


if __name__ == "__main__":
    run(main)
