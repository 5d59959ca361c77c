"""Evaluate an existing prediction json (reference scripts/evaluate.py:11-35).

Usage: python -m pixelspointspolygons_torch.cli.evaluate experiment=hisup_image \
    dataset=synthetic evaluation=test checkpoint=latest [key.path=value ...] [device=cpu]

Reads `evaluation.pred_file`, runs the config's evaluation modes, writes the
metrics CSV and prints the metric dict. The metrics are host code, but the
entry point takes `device` as the others do: without a card it runs only
when given `device=cpu`.
"""

from __future__ import annotations

from typing import Optional

from ..config.engine import Config
from ..device import resolve_device
from ..eval.evaluator import Evaluator
from ..parallel import process_index
from ._common import compose_from_argv, format_results, print_line, process_group, run


def evaluate(cfg: Config, pred_file: Optional[str] = None) -> dict:
    """The metric dict of `pred_file` (default `evaluation.pred_file`)
    against the split's ground truth, also written to the metrics CSV (by
    rank 0 under a process group)."""
    evaluator = Evaluator(cfg)
    evaluator.load_gt()
    evaluator.load_predictions(pred_file)
    results = evaluator.evaluate()
    if process_index() == 0:
        evaluator.to_csv(results)
    return results


def main(argv: list[str] | None = None) -> dict:
    cfg, device = compose_from_argv(argv)
    with process_group(device) as device:
        resolve_device(device)
        results = evaluate(cfg)
    print_line(format_results(results))
    return results


if __name__ == "__main__":
    run(main)
