"""The loop the ablation twins share (scripts/modality_ablation.py,
lidar_density_ablation.py, all_countries.py, dino_v2_ablation.py,
image_res_ablation.py): for each run of the ablation, compose its
overrides followed by the command line's, predict the test split through
`cli/predict.py::get_predictor`, evaluate it with the `Evaluator`, and
collect one row of the run's columns and metrics. A run whose checkpoint
or data is missing (`FileNotFoundError`) is skipped with a `[skip]` line,
as in the scripts; any other failure ends the command. The rows are
printed as pandas prints them and written to the script's CSV in the
working directory.

`device=` picks the device as in the other entry points; under a process
group every process predicts its shard and rank 0 prints and writes.
"""

from __future__ import annotations

from typing import Callable, Sequence

import torch

from ..config.engine import Config, compose
from ..eval.evaluator import Evaluator
from ..parallel import process_index
from ._common import print_line, process_group, split_device
from .predict import get_predictor

# (label in the [skip] line, the run's overrides, its columns from its config)
Run = tuple[str, list[str], Callable[[Config], dict]]


def predict_rows(runs: Sequence[Run], overrides: list[str], device: str | torch.device | None = None) -> list[dict]:
    rows = []
    for label, run_overrides, columns in runs:
        cfg = compose(list(run_overrides) + list(overrides))
        try:
            predictor = get_predictor(cfg, device)
            pred_file = predictor.predict_dataset(cfg.evaluation.split)
            evaluator = Evaluator(cfg)
            evaluator.load_gt()
            evaluator.load_predictions(pred_file)
            results = evaluator.evaluate()
        except FileNotFoundError as e:
            print_line(f"[skip] {label}: {e}")
            continue
        rows.append({**columns(cfg), **results})
    return rows


def run_ablation(runs: Sequence[Run], csv_file: str, argv: list[str] | None = None):
    """The ablation's DataFrame, printed and written to `csv_file`."""
    import pandas as pd

    overrides, device = split_device(argv)
    with process_group(device) as device:
        df = pd.DataFrame(predict_rows(runs, overrides, device))
    if process_index() == 0:
        print_line(df.to_string())
        df.to_csv(csv_file, index=False)
    return df
