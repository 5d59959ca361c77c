"""The fusion models on the test split of every country
(`experiment.dataset.country=all`) into `all_countries.csv` — twin of
scripts/all_countries.py.

Usage: python -m pixelspointspolygons_torch.cli.all_countries [key.path=value ...] [device=cpu]
"""

from __future__ import annotations

from ._ablation import run_ablation
from ._common import run

EXPERIMENTS = ["p2p_fusion", "hisup_fusion", "ffl_fusion"]


def runs() -> list:
    return [(exp, [f"experiment={exp}", "experiment.dataset.country=all", "evaluation=test",
                   "checkpoint=best_val_iou"], lambda cfg, exp=exp: {"experiment": exp}) for exp in EXPERIMENTS]


def main(argv: list[str] | None = None):
    return run_ablation(runs(), "all_countries.csv", argv)


if __name__ == "__main__":
    run(main)
