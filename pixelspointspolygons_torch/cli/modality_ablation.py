"""Modality ablation: predict and evaluate the 3 models × 3 modalities grid
into `modality_ablation.csv` — twin of scripts/modality_ablation.py.

Usage: python -m pixelspointspolygons_torch.cli.modality_ablation [key.path=value ...] [device=cpu]
"""

from __future__ import annotations

from ._ablation import run_ablation
from ._common import run

EXPERIMENTS = [
    "p2p_image",
    "p2p_lidar",
    "p2p_fusion",
    "hisup_image",
    "hisup_lidar",
    "hisup_fusion",
    "ffl_image",
    "ffl_lidar",
    "ffl_fusion",
]


def runs() -> list:
    return [(exp, [f"experiment={exp}", "evaluation=test", "checkpoint=best_val_iou"],
             lambda cfg, exp=exp: {"experiment": exp}) for exp in EXPERIMENTS]


def main(argv: list[str] | None = None):
    return run_ablation(runs(), "modality_ablation.csv", argv)


if __name__ == "__main__":
    run(main)
