"""LiDAR-dropout robustness ablation: the Pix2Poly fusion model evaluated
with and without LiDAR into `droplidar50_ablation.csv` — twin of
scripts/droplidar50_ablation.py.

The two runs keep the script's overrides: both set
`experiment.lidar_dropout=0.5`, which no factory reads, and `no_lidar` adds
`+drop_all_lidar=true`, which no module of either package reads. So both
rows predict with the same model on the same inputs, in JAX as here
(ROADMAP 3.15).

Usage: python -m pixelspointspolygons_torch.cli.droplidar50_ablation [key.path=value ...] [device=cpu]
"""

from __future__ import annotations

from ._ablation import run_ablation
from ._common import run

VARIANTS = [
    ("with_lidar", []),
    ("no_lidar", ["+drop_all_lidar=true"]),
]


def runs() -> list:
    return [(name, ["experiment=p2p_fusion", "experiment.lidar_dropout=0.5", "evaluation=test",
                    "checkpoint=best_val_iou", *extra], lambda cfg, name=name: {"variant": name})
            for name, extra in VARIANTS]


def main(argv: list[str] | None = None):
    return run_ablation(runs(), "droplidar50_ablation.csv", argv)


if __name__ == "__main__":
    run(main)
