"""LiDAR-density ablation: the FFL-LiDAR runs over
max_num_points_per_voxel ∈ {4..512} into `lidar_density_ablation.csv` —
twin of scripts/lidar_density_ablation.py.

Usage: python -m pixelspointspolygons_torch.cli.lidar_density_ablation [key.path=value ...] [device=cpu]
"""

from __future__ import annotations

from ._ablation import run_ablation
from ._common import run

DENSITIES = [4, 8, 16, 32, 64, 128, 256, 512]


def runs() -> list:
    return [(f"mnv={mnv}", [f"experiment=lidar_density_ablation{mnv}", "evaluation=test", "checkpoint=best_val_iou"],
             lambda cfg, mnv=mnv: {"max_num_points_per_voxel": mnv}) for mnv in DENSITIES]


def main(argv: list[str] | None = None):
    return run_ablation(runs(), "lidar_density_ablation.csv", argv)


if __name__ == "__main__":
    run(main)
