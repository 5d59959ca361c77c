"""Collect the `best_val_iou` checkpoint of each experiment of the grid into
one tree, `gathered_pretrained/<experiment>/best_val_iou.pt` in the working
directory — twin of scripts/gather_pretrained_models.py. The port's
checkpoints are single files (`<output_dir>/checkpoints/<name>.pt`), so
each is copied as a file; an experiment without one prints a `[skip]`
line.

Usage: python -m pixelspointspolygons_torch.cli.gather_pretrained_models [key.path=value ...] [device=cpu]

No device is involved (it copies files), but it takes `device` as the
other entry points do: without a card it runs only when given `device=cpu`.
"""

from __future__ import annotations

import os
import shutil

from ..config.engine import compose
from ..device import resolve_device
from ._common import print_line, run, split_device

EXPERIMENTS = [
    "p2p_image", "p2p_lidar", "p2p_fusion",
    "hisup_image", "hisup_lidar", "hisup_fusion",
    "ffl_image", "ffl_lidar", "ffl_fusion",
]


def main(argv: list[str] | None = None) -> list[str]:
    """The experiments gathered."""
    overrides, device = split_device(argv)
    resolve_device(device)
    out_root = "gathered_pretrained"
    gathered = []
    for exp in EXPERIMENTS:
        cfg = compose([f"experiment={exp}"] + overrides)
        src = os.path.join(cfg.output_dir, "checkpoints", "best_val_iou.pt")
        if not os.path.isfile(src):
            print_line(f"[skip] {exp}: no best_val_iou checkpoint")
            continue
        dst = os.path.join(out_root, exp, "best_val_iou.pt")
        os.makedirs(os.path.dirname(dst), exist_ok=True)
        shutil.copyfile(src, dst)
        print_line(f"gathered {exp} → {dst}")
        gathered.append(exp)
    return gathered


if __name__ == "__main__":
    run(main)
