"""Image-resolution ablation: FFL-image at 224 (`vit_cnn`) against 512
(`unetresnet101`) into `image_res_ablation.csv` — twin of
scripts/image_res_ablation.py.

The 512 row's model reads and writes 512 px maps: on tiles of another size
its training fails in the loss and its prediction draws polygons on the
512 grid, in JAX as here (ROADMAP 3.18). The synthetic dataset makes its
tiles at `encoder.in_size`.

Usage: python -m pixelspointspolygons_torch.cli.image_res_ablation [key.path=value ...] [device=cpu]
"""

from __future__ import annotations

from ._ablation import run_ablation
from ._common import run

CONFIGS = [
    ("ffl_image", ["experiment.encoder.in_size=224"]),
    ("ffl_image", ["encoder=unetresnet101", "experiment.encoder.in_size=512"]),
]


def runs() -> list:
    return [(exp, [f"experiment={exp}", "evaluation=test", "checkpoint=best_val_iou", *extra],
             lambda cfg, exp=exp: {"experiment": exp, "in_size": cfg.experiment.encoder.in_size})
            for exp, extra in CONFIGS]


def main(argv: list[str] | None = None):
    return run_ablation(runs(), "image_res_ablation.csv", argv)


if __name__ == "__main__":
    run(main)
