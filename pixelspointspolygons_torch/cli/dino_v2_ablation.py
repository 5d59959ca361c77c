"""DINOv2-encoder ablation for Pix2Poly-image, `vit` (DINO ViT-S/8) against
`vit_dinov2` (DINOv2 ViT-S/14), into `dino_v2_ablation.csv` — twin of
scripts/dino_v2_ablation.py.

Both rows read `checkpoint=best_val_iou` under the same output directory
(it names the model, the input size and the experiment, not the encoder),
as the script's do (ROADMAP 3.19).

Usage: python -m pixelspointspolygons_torch.cli.dino_v2_ablation [key.path=value ...] [device=cpu]
"""

from __future__ import annotations

from ._ablation import run_ablation
from ._common import run

ENCODERS = ["vit", "vit_dinov2"]


def runs() -> list:
    return [(enc, ["experiment=p2p_image", f"encoder={enc}", "evaluation=test", "checkpoint=best_val_iou"],
             lambda cfg, enc=enc: {"encoder": enc}) for enc in ENCODERS]


def main(argv: list[str] | None = None):
    return run_ablation(runs(), "dino_v2_ablation.csv", argv)


if __name__ == "__main__":
    run(main)
