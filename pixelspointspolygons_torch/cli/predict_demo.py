"""Single-tile demo prediction (reference scripts/predict_demo.py:9-53).

Usage: python -m pixelspointspolygons_torch.cli.predict_demo experiment=hisup_image \
    checkpoint=latest +image_file=/path/tile.png [key.path=value ...] [device=cpu]

A LiDAR or fusion experiment takes `+lidar_file=/path/tile.laz` (`.las`,
`.npz`, `.npy`) instead of or beside the image, as its encoder reads.

Writes prediction_<model>_<modality>.png in the working directory. Runs on
the card; `device=cpu` runs on the CPU instead.
"""

from __future__ import annotations

from ._common import compose_from_argv
from .predict import get_predictor


def main(argv: list[str] | None = None) -> tuple[list, str]:
    """Returns the polygons and the png's path."""
    cfg, device = compose_from_argv(argv)
    predictor = get_predictor(cfg, device)
    enc = cfg.experiment.encoder
    modality = "fusion" if enc.use_images and enc.use_lidar else ("image" if enc.use_images else "lidar")
    out_file = f"prediction_{cfg.experiment.model.name}_{modality}.png"
    polys = predictor.predict_file(
        image_file=cfg.get("image_file"),
        lidar_file=cfg.get("lidar_file"),
        out_file=out_file,
    )
    print(f"predicted {len(polys)} polygons → {out_file}")
    return polys, out_file


if __name__ == "__main__":
    main()
