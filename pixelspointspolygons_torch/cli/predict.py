"""Predict a split and evaluate it, writing the metrics CSV (reference
scripts/predict.py:9-46).

Usage: python -m pixelspointspolygons_torch.cli.predict experiment=hisup_image \
    dataset=synthetic evaluation=test checkpoint=latest [key.path=value ...] [device=cpu]

Runs on the card; `device=cpu` runs on the CPU instead. HiSup, Pix2Poly
and FFL are ported, on images, LiDAR and both (`experiment=p2p_image`,
`hisup_lidar`, `ffl_fusion`, ...).
"""

from __future__ import annotations

import torch

from ..config.engine import Config
from ..predict.predictor import Predictor
from ._common import compose_from_argv, format_results
from .evaluate import evaluate


def get_predictor(cfg: Config, device: str | torch.device | None = None) -> Predictor:
    name = cfg.experiment.model.name
    if name == "hisup":
        from ..predict.predictor_hisup import HiSupPredictor

        return HiSupPredictor(cfg, device=device)
    if name == "pix2poly":
        from ..predict.predictor_pix2poly import Pix2PolyPredictor

        return Pix2PolyPredictor(cfg, device=device)
    if name == "ffl":
        from ..predict.predictor_ffl import FFLPredictor

        return FFLPredictor(cfg, device=device)
    raise ValueError(f"unknown model {name!r}")


def predict_and_evaluate(cfg: Config, device: str | torch.device | None = None) -> tuple[Predictor, dict]:
    """Predict `evaluation.split` into `evaluation.pred_file` and evaluate
    it; returns the predictor (for its timings) and the metric dict."""
    predictor = get_predictor(cfg, device)
    pred_file = predictor.predict_dataset(cfg.evaluation.split)
    return predictor, evaluate(cfg, pred_file)


def main(argv: list[str] | None = None) -> dict:
    cfg, device = compose_from_argv(argv)
    _, results = predict_and_evaluate(cfg, device)
    print(format_results(results))
    return results


if __name__ == "__main__":
    main()
