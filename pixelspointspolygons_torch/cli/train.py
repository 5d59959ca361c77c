"""Train a model with the port (reference scripts/train.py:7-22: dispatch on
cfg.experiment.model.name).

Usage: python -m pixelspointspolygons_torch.cli.train experiment=hisup_image \
    dataset=synthetic run_type=debug [key.path=value ...] [device=cpu]

Runs on the card; `device=cpu` runs on the CPU instead. HiSup, Pix2Poly
and FFL train on images, LiDAR and both (`experiment=hisup_lidar`,
`p2p_fusion`, `ffl_lidar`, `lidar_density_ablation64`, ...), each also at
`host.compute_dtype=bfloat16`, with pretrained encoder files
(`experiment.encoder.hrnet.pretrained=true
experiment.encoder.hrnet.checkpoint_file=...`, or the ViT's
`experiment.encoder.pretrained=true experiment.encoder.checkpoint_file=...`)
and warm starts (`init_weights_from=<run>/checkpoints/latest.pt`).
"""

from __future__ import annotations

from ._common import compose_from_argv


def main(argv: list[str] | None = None) -> dict:
    cfg, device = compose_from_argv(argv)
    name = cfg.experiment.model.name
    if name == "hisup":
        from ..train.trainer_hisup import HiSupTrainer

        trainer = HiSupTrainer(cfg, device=device)
    elif name == "pix2poly":
        from ..train.trainer_pix2poly import Pix2PolyTrainer

        trainer = Pix2PolyTrainer(cfg, device=device)
    elif name == "ffl":
        from ..train.trainer_ffl import FFLTrainer

        trainer = FFLTrainer(cfg, device=device)
    else:
        raise ValueError(f"unknown model {name!r}")
    return trainer.train()


if __name__ == "__main__":
    main()
