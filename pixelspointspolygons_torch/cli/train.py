"""Train a model with the port (reference scripts/train.py:7-22: dispatch on
cfg.experiment.model.name).

Usage: python -m pixelspointspolygons_torch.cli.train experiment=hisup_image \
    dataset=synthetic run_type=debug [key.path=value ...] [device=cpu]

Runs on the card; `device=cpu` runs on the CPU instead. HiSup and Pix2Poly
are ported, both also at `host.compute_dtype=bfloat16`, with pretrained
encoder files (`experiment.encoder.hrnet.pretrained=true
experiment.encoder.hrnet.checkpoint_file=...`, or the ViT's
`experiment.encoder.pretrained=true experiment.encoder.checkpoint_file=...`)
and warm starts (`init_weights_from=<run>/checkpoints/latest.pt`); FFL
raises NotImplementedError naming its ROADMAP item.
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
        raise NotImplementedError("FFL training: ROADMAP 'Port queue' item 'FFL'")
    else:
        raise ValueError(f"unknown model {name!r}")
    return trainer.train()


if __name__ == "__main__":
    main()
