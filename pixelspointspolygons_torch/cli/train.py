"""Train a model with the port (reference scripts/train.py:7-22: dispatch on
cfg.experiment.model.name).

Usage: python -m pixelspointspolygons_torch.cli.train experiment=hisup_image \
    dataset=synthetic run_type=debug [key.path=value ...] [device=cpu]

Runs on the card; `device=cpu` runs on the CPU instead. HiSup is ported;
the other models raise NotImplementedError naming their ROADMAP item.
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
        raise NotImplementedError("Pix2Poly training: ROADMAP 'Port queue' item 'Pix2Poly training'")
    elif name == "ffl":
        raise NotImplementedError("FFL training: ROADMAP 'Port queue' item 'FFL'")
    else:
        raise NotImplementedError(f"model {name!r}")
    return trainer.train()


if __name__ == "__main__":
    main()
