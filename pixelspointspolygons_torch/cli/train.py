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

`P3_LAUNCH=N python -m pixelspointspolygons_torch.cli.train ...` trains on
N processes (NCCL, one per card; gloo with `device=cpu`), each on its
shard of every global batch of N · `batch_size`. Prints the last epoch's
metrics (global means).
"""

from __future__ import annotations

from ._common import compose_from_argv, print_line, process_group, run


def main(argv: list[str] | None = None) -> dict:
    cfg, device = compose_from_argv(argv)
    name = cfg.experiment.model.name
    if name == "hisup":
        from ..train.trainer_hisup import HiSupTrainer as trainer_cls
    elif name == "pix2poly":
        from ..train.trainer_pix2poly import Pix2PolyTrainer as trainer_cls
    elif name == "ffl":
        from ..train.trainer_ffl import FFLTrainer as trainer_cls
    else:
        raise ValueError(f"unknown model {name!r}")
    with process_group(device) as device:
        history = trainer_cls(cfg, device=device).train()
    print_line(history)
    return history


if __name__ == "__main__":
    run(main)
