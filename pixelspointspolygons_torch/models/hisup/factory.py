"""Config → HiSup model (port of pixelspointspolygons_tpu/models/hisup/factory.py,
the `hrnet` branch). Other encoders wait for their slice of the port."""

from __future__ import annotations

import torch

from ..hrnet import HRNetEncoder
from ..layers import init_flax_defaults
from .model import HiSup

# encoder name -> ROADMAP item that ports it
_DEFERRED = {
    "vit_cnn": "'Remaining HiSup encoders'",
    "pointpillars_vit_cnn": "'LiDAR and fusion'",
    "early_fusion_vit_cnn": "'LiDAR and fusion'",
    "pointpillars": "'LiDAR and fusion'",
    "fusion_hrnet": "'LiDAR and fusion'",
}


def encoder_config(cfg) -> dict:
    enc = cfg.experiment.encoder
    name = enc.name
    if name == "hrnet":
        return {"name": "hrnet", "in_size": int(enc.in_size)}
    if name in _DEFERRED:
        raise NotImplementedError(f"HiSup encoder {name!r}: ROADMAP 'Port queue' item {_DEFERRED[name]}")
    raise NotImplementedError(f"encoder {name!r} for hisup")


def build_hisup(cfg, device=None, generator: torch.Generator | None = None) -> HiSup:
    """The HiSup model of `cfg` on `device`, with flax's default init drawn
    from `generator` (a generator on that device; torch's global RNG if None)."""
    if bool(cfg.experiment.encoder.get("hrnet", {}).get("pretrained", False)):
        raise NotImplementedError(
            "pretrained HRNet weights: ROADMAP 'Port queue' item 'Remaining HiSup encoders'"
        )
    enc_cfg = encoder_config(cfg)
    enc_cfg.pop("name")
    dim = int(cfg.experiment.model.decoder.in_feature_dim)
    model = HiSup(
        HRNetEncoder(out_dim=dim, device=device, **enc_cfg),
        dim=dim,
        pred_size=int(cfg.experiment.model.decoder.in_feature_size),
        device=device,
    )
    init_flax_defaults(model, generator)
    return model
