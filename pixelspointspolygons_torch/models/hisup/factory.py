"""Config → HiSup model — port of pixelspointspolygons_tpu/models/hisup/factory.py
(the encoder matrix of reference models/hisup/model_hisup.py:318-344):
`hrnet`, `vit_cnn`, `pointpillars_vit_cnn`, `early_fusion_vit_cnn`,
`pointpillars` and `fusion_hrnet`.

`encoder.hrnet.pretrained` does not change the build: as in the JAX
package, the trainer grafts a named checkpoint file in after the model is
built (`utils/pretrained.py`), and without a file the model keeps its init."""

from __future__ import annotations

import torch

from ..fusion import EarlyFusionViTCNNEncoder
from ..hrnet import FusionHRNetEncoder, HRNetEncoder
from ..layers import init_flax_defaults
from ..pointpillars import PointPillarsDenseEncoder
from ..vit import ViTCNNEncoder
from .encoders import PointPillarsViTCNNEncoder
from .model import HiSup

ENCODERS = {
    "hrnet": HRNetEncoder,
    "vit_cnn": ViTCNNEncoder,
    "pointpillars_vit_cnn": PointPillarsViTCNNEncoder,
    "early_fusion_vit_cnn": EarlyFusionViTCNNEncoder,
    "pointpillars": PointPillarsDenseEncoder,
    "fusion_hrnet": FusionHRNetEncoder,
}


def vit_kwargs(enc) -> dict:
    """The ViT-S trunk's sizes from the encoder config (JAX :13-19)."""
    return dict(
        img_size=int(enc.in_size),
        patch_size=int(enc.get("patch_size", 8)),
        dim=int(enc.get("patch_feature_dim", 384)),
        depth=12,
        num_heads=6,
    )


def lidar_kwargs(enc) -> dict:
    """The pillar grid of a LiDAR encoder config, {} without LiDAR (JAX :20-30)."""
    if not enc.use_lidar:
        return {}
    return dict(
        width=float(enc.in_width),
        height=float(enc.in_height),
        voxel_x=float(enc.in_voxel_size.x),
        voxel_y=float(enc.in_voxel_size.y),
        max_points_per_voxel=int(enc.max_num_points_per_voxel),
    )


def encoder_config(cfg) -> dict:
    enc = cfg.experiment.encoder
    name = enc.name
    out_size = int(cfg.experiment.model.decoder.in_feature_size)
    if name == "vit_cnn":
        return {"name": name, **vit_kwargs(enc), "out_size": out_size}
    if name in ("pointpillars_vit_cnn", "early_fusion_vit_cnn"):
        return {"name": name, **vit_kwargs(enc), **lidar_kwargs(enc), "out_size": out_size}
    if name == "pointpillars":
        return {"name": name, **lidar_kwargs(enc), "out_size": out_size,
                "out_channels": tuple(int(c) for c in cfg.experiment.model.point_pillars.out_channels)}
    if name == "hrnet":
        return {"name": "hrnet", "in_size": int(enc.in_size)}
    if name == "fusion_hrnet":
        # the pillar extent comes from in_size and `width` is HRNet's channel
        # width: only the voxel sizes and the cap pass (JAX :50-54)
        pillar_kw = {k: v for k, v in lidar_kwargs(enc).items() if k not in ("width", "height")}
        return {"name": "fusion_hrnet", "in_size": int(enc.in_size), **pillar_kw}
    raise ValueError(f"unknown encoder {name!r} for hisup")


def build_hisup(cfg, device=None, generator: torch.Generator | None = None,
                dtype: torch.dtype = torch.float32) -> HiSup:
    """The HiSup model of `cfg` on `device`, computing in `dtype` with
    float32 parameters (`train/state.py::compute_dtype(cfg)` gives the
    config's), with flax's default init drawn from `generator` (a generator
    on that device; torch's global RNG if None)."""
    enc_cfg = encoder_config(cfg)
    encoder_cls = ENCODERS[enc_cfg.pop("name")]
    dim = int(cfg.experiment.model.decoder.in_feature_dim)
    model = HiSup(
        encoder_cls(out_dim=dim, dtype=dtype, device=device, **enc_cfg),
        dim=dim,
        pred_size=int(cfg.experiment.model.decoder.in_feature_size),
        dtype=dtype,
        device=device,
    )
    init_flax_defaults(model, generator)
    return model
