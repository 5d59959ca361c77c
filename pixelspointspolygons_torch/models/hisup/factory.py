"""Config → HiSup model (port of pixelspointspolygons_tpu/models/hisup/factory.py,
the `hrnet` and `vit_cnn` branches). The LiDAR and fusion encoders wait for
their slice of the port.

`encoder.hrnet.pretrained` does not change the build: as in the JAX
package, the trainer grafts a named checkpoint file in after the model is
built (`utils/pretrained.py`), and without a file the model keeps its init."""

from __future__ import annotations

import torch

from ..hrnet import HRNetEncoder
from ..layers import init_flax_defaults
from ..vit import ViTCNNEncoder
from .model import HiSup

# encoder name -> ROADMAP item that ports it
_DEFERRED = {
    "pointpillars_vit_cnn": "'LiDAR and fusion'",
    "early_fusion_vit_cnn": "'LiDAR and fusion'",
    "pointpillars": "'LiDAR and fusion'",
    "fusion_hrnet": "'LiDAR and fusion'",
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


def encoder_config(cfg) -> dict:
    enc = cfg.experiment.encoder
    name = enc.name
    if name == "hrnet":
        return {"name": "hrnet", "in_size": int(enc.in_size)}
    if name == "vit_cnn":
        return {"name": name, **vit_kwargs(enc), "out_size": int(cfg.experiment.model.decoder.in_feature_size)}
    if name in _DEFERRED:
        raise NotImplementedError(f"HiSup encoder {name!r}: ROADMAP 'Port queue' item {_DEFERRED[name]}")
    raise ValueError(f"unknown encoder {name!r} for hisup")


def build_hisup(cfg, device=None, generator: torch.Generator | None = None,
                dtype: torch.dtype = torch.float32) -> HiSup:
    """The HiSup model of `cfg` on `device`, computing in `dtype` with
    float32 parameters (`train/state.py::compute_dtype(cfg)` gives the
    config's), with flax's default init drawn from `generator` (a generator
    on that device; torch's global RNG if None)."""
    enc_cfg = encoder_config(cfg)
    encoder_cls = {"hrnet": HRNetEncoder, "vit_cnn": ViTCNNEncoder}[enc_cfg.pop("name")]
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
