"""Config → Pix2Poly model (port of
pixelspointspolygons_tpu/models/pix2poly/factory.py: the `vit`,
`vit_dinov2`, `pointpillars_vit` and `early_fusion_vit` branches)."""

from __future__ import annotations

import torch

from ..layers import init_flax_defaults
from .model import Pix2Poly
from .tokenizer import Tokenizer

def encoder_config(cfg) -> dict:
    enc = cfg.experiment.encoder
    name = enc.name
    vit_kw = dict(
        img_size=int(enc.in_size),
        patch_size=int(enc.patch_size),
        dim=int(enc.patch_feature_dim),
        depth=12,
        num_heads=6,
    )
    if name == "vit":
        return {"name": "vit", **vit_kw}
    if name == "vit_dinov2":
        # the DINOv2 ViT-S/14 trunk: the ViT with LayerScale (JAX :27-30)
        return {"name": "vit", **vit_kw, "layer_scale": True}
    if name in ("pointpillars_vit", "early_fusion_vit"):
        return {
            "name": name,
            **vit_kw,
            "voxel_x": float(enc.in_voxel_size.x),
            "voxel_y": float(enc.in_voxel_size.y),
            "width": float(enc.in_width),
            "height": float(enc.in_height),
            "max_points_per_voxel": int(enc.max_num_points_per_voxel),
        }
    raise ValueError(f"unknown encoder {name!r} for pix2poly")


def build_pix2poly(cfg, tokenizer: Tokenizer | None = None, device=None,
                   generator: torch.Generator | None = None, dtype: torch.dtype = torch.float32) -> Pix2Poly:
    """The Pix2Poly model of `cfg` on `device`, computing in `dtype` with
    float32 parameters (`train/state.py::compute_dtype(cfg)` gives the
    config's), with flax's default init drawn from `generator` (a generator
    on that device; torch's global RNG if None)."""
    tokenizer = tokenizer or Tokenizer(cfg)
    m = cfg.experiment.model
    model = Pix2Poly(
        vocab_size=tokenizer.vocab_size,
        encoder_len=int(cfg.experiment.encoder.num_patches),
        dim=int(m.decoder.in_feature_dim),
        num_heads=int(m.decoder.get("num_heads", 8)),
        num_layers=int(m.decoder.get("num_layers", 6)),
        max_len=tokenizer.max_len,
        pad_idx=tokenizer.PAD_code,
        max_num_vertices=tokenizer.max_num_vertices,
        sinkhorn_iterations=int(m.sinkhorn_iterations),
        encoder_cfg=encoder_config(cfg),
        dtype=dtype,
        device=device,
    )
    init_flax_defaults(model, generator)
    return model
