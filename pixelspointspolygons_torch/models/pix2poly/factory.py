"""Config → Pix2Poly model (port of
pixelspointspolygons_tpu/models/pix2poly/factory.py, the `vit` branch). The
other encoders wait for their slice of the port."""

from __future__ import annotations

import torch

from ..layers import init_flax_defaults
from .model import Pix2Poly
from .tokenizer import Tokenizer

# encoder name -> ROADMAP item that ports it
_DEFERRED = {
    "vit_dinov2": "'Remaining encoders and CLI'",
    "pointpillars_vit": "'LiDAR and fusion'",
    "early_fusion_vit": "'LiDAR and fusion'",
}


def encoder_config(cfg) -> dict:
    enc = cfg.experiment.encoder
    name = enc.name
    if name == "vit":
        return dict(
            name="vit",
            img_size=int(enc.in_size),
            patch_size=int(enc.patch_size),
            dim=int(enc.patch_feature_dim),
            depth=12,
            num_heads=6,
        )
    if name in _DEFERRED:
        raise NotImplementedError(f"Pix2Poly encoder {name!r}: ROADMAP 'Port queue' item {_DEFERRED[name]}")
    raise NotImplementedError(f"encoder {name!r} not supported for pix2poly")


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
