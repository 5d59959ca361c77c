"""FFL (Frame Field Learning): a segmentation head and a crossfield head
over a dense encoder map — port of pixelspointspolygons_tpu/models/ffl/model.py
(`FFL` :26-105, `build_ffl` :108-164).

- seg head: Conv3×3 + BatchNorm + ReLU + Conv1×1 → sigmoid over the
  [interior (+edge) (+vertex)] channels;
- crossfield head: the features ⊕ the detached seg → Conv3×3 + BatchNorm +
  ReLU + Conv1×1 → 2·tanh, the 4 real channels of (c0, c2) in [-2, 2];
- encoders: `vit_cnn` (`models/vit.py::ViTCNNEncoder`) and `hrnet`
  (`models/hrnet.py::HRNetEncoder`, whose 1/4-resolution map is resized
  bilinearly up to out_size as in JAX :84-89). The LiDAR and fusion
  encoders and `unetresnet101`/`convnext` raise naming their ROADMAP items.

Outputs are NCHW: "seg" (B, Cs, H, W), "crossfield" (B, 4, H, W). Module
names are the flax names (seg_conv, seg_bn, seg_out, cf_conv, cf_bn, cf_out;
the encoder is `encoder`), so `utils/bridge.py` maps a flax tree onto them.
`dtype` is the compute dtype, as in the other families (`layers.py`).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from ..hisup.factory import vit_kwargs
from ..hrnet import HRNetEncoder
from ..layers import BatchNorm, Conv2d, init_flax_defaults, resize_bilinear
from ..vit import ViTCNNEncoder

# encoder name -> ROADMAP item that ports it
_DEFERRED = {
    "early_fusion_vit_cnn": "'LiDAR and fusion'",
    "pointpillars_vit_cnn": "'LiDAR and fusion'",
    "pointpillars": "'LiDAR and fusion'",
    "unetresnet101": "'Remaining encoders and CLI'",
    "convnext": "'Remaining encoders and CLI'",
}


class FFL(nn.Module):
    def __init__(self, encoder: nn.Module, dim: int = 256, seg_channels: int = 1, compute_seg: bool = True,
                 compute_crossfield: bool = True, out_size: int = 224, dtype=None, device=None):
        super().__init__()
        self.encoder = encoder
        self.compute_dtype = dtype
        self.out_size = out_size
        self.compute_seg = compute_seg
        self.compute_crossfield = compute_crossfield
        kw = dict(dtype=dtype, device=device)
        self.seg_conv = Conv2d(dim, dim, 3, padding=1, **kw)
        self.seg_bn = BatchNorm(dim, **kw)
        self.seg_out = Conv2d(dim, seg_channels, 1, **kw)
        # JAX's cf_conv reads the features and the seg whenever seg is computed
        self.cf_conv = Conv2d(dim + (seg_channels if compute_seg else 0), dim, 3, padding=1, **kw)
        self.cf_bn = BatchNorm(dim, **kw)
        self.cf_out = Conv2d(dim, 4, 1, **kw)

    def forward(self, batch: dict) -> dict:
        feats = self.encoder(batch["images"]).permute(0, 3, 1, 2)  # (B, C, s, s)
        feats = resize_bilinear(feats, self.out_size)
        outputs = {}
        if self.compute_seg:
            s = F.relu(self.seg_bn(self.seg_conv(feats)))
            seg = torch.sigmoid(self.seg_out(s))
            outputs["seg"] = seg
            feats = torch.cat([feats, seg.detach()], dim=1)
        if self.compute_crossfield:
            c = F.relu(self.cf_bn(self.cf_conv(feats)))
            outputs["crossfield"] = 2.0 * torch.tanh(self.cf_out(c))
        return outputs


def encoder_config(cfg) -> dict:
    enc = cfg.experiment.encoder
    name = enc.name
    if name == "vit_cnn":
        return {"name": name, **vit_kwargs(enc), "out_size": int(cfg.experiment.model.decoder.in_feature_size)}
    if name == "hrnet":
        return {"name": name, "in_size": int(enc.in_size)}
    if name in _DEFERRED:
        raise NotImplementedError(f"FFL encoder {name!r}: ROADMAP 'Port queue' item {_DEFERRED[name]}")
    raise ValueError(f"unknown encoder {name!r} for ffl")


def build_ffl(cfg, device=None, generator: torch.Generator | None = None,
              dtype: torch.dtype = torch.float32) -> FFL:
    """The FFL model of `cfg` on `device`, computing in `dtype` with float32
    parameters, with flax's default init drawn from `generator` (a
    generator on that device; torch's global RNG if None)."""
    m = cfg.experiment.model
    enc_cfg = encoder_config(cfg)
    encoder_cls = {"hrnet": HRNetEncoder, "vit_cnn": ViTCNNEncoder}[enc_cfg.pop("name")]
    dim = int(m.decoder.in_feature_dim)
    seg_channels = int(bool(m.seg.compute_interior)) + int(bool(m.seg.compute_edge)) + int(bool(m.seg.compute_vertex))
    model = FFL(
        encoder_cls(out_dim=dim, dtype=dtype, device=device, **enc_cfg),
        dim=dim,
        seg_channels=seg_channels,
        compute_seg=bool(m.compute_seg),
        compute_crossfield=bool(m.compute_crossfield),
        out_size=int(m.decoder.in_feature_size),
        dtype=dtype,
        device=device,
    )
    init_flax_defaults(model, generator)
    return model
