"""Early-fusion encoders (image + LiDAR) — port of
pixelspointspolygons_tpu/models/fusion.py (:28-123; reference
models/fusion_layers/early_fusion_vit.py:13-127, early_fusion_vit_cnn.py).

- `EarlyFusionViTEncoder`: the image's conv patch embedding (`patch_embed`)
  and the LiDAR pillar canvas (`pillar_canvas`), both (B, gh, gw, dim),
  concatenated on the channel axis, fused by Conv3×3 (`fusion_conv`),
  BatchNorm (`fusion_bn`) and ReLU, then the ViT trunk on those tokens
  (`vit`, no patch embedding of its own), CLS dropped, the channel
  bottleneck to out_dim.
- `EarlyFusionViTCNNEncoder`: that encoder (`fusion_vit`, no bottleneck)
  with the dense-map head of `ViTCNNEncoder` for HiSup and FFL.

LiDAR dropout (`lidar_dropout`, JAX :63-66): in training, one uniform draw
per batch from an explicit `torch.Generator`; at or below `lidar_dropout`
the whole batch's canvas is zeroed. No factory passes it, in the JAX
package or here (ROADMAP §3), so it is off on every configured path.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.voxelize import grid_shape
from .layers import BatchNorm, Conv2d, adaptive_avg_pool1d
from .pointpillars import PillarCanvas
from .vit import ViTBackbone, token_map_head


class EarlyFusionViTEncoder(nn.Module):
    """Image + LiDAR early fusion → ViT tokens (B, N, out_dim)."""

    def __init__(self, img_size: int = 224, patch_size: int = 8, dim: int = 384, depth: int = 12,
                 num_heads: int = 6, out_dim: int | None = 256, width: float = 224.0, height: float = 224.0,
                 voxel_x: float = 8.0, voxel_y: float = 8.0, max_points_per_voxel: int = 64,
                 lidar_dropout: float | None = None, dtype=None, device=None):
        super().__init__()
        kw = dict(dtype=dtype, device=device)
        ny, nx = grid_shape(width, height, voxel_x, voxel_y)
        self.lidar_dropout = lidar_dropout
        self.patch_embed = Conv2d(3, dim, patch_size, stride=patch_size, **kw)
        self.pillar_canvas = PillarCanvas(width, height, voxel_x, voxel_y, max_points_per_voxel,
                                          feat_channels=(64, dim), **kw)
        self.fusion_conv = Conv2d(2 * dim, dim, 3, padding=1, **kw)
        self.fusion_bn = BatchNorm(dim, **kw)
        self.vit = ViTBackbone(img_size, patch_size, dim, depth, num_heads, num_tokens=ny * nx, **kw)
        self.out_dim = dim if out_dim is None else out_dim

    def forward(self, images: torch.Tensor, points: torch.Tensor, valid: torch.Tensor,
                generator: torch.Generator | None = None) -> torch.Tensor:
        """images (B, H, W, 3) NHWC, points (B, N, 3), valid (B, N); the
        dropout's draw comes from `generator` (torch's global RNG if None)."""
        x_img = self.patch_embed(images.permute(0, 3, 1, 2))  # (B, dim, gh, gw)
        x_lidar = self.pillar_canvas(points, valid).permute(0, 3, 1, 2)
        if self.lidar_dropout is not None and self.training:
            dev = x_lidar.device if generator is None else generator.device
            drop = torch.rand((), generator=generator, device=dev).to(x_lidar.device) <= self.lidar_dropout
            x_lidar = torch.where(drop, 0.0, x_lidar)
        x = F.relu(self.fusion_bn(self.fusion_conv(torch.cat([x_img, x_lidar], dim=1))))
        x = self.vit(tokens=x.flatten(2).transpose(1, 2))[:, 1:]  # row-major over (gh, gw)
        return adaptive_avg_pool1d(x, self.out_dim)


class EarlyFusionViTCNNEncoder(nn.Module):
    """Early fusion + the dense-map head for HiSup and FFL. Output (B,
    out_size, out_size, out_dim) NHWC."""

    def __init__(self, img_size: int = 224, patch_size: int = 8, dim: int = 384, depth: int = 12,
                 num_heads: int = 6, out_size: int = 224, out_dim: int = 256, width: float = 224.0,
                 height: float = 224.0, voxel_x: float = 8.0, voxel_y: float = 8.0, max_points_per_voxel: int = 64,
                 lidar_dropout: float | None = None, dtype=None, device=None):
        super().__init__()
        self.out_size = out_size
        self.fusion_vit = EarlyFusionViTEncoder(img_size, patch_size, dim, depth, num_heads, out_dim=None,
                                                width=width, height=height, voxel_x=voxel_x, voxel_y=voxel_y,
                                                max_points_per_voxel=max_points_per_voxel,
                                                lidar_dropout=lidar_dropout, dtype=dtype, device=device)
        self.conv0 = Conv2d(dim, out_dim, 3, padding=1, bias=True, dtype=dtype, device=device)
        self.bn0 = BatchNorm(out_dim, dtype=dtype, device=device)

    def forward(self, images: torch.Tensor, points: torch.Tensor, valid: torch.Tensor,
                generator: torch.Generator | None = None) -> torch.Tensor:
        tokens = self.fusion_vit(images, points, valid, generator)
        return token_map_head(tokens, self.conv0, self.bn0, self.out_size)
