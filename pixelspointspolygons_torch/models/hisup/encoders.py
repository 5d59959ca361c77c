"""HiSup's LiDAR encoder `PointPillarsViTCNNEncoder` — port of
pixelspointspolygons_tpu/models/hisup/encoders.py (:18-56; reference
models/pointpillars/pointpillars_vit_cnn.py): the pillar-ViT tokens
(`pp_vit`, no channel bottleneck) as a map, resized bilinearly to out_size
(`layers.resize_bilinear`, JAX's `jax.image.resize`), then Conv3×3,
BatchNorm and ReLU → (B, S, S, out_dim) NHWC, the head of `ViTCNNEncoder`.
"""

from __future__ import annotations

import torch
from torch import nn

from ..layers import BatchNorm, Conv2d
from ..pointpillars import PointPillarsViTEncoder
from ..vit import token_map_head


class PointPillarsViTCNNEncoder(nn.Module):
    def __init__(self, img_size: int = 224, patch_size: int = 8, dim: int = 384, depth: int = 12,
                 num_heads: int = 6, out_size: int = 224, out_dim: int = 256, width: float = 224.0,
                 height: float = 224.0, voxel_x: float = 8.0, voxel_y: float = 8.0, max_points_per_voxel: int = 64,
                 dtype=None, device=None):
        super().__init__()
        self.out_size = out_size
        self.pp_vit = PointPillarsViTEncoder(img_size, patch_size, dim, depth, num_heads, out_dim=None, width=width,
                                             height=height, voxel_x=voxel_x, voxel_y=voxel_y,
                                             max_points_per_voxel=max_points_per_voxel, dtype=dtype, device=device)
        self.conv0 = Conv2d(dim, out_dim, 3, padding=1, bias=True, dtype=dtype, device=device)
        self.bn0 = BatchNorm(out_dim, dtype=dtype, device=device)

    def forward(self, points: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
        return token_map_head(self.pp_vit(points, valid), self.conv0, self.bn0, self.out_size)
