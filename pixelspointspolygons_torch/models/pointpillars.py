"""PointPillars LiDAR encoders: pillar voxelization → PillarFeatureNet →
dense canvas → ViT trunk or conv pyramid — port of
pixelspointspolygons_tpu/models/pointpillars.py (:31-192).

- `PillarFeatureNet` (JAX :38-58): per layer a bias-free Dense, BatchNorm
  (`layers.RowBatchNorm`: its statistics over millions of rows are summed
  accurately on the CPU too) and ReLU, zeroed on the points that are not kept, then the max over each
  pillar's kept points (`ops/voxelize.py::masked_segment_max`), which
  every layer but the last concatenates back to its points. Two layers,
  8 → 64 → dim, as the reference's feat_channels [64, patch_feature_dim].
  The gradients of the pooling's tie counts and of the gather back to the
  points are segment sums over the 3.2M rows, taken in row order as JAX's
  scatter-adds on the CPU take them: on the card by the hand-written kernel
  `csrc/run_sums.cu` (`ops/run_sums.py`), so training repeats its bits.
- `PillarCanvas` (JAX :61-104): the batch is voxelized at once and then
  flattened into one point set of B·N rows with offset pillar ids, so the
  train-mode BatchNorm takes its statistics over all B·N rows, the padded
  and dropped ones included (they are zero before the bias-free Dense, so
  zero after it). The padding is therefore part of the result: the loader
  pads each cloud to `max_num_points` as JAX's does, and nothing trims it.
- `PointPillarsViTEncoder` (JAX :107-144): the (ny, nx) canvas as the
  tokens of a ViT trunk without a patch embedding, CLS dropped, the
  channel bottleneck to out_dim.
- `PointPillarsDenseEncoder` (JAX :147-192): canvas → three stride-1/2/2
  conv pairs → each level resized bilinearly to the first's size and
  concatenated → resized to out_size → Conv3×3, BatchNorm, ReLU. Its
  convolutions pad as flax's "SAME" (at stride 2 on an even size: 0 before,
  1 after). No experiment selects it (`encoder=pointpillars`, 512 px).

Module names follow the flax tree (`utils/bridge.py`): `pillar_canvas`,
its `PillarFeatureNet_0` as `pfn` with Dense_i/BatchNorm_i as dense{i}/
bn{i}, `vit`, the dense encoder's Conv_i/BatchNorm_i as conv{i}/bn{i}.
`dtype` is the compute dtype (`layers.py`): the features are cast to it,
each Dense computes in it, each BatchNorm computes in float32 and gives it,
the max pooling and its finfo.min mask are at it.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.run_sums import gather_rows
from ..ops.voxelize import assign_pillars, grid_shape, masked_segment_max, cell_offsets
from .layers import BatchNorm, Dense, RowBatchNorm, SameConv2d, adaptive_avg_pool1d, cast_to, resize_bilinear
from .vit import ViTBackbone

PFN_IN_CHANNELS = 8  # [x, y, z, x-xc, y-yc, z-zc, x-xp, y-yp]


class PillarFeatureNet(nn.Module):
    """Per-point MLP with pillar-max context → pooled per-pillar features."""

    def __init__(self, feat_channels=(64, 384), dtype=None, device=None):
        super().__init__()
        self.compute_dtype = dtype
        self.n_layers = len(feat_channels)
        cin = PFN_IN_CHANNELS
        for i, ch in enumerate(feat_channels):
            self.add_module(f"dense{i}", Dense(cin, ch, bias=False, dtype=dtype, device=device))
            self.add_module(f"bn{i}", RowBatchNorm(ch, dtype=dtype, device=device))
            cin = 2 * ch

    def forward(self, feats: torch.Tensor, pillar_id: torch.Tensor, keep: torch.Tensor,
                num_segments: int, samples: int) -> torch.Tensor:
        """feats (N, 8), pillar_id (N,) int64 in [0, num_segments), keep (N,)
        bool → (num_segments, C_last) pooled features. The ids are those of
        `samples` voxelized samples, flattened as `PillarCanvas` does: the
        backwards of the max pooling and of the gather to the points are
        ordered run sums over them (`ops/run_sums.py`)."""
        x = cast_to(feats, self.compute_dtype)
        for i in range(self.n_layers):
            x = F.relu(getattr(self, f"bn{i}")(getattr(self, f"dense{i}")(x)))
            x = x * keep[:, None]
            pooled = masked_segment_max(x, keep, pillar_id, num_segments, samples)
            if i < self.n_layers - 1:
                x = torch.cat([x, gather_rows(pooled, pillar_id, samples)], dim=-1)
        return pooled


class PillarCanvas(nn.Module):
    """Voxelize a batch of point clouds and give the dense (B, ny, nx, C) canvas."""

    def __init__(self, width: float, height: float, voxel_x: float, voxel_y: float, max_points_per_voxel: int,
                 feat_channels=(64, 384), dtype=None, device=None):
        super().__init__()
        self.grid = dict(width=width, height=height, voxel_x=voxel_x, voxel_y=voxel_y)
        self.max_points_per_voxel = max_points_per_voxel
        self.pfn = PillarFeatureNet(tuple(feat_channels), dtype=dtype, device=device)

    def forward(self, points: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
        """points (B, N, 3) in pixel coordinates, valid (B, N) bool."""
        ny, nx = grid_shape(**self.grid)
        a = assign_pillars(points, valid, max_points_per_voxel=self.max_points_per_voxel, **self.grid)
        B, N = valid.shape
        flat_pid = (a.pillar_id + cell_offsets(B, a.n_cells, points.device)).reshape(-1)
        pooled = self.pfn(a.features.reshape(B * N, -1), flat_pid, a.keep.reshape(-1), B * (a.n_cells + 1), B)
        # each sample's dump cell dropped, the pillars laid out as the canvas
        return pooled.reshape(B, a.n_cells + 1, -1)[:, : a.n_cells].reshape(B, ny, nx, -1)


class PointPillarsViTEncoder(nn.Module):
    """LiDAR-only token encoder: the pillar canvas as the ViT's patch embedding."""

    def __init__(self, img_size: int = 224, patch_size: int = 8, dim: int = 384, depth: int = 12,
                 num_heads: int = 6, out_dim: int | None = 256, width: float = 224.0, height: float = 224.0,
                 voxel_x: float = 8.0, voxel_y: float = 8.0, max_points_per_voxel: int = 64, dtype=None,
                 device=None):
        super().__init__()
        ny, nx = grid_shape(width, height, voxel_x, voxel_y)
        self.pillar_canvas = PillarCanvas(width, height, voxel_x, voxel_y, max_points_per_voxel,
                                          feat_channels=(64, dim), dtype=dtype, device=device)
        self.vit = ViTBackbone(img_size, patch_size, dim, depth, num_heads, num_tokens=ny * nx, dtype=dtype,
                               device=device)
        self.out_dim = dim if out_dim is None else out_dim

    def forward(self, points: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
        canvas = self.pillar_canvas(points, valid)
        B, ny, nx, C = canvas.shape
        x = self.vit(tokens=canvas.reshape(B, ny * nx, C))[:, 1:]
        return adaptive_avg_pool1d(x, self.out_dim)


class PointPillarsDenseEncoder(nn.Module):
    """Full PointPillars (canvas → conv pyramid → dense map) for HiSup and FFL
    LiDAR-only at 512 px (reference pointpillars_o3d.py:111-220, simplified
    as in the JAX package). Output (B, out_size, out_size, out_dim) NHWC."""

    def __init__(self, width: float, height: float, voxel_x: float, voxel_y: float, max_points_per_voxel: int,
                 out_channels=(128, 128, 128), out_size: int = 224,
                 out_dim: int = 256, dtype=None, device=None):
        super().__init__()
        kw = dict(dtype=dtype, device=device)
        self.out_size = out_size
        self.n_levels = len(out_channels)
        self.pillar_canvas = PillarCanvas(width, height, voxel_x, voxel_y, max_points_per_voxel,
                                          feat_channels=(64, 64), **kw)
        cin = 64
        for i, ch in enumerate(out_channels):
            stride = 1 if i == 0 else 2
            self.add_module(f"conv{2 * i}", SameConv2d(cin, ch, 3, stride, **kw))
            self.add_module(f"bn{2 * i}", BatchNorm(ch, **kw))
            self.add_module(f"conv{2 * i + 1}", SameConv2d(ch, ch, 3, **kw))
            self.add_module(f"bn{2 * i + 1}", BatchNorm(ch, **kw))
            cin = ch
        last = 2 * self.n_levels
        self.add_module(f"conv{last}", SameConv2d(sum(out_channels), out_dim, 3, **kw))
        self.add_module(f"bn{last}", BatchNorm(out_dim, **kw))

    def forward(self, points: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
        return self.pyramid(self.pillar_canvas(points, valid))

    def pyramid(self, canvas: torch.Tensor) -> torch.Tensor:
        """The conv pyramid over the (B, ny, nx, 64) pillar canvas."""
        x = canvas.permute(0, 3, 1, 2)
        feats = []
        for j in range(2 * self.n_levels):
            x = F.relu(getattr(self, f"bn{j}")(getattr(self, f"conv{j}")(x)))
            if j % 2:
                feats.append(x)
        # FPN-style: every level resized to the first's size, concatenated
        size = feats[0].shape[-1]
        x = torch.cat([resize_bilinear(f, size) for f in feats], dim=1)
        x = resize_bilinear(x, self.out_size)
        last = 2 * self.n_levels
        return F.relu(getattr(self, f"bn{last}")(getattr(self, f"conv{last}")(x))).permute(0, 2, 3, 1)
