"""Pillar voxelization on the device — port of
pixelspointspolygons_tpu/ops/voxelize.py (:44-129).

The reference's Open3D-ML PointPillars voxelization and PillarFeatureNet
input (models/pointpillars/pointpillars_o3d.py:11-107), with fixed shapes:
- a grid over [0, width) x [0, height) of voxel_x x voxel_y pillars (z is
  not cut);
- at most `max_points_per_voxel` points kept per pillar, the FIRST ones in
  input order: a stable sort by pillar id (`torch.sort(stable=True)`, as
  JAX's `argsort(stable=True)`) and each point's rank within its pillar's
  run. This cap is the knob of the LiDAR-density ablations (4 to 512), so
  the kept points are exactly JAX's;
- per point the decorated features [x, y, z, x-xc, y-yc, z-zc, x-xp, y-yp]
  (offsets to the pillar's kept-point centroid and to the pillar's centre),
  zero for a point that is not kept.

No `max_num_voxels` cap: the canvas is dense, as in the JAX package (its
docstring records this divergence from the reference).

The batch axis is written out (JAX vmaps `assign_pillars` over it in
`voxelize_batch`), so each tensor here carries a leading (B,) and
`assign_pillars` is `voxelize_batch` too. On the card the centroid sums are
`index_add_` with atomics, which sum in no fixed order: the features
differ from the CPU's in the last bits; the sort, the ranks, the kept
masks and the counts are exact.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from .segment import rank_in_run, segment_max, segment_sum


class PillarAssignment(NamedTuple):
    """Per-point pillar assignment of a batch (each row sorted by pillar id)."""

    points: torch.Tensor  # (B, N, 3) sorted by pillar id (points outside last)
    pillar_id: torch.Tensor  # (B, N) int64; n_cells for dropped or invalid points
    keep: torch.Tensor  # (B, N) bool: valid, inside and within the pillar's capacity
    features: torch.Tensor  # (B, N, 8) decorated PFN input features
    n_cells: int  # nx * ny


def grid_shape(width: float, height: float, voxel_x: float, voxel_y: float) -> tuple[int, int]:
    """(ny, nx) of the pillar grid."""
    return int(round(height / voxel_y)), int(round(width / voxel_x))


def assign_pillars(points: torch.Tensor, valid: torch.Tensor, *, width: float, height: float, voxel_x: float,
                   voxel_y: float, max_points_per_voxel: int) -> PillarAssignment:
    """points: (B, N, 3) (x, y, z) in pixel coordinates; valid: (B, N) bool,
    False on padding."""
    ny, nx = grid_shape(width, height, voxel_x, voxel_y)
    n_cells = nx * ny
    x, y = points[..., 0], points[..., 1]
    ix = torch.floor(x / voxel_x).to(torch.int64)
    iy = torch.floor(y / voxel_y).to(torch.int64)
    inside = (0 <= ix) & (ix < nx) & (0 <= iy) & (iy < ny) & valid
    pid = torch.where(inside, iy * nx + ix, n_cells)

    # a stable sort by pillar id keeps input order within a pillar: first come, first kept
    pid_s, order = torch.sort(pid, dim=1, stable=True)
    pts_s = torch.gather(points, 1, order[..., None].expand(-1, -1, points.shape[-1]))
    keep = (pid_s < n_cells) & (rank_in_run(pid_s) < max_points_per_voxel)
    pid_kept = torch.where(keep, pid_s, n_cells)

    # the kept points' centroid of each pillar, over B·(n_cells + 1) segments
    B, N = pid.shape
    flat = (pid_kept + cell_offsets(B, n_cells, pid.device)).reshape(-1)
    w = keep.to(points.dtype)[..., None]
    sums = segment_sum((pts_s * w).reshape(B * N, -1), flat, B * (n_cells + 1))
    cnts = segment_sum(w.reshape(B * N, 1), flat, B * (n_cells + 1))
    c = (sums / cnts.clamp(min=1.0))[flat].reshape(B, N, -1)

    cx = (pid_s % nx).to(points.dtype) * voxel_x + voxel_x / 2
    cy = (pid_s // nx).to(points.dtype) * voxel_y + voxel_y / 2
    feats = torch.cat([pts_s, pts_s - c, (pts_s[..., 0] - cx)[..., None], (pts_s[..., 1] - cy)[..., None]], dim=-1)
    return PillarAssignment(pts_s, pid_kept, keep, feats * w, n_cells)


def cell_offsets(batch: int, n_cells: int, device=None) -> torch.Tensor:
    """(B, 1) offsets that give each sample's pillars (and its dump cell) ids
    of their own in one flat id space of B·(n_cells + 1) segments."""
    return (torch.arange(batch, device=device) * (n_cells + 1))[:, None]


def masked_segment_max(x: torch.Tensor, keep: torch.Tensor, segment_ids: torch.Tensor,
                       num_segments: int) -> torch.Tensor:
    """The max over each segment's kept rows of x (N, C), 0 where a segment
    has none (JAX pointpillars.py:31-35): rows not kept read finfo.min, and
    a result at or below finfo.min/2 (an empty segment's -inf, a segment of
    rows not kept) becomes 0, at x's dtype."""
    neg = torch.finfo(x.dtype).min
    pooled = segment_max(torch.where(keep[:, None], x, neg), segment_ids, num_segments)
    return torch.where(pooled > neg / 2, pooled, 0.0)


def scatter_pillars(point_feats: torch.Tensor, pillar_id: torch.Tensor, keep: torch.Tensor, n_cells: int,
                    ny: int, nx: int) -> torch.Tensor:
    """Max-pool per-point features (N, C) of one sample into its pillars and
    lay them out as a dense (ny, nx, C) canvas; an empty pillar is zero."""
    return masked_segment_max(point_feats, keep, pillar_id, n_cells + 1)[:n_cells].reshape(ny, nx, -1)

