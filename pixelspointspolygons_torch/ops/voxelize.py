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
`assign_pillars` is `voxelize_batch` too.

The centroid sums add each pillar's kept points one by one in sorted order
from +0.0, as JAX's scatter-add does on the CPU: `pillar_sums` in plain
PyTorch (the CPU), `pillar_sums_cuda` through the hand-written kernel
`csrc/pillar_sums.cu` (the card). So the features, like the sort, the
ranks, the kept masks and the counts, have the same bits on the card as on
the CPU, from one call to the next.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch

from .build import load
from .segment import rank_in_run, segment_max


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


def sort_by_pillar(points: torch.Tensor, valid: torch.Tensor, *, width: float, height: float, voxel_x: float,
                   voxel_y: float) -> tuple[torch.Tensor, torch.Tensor, int]:
    """(points sorted by pillar id (B, N, 3), the sorted ids (B, N) int64,
    n_cells): a stable sort, so each pillar's points form one run in input
    order; points outside the grid or not valid take id n_cells and come
    last."""
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
    return pts_s, pid_s, n_cells


def assign_pillars(points: torch.Tensor, valid: torch.Tensor, *, width: float, height: float, voxel_x: float,
                   voxel_y: float, max_points_per_voxel: int) -> PillarAssignment:
    """points: (B, N, 3) (x, y, z) in pixel coordinates; valid: (B, N) bool,
    False on padding."""
    _, nx = grid_shape(width, height, voxel_x, voxel_y)
    pts_s, pid_s, n_cells = sort_by_pillar(points, valid, width=width, height=height, voxel_x=voxel_x,
                                           voxel_y=voxel_y)
    keep = (pid_s < n_cells) & (rank_in_run(pid_s) < max_points_per_voxel)
    pid_kept = torch.where(keep, pid_s, n_cells)

    # the kept points' centroid of each pillar (the dump cell's is 0)
    sums, counts = pillar_sums_auto(pts_s, pid_s, max_points_per_voxel, n_cells)
    centroid = sums / counts.clamp(min=1).to(points.dtype)[..., None]
    c = torch.gather(centroid, 1, pid_kept[..., None].expand(-1, -1, centroid.shape[-1]))

    w = keep.to(points.dtype)[..., None]
    cx = (pid_s % nx).to(points.dtype) * voxel_x + voxel_x / 2
    cy = (pid_s // nx).to(points.dtype) * voxel_y + voxel_y / 2
    feats = torch.cat([pts_s, pts_s - c, (pts_s[..., 0] - cx)[..., None], (pts_s[..., 1] - cy)[..., None]], dim=-1)
    return PillarAssignment(pts_s, pid_kept, keep, feats * w, n_cells)


def _check_sums_inputs(pts_s: torch.Tensor, pid_s: torch.Tensor, cap: int, n_cells: int) -> None:
    if pts_s.dtype not in (torch.float32, torch.float64):
        raise ValueError(f"pillar sums take float32 or float64 points, got {pts_s.dtype}")
    if pts_s.requires_grad:
        raise ValueError("pillar sums have no backward: the points must not require a gradient")
    if pts_s.dim() != 3 or pid_s.dtype != torch.int64 or tuple(pid_s.shape) != tuple(pts_s.shape[:2]):
        raise ValueError(f"pillar sums take points (B, N, C) and int64 ids (B, N), got {tuple(pts_s.shape)} and "
                         f"{pid_s.dtype} {tuple(pid_s.shape)}")
    if pid_s.device != pts_s.device:
        raise ValueError("pillar sums take points and ids on one device")
    if cap < 1 or n_cells < 1:
        raise ValueError(f"pillar sums take cap >= 1 and n_cells >= 1, got {cap} and {n_cells}")


def pillar_sums(pts_s: torch.Tensor, pid_s: torch.Tensor, cap: int, n_cells: int) -> tuple[torch.Tensor, torch.Tensor]:
    """The plain version of `csrc/pillar_sums.cu`. pts_s (B, N, C) and
    pid_s (B, N) int64 sorted by pillar id, as `sort_by_pillar` gives them.
    Returns (sums (B, n_cells + 1, C) of pts_s's dtype, counts
    (B, n_cells + 1) int32): per pillar the sum of its first min(run
    length, cap) points, added one by one in sorted order from +0.0, and
    their number; the dump cell n_cells is zero. Each kept point has a slot
    of its own (pillar, rank), so a non-accumulating scatter places them
    and one elementwise add per rank sums them left to right: the empty
    slots add +0.0, which leaves a sum that started at +0.0 unchanged."""
    _check_sums_inputs(pts_s, pid_s, cap, n_cells)
    B, N, C = pts_s.shape
    rank = rank_in_run(pid_s)
    keep = (pid_s < n_cells) & (rank < cap)
    slots = pts_s.new_zeros((B, n_cells + 1, min(cap, N), C))
    sample = torch.arange(B, device=pts_s.device)[:, None].expand(B, N)
    slots[sample[keep], pid_s[keep], rank[keep]] = pts_s[keep]
    sums = pts_s.new_zeros((B, n_cells + 1, C))
    for r in range(slots.shape[2]):
        sums = sums + slots[:, :, r]
    counts = torch.zeros((B, n_cells + 1), dtype=torch.int32, device=pts_s.device)
    counts.index_put_((sample[keep], pid_s[keep]), torch.ones((), dtype=torch.int32, device=pts_s.device),
                      accumulate=True)
    return sums, counts


def pillar_sums_cuda(pts_s: torch.Tensor, pid_s: torch.Tensor, cap: int,
                     n_cells: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Launch `csrc/pillar_sums.cu` on the current stream. Same contract as
    `pillar_sums`, for points of 1 to 4 coordinates (one lane each for
    each of a warp's 8 pillars)."""
    _check_sums_inputs(pts_s, pid_s, cap, n_cells)
    if not pts_s.is_cuda:
        raise ValueError("pillar_sums_cuda takes CUDA tensors; the plain version is ops.voxelize.pillar_sums")
    if not (pts_s.is_contiguous() and pid_s.is_contiguous()):
        raise ValueError("pillar_sums_cuda takes contiguous tensors")
    if not 1 <= pts_s.shape[2] <= 4:
        raise ValueError(f"pillar_sums_cuda takes 1 to 4 coordinates a point, got {pts_s.shape[2]}")
    sums, counts = _launch(_lib(), pts_s, pid_s, cap, n_cells)
    pillar_sums_cuda.launches += 1
    return sums, counts


pillar_sums_cuda.launches = 0


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = bind(load("pillar_sums"))
    lib.pillar_sums_config.argtypes = [ctypes.c_void_p]
    lib.pillar_sums_config.restype = ctypes.c_int
    return lib


def bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Declare `pillar_sums_launch` of a library built from a version of
    `csrc/pillar_sums.cu`, once rather than on every call."""
    lib.pillar_sums_launch.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int, ctypes.c_longlong]
                                       + [ctypes.c_int] * 4 + [ctypes.c_void_p])
    lib.pillar_sums_launch.restype = ctypes.c_int
    return lib


def _launch(lib: ctypes.CDLL, pts_s: torch.Tensor, pid_s: torch.Tensor, cap: int, n_cells: int):
    """Run `lib.pillar_sums_launch` (a library declared by `bind`) on
    tensors that `pillar_sums_cuda` has checked, and count nothing: the
    port launches through `pillar_sums_cuda` only. The timing tool
    `pillar_sums_bench.py` calls it with libraries built from other
    versions of `csrc/pillar_sums.cu`."""
    B, N, C = pts_s.shape
    sums = torch.empty((B, n_cells + 1, C), dtype=pts_s.dtype, device=pts_s.device)
    counts = torch.empty((B, n_cells + 1), dtype=torch.int32, device=pts_s.device)
    with torch.cuda.device(pts_s.device):
        err = lib.pillar_sums_launch(
            pts_s.data_ptr(), pid_s.data_ptr(), sums.data_ptr(), counts.data_ptr(), B, N, C, int(n_cells),
            int(cap), 0 if pts_s.dtype == torch.float32 else 1, torch.cuda.current_stream().cuda_stream,
        )
    if err != 0:
        raise RuntimeError(f"pillar_sums kernel launch failed with CUDA error {err}")
    return sums, counts


def sums_kernel_config() -> dict:
    """The warps a block, the pillars a warp takes at a time, the bytes a
    staged chunk, the tile positions a thread reads and the most
    coordinates a point that `csrc/pillar_sums.cu` was built with, and the
    blocks an SM of the current card holds at once in each dtype."""
    keys = ("warps", "per_warp", "stage_bytes", "scan", "max_coords", "blocks_per_sm_float", "blocks_per_sm_double")
    out = (ctypes.c_int * len(keys))()
    err = _lib().pillar_sums_config(out)
    if err != 0:
        raise RuntimeError(f"pillar_sums occupancy query failed with CUDA error {err}")
    return dict(zip(keys, out))


def pillar_sums_auto(pts_s: torch.Tensor, pid_s: torch.Tensor, cap: int, n_cells: int):
    """The kernel for CUDA tensors, the plain version for CPU tensors."""
    if pts_s.is_cuda:
        return pillar_sums_cuda(pts_s, pid_s, cap, n_cells)
    if pts_s.device.type == "cpu":
        return pillar_sums(pts_s, pid_s, cap, n_cells)
    raise ValueError(f"pillar sums: no version for device {pts_s.device}")


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

