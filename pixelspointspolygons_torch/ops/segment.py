"""Segment reductions over flat-packed ids — port of
pixelspointspolygons_tpu/ops/segment.py.

`segment_sum` is `index_add_`: no path of the port's calls it any more
(the voxelizer's sums are `ops/voxelize.py::pillar_sums_cuda`, the
PillarFeatureNet's gradients `ops/run_sums.py`); on the card, where the
entry points turn `torch.use_deterministic_algorithms` on, PyTorch takes
its sorted form instead of atomics. `segment_max` is
`scatter_reduce(..., "amax", include_self=False)` over an index expanded
along the feature axes (a stride-0 view, never a (N, C) int64 copy), and
leaves an empty segment at -inf, as `jax.ops.segment_max` does. Its
gradient is split evenly over the elements that tie for a segment's
maximum, as JAX's is; the tie count is exact in any order of its adds
(adds of 1 and 0), but autograd's `scatter_add` takes it under the flag
through two (N, C) int64 index tensors, so the PillarFeatureNet takes
`ops/run_sums.py::segment_max_rows` instead. `rank_in_run` is JAX's
associative max-scan of run starts as `torch.cummax`.
"""

from __future__ import annotations

import torch


def _expand(segment_ids: torch.Tensor, data: torch.Tensor) -> torch.Tensor:
    """The ids (N,) as a view of data's shape (N, ...)."""
    return segment_ids.long().reshape(segment_ids.shape + (1,) * (data.ndim - 1)).expand(data.shape)


def segment_sum(data: torch.Tensor, segment_ids: torch.Tensor, num_segments: int) -> torch.Tensor:
    out = data.new_zeros((num_segments,) + data.shape[1:])
    return out.index_add_(0, segment_ids.long(), data)


def segment_max(data: torch.Tensor, segment_ids: torch.Tensor, num_segments: int) -> torch.Tensor:
    out = data.new_full((num_segments,) + data.shape[1:], float("-inf"))
    return out.scatter_reduce(0, _expand(segment_ids, data), data, "amax", include_self=False)


def segment_mean(data: torch.Tensor, segment_ids: torch.Tensor, num_segments: int,
                 eps: float = 1e-12) -> torch.Tensor:
    s = segment_sum(data, segment_ids, num_segments)
    n = segment_sum(data.new_ones(data.shape[: segment_ids.ndim]), segment_ids, num_segments)
    return s / n.reshape(n.shape + (1,) * (s.ndim - n.ndim)).clamp(min=eps)


def segment_softmax_weights(score: torch.Tensor, segment_ids: torch.Tensor, num_segments: int) -> torch.Tensor:
    """Softmax within segments (attention-style pooling)."""
    ids = segment_ids.long()
    e = torch.exp(score - segment_max(score, ids, num_segments)[ids])
    return e / segment_sum(e, ids, num_segments)[ids].clamp(min=1e-12)


def run_starts(sorted_ids: torch.Tensor) -> torch.Tensor:
    """True at the first element of each run of equal ids along the last axis."""
    prev = torch.cat([torch.full_like(sorted_ids[..., :1], -1), sorted_ids[..., :-1]], dim=-1)
    return sorted_ids != prev


def rank_in_run(sorted_ids: torch.Tensor) -> torch.Tensor:
    """0-based position of each element within its run of equal ids along
    the last axis (`sorted_ids` sorted along it)."""
    idx = torch.arange(sorted_ids.shape[-1], device=sorted_ids.device).expand(sorted_ids.shape)
    run_start = torch.where(run_starts(sorted_ids), idx, 0).cummax(dim=-1).values
    return idx - run_start
