"""Ordered segment sums of the PillarFeatureNet's point rows, and the two
operations whose backward they are.

The PillarFeatureNet (`models/pointpillars.py`, JAX pointpillars.py:38-58)
max-pools each pillar's points and gathers the pooled row back to them.
Their gradients are segment sums over the 3.2M point rows (B·N at batch 16):
the gather's (`pooled[pillar_id]`) sums each pillar's point gradients, and
the segment max's divides a pillar's gradient by the count of its points
that tie for the maximum. JAX takes both as XLA scatter-adds, which on the
CPU add each segment's rows one by one in row order.

- `run_sums` is the plain PyTorch version of that sum, for any ids: each
  segment's rows added in row order from +0.0, each add rounded to the
  rows' dtype (bfloat16 too: the accumulation dtype is the rows', as
  PyTorch's CPU `index_put_` and `scatter_add` accumulate). It is JAX's
  order, and autograd's gradient on the CPU bit for bit at float64 and
  bfloat16; at float32 PyTorch's CPU `index_put_` adds a segment of more
  than about a thousand rows in another order.
- `run_sums_cuda` launches `csrc/run_sums.cu`, which gives the same bits on
  the card, from the layout `PillarCanvas` leaves: B samples of N / B rows,
  each sample's pillars contiguous runs and its last segment the dump cell
  (see the source). The card's own routes are an id sort (the gather) and,
  under `torch.use_deterministic_algorithms`, two (N, C) int64 index
  tensors (the tie count's `scatter_add`).
- `gather_rows` and `segment_max_rows` are the forward operations with
  those backwards (`torch.autograd.Function`s): the forwards are PyTorch's
  `index_select` and `scatter_reduce(..., "amax", include_self=False)`,
  the backwards autograd's formulas with the sums taken by `run_sums_auto`.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from .build import load
from .segment import _expand, rank_in_run

_DTYPES = {torch.float32: 0, torch.float64: 1, torch.bfloat16: 2}


def _check(x: torch.Tensor, ids: torch.Tensor, num_segments: int) -> None:
    if x.dtype not in _DTYPES:
        raise ValueError(f"run sums take float32, float64 or bfloat16 rows, got {x.dtype}")
    if x.dim() != 2 or ids.dtype != torch.int64 or tuple(ids.shape) != (x.shape[0],):
        raise ValueError(f"run sums take rows (N, C) and int64 ids (N,), got {tuple(x.shape)} and {ids.dtype} "
                         f"{tuple(ids.shape)}")
    if ids.device != x.device:
        raise ValueError("run sums take rows and ids on one device")
    if num_segments < 1:
        raise ValueError(f"run sums take num_segments >= 1, got {num_segments}")


def run_sums(x: torch.Tensor, ids: torch.Tensor, num_segments: int) -> torch.Tensor:
    """The plain version of `csrc/run_sums.cu`: (num_segments, C) sums of
    the rows x (N, C) of each segment ids (N,) int64, added in row order
    from +0.0 at x's dtype, for any ids in [0, num_segments).

    The rows are grouped by a stable sort by id, so each segment's rows keep
    their order; its k-th row goes to slot k of a table, and one elementwise
    add per k sums the tables left to right. The tables grow in levels of
    ranks [0, 1), [1, 2), [2, 4), [4, 8), ...: level [lo, hi) holds only the
    segments with more than lo rows, so the tables together hold fewer than
    2·N + num_segments rows; an empty slot adds +0.0, which leaves a sum
    that started at +0.0 unchanged."""
    _check(x, ids, num_segments)
    C = x.shape[1]
    out = x.new_zeros((num_segments, C))
    if x.shape[0] == 0:
        return out
    sid, order = torch.sort(ids, stable=True)
    rows = x.index_select(0, order)
    rank = rank_in_run(sid)
    counts = torch.bincount(ids, minlength=num_segments)
    by_count = torch.argsort(counts, descending=True, stable=True)
    slot_of = torch.empty_like(by_count)
    slot_of[by_count] = torch.arange(num_segments, device=x.device)
    longest = int(counts.max())
    lo = 0
    while lo < longest:
        hi = min(max(2 * lo, 1), longest)
        active = by_count[: int((counts > lo).sum())]
        table = x.new_zeros((len(active), hi - lo, C))
        at = (rank >= lo) & (rank < hi)
        table[slot_of[sid[at]], rank[at] - lo] = rows[at]
        acc = out[active]
        for k in range(hi - lo):
            acc = acc + table[:, k]
        out[active] = acc
        lo = hi
    return out


def run_sums_cuda(x: torch.Tensor, ids: torch.Tensor, num_segments: int, samples: int) -> torch.Tensor:
    """Launch `csrc/run_sums.cu` on the current stream. Same result as
    `run_sums` for ids in the kernel's layout: x's N rows in `samples`
    samples of N / samples rows, sample b's ids in [b·K, (b + 1)·K) for
    K = num_segments / samples, its id b·K + K − 1 the dump cell, every
    other id's rows one contiguous run (as `PillarCanvas` flattens
    `assign_pillars`'s sorted pillars)."""
    _check(x, ids, num_segments)
    if not x.is_cuda:
        raise ValueError("run_sums_cuda takes CUDA tensors; the plain version is ops.run_sums.run_sums")
    if not (x.is_contiguous() and ids.is_contiguous()):
        raise ValueError("run_sums_cuda takes contiguous tensors")
    N, C = x.shape
    if samples < 1 or N % samples or num_segments % samples:
        raise ValueError(f"run_sums_cuda takes N = {N} rows and {num_segments} segments in {samples} equal samples")
    out = torch.zeros((num_segments, C), dtype=x.dtype, device=x.device)  # an empty segment's sum
    with torch.cuda.device(x.device):
        err = _lib().run_sums_launch(x.data_ptr(), ids.data_ptr(), out.data_ptr(), N, C, samples,
                                     num_segments // samples, _DTYPES[x.dtype],
                                     torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"run_sums kernel launch failed with CUDA error {err}")
    run_sums_cuda.launches += 1
    return out


run_sums_cuda.launches = 0


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = load("run_sums")
    lib.run_sums_launch.argtypes = ([ctypes.c_void_p] * 3 + [ctypes.c_longlong, ctypes.c_int, ctypes.c_int,
                                                             ctypes.c_longlong, ctypes.c_int, ctypes.c_void_p])
    lib.run_sums_launch.restype = ctypes.c_int
    lib.run_sums_config.argtypes = [ctypes.c_void_p]
    lib.run_sums_config.restype = ctypes.c_int
    return lib


def run_sums_config() -> dict:
    """The warps a block and the bytes a staged tile that
    `csrc/run_sums.cu` was built with, and the blocks an SM of the current
    card holds at once in each dtype."""
    keys = ("warps", "tile_bytes", "blocks_per_sm_float", "blocks_per_sm_double", "blocks_per_sm_bfloat16")
    out = (ctypes.c_int * len(keys))()
    err = _lib().run_sums_config(out)
    if err != 0:
        raise RuntimeError(f"run_sums occupancy query failed with CUDA error {err}")
    return dict(zip(keys, out))


def run_sums_auto(x: torch.Tensor, ids: torch.Tensor, num_segments: int, samples: int) -> torch.Tensor:
    """The kernel for CUDA tensors, the plain version for CPU tensors."""
    if x.is_cuda:
        return run_sums_cuda(x.contiguous(), ids.contiguous(), num_segments, samples)
    if x.device.type == "cpu":
        return run_sums(x, ids, num_segments)
    raise ValueError(f"run sums: no version for device {x.device}")


class _GatherRows(torch.autograd.Function):
    @staticmethod
    def forward(ctx, table, ids, samples: int):
        ctx.save_for_backward(ids)
        ctx.rows, ctx.samples = table.shape[0], samples
        return table.index_select(0, ids)

    @staticmethod
    def backward(ctx, g):
        (ids,) = ctx.saved_tensors
        return run_sums_auto(g, ids, ctx.rows, ctx.samples), None, None


class _SegmentMaxRows(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, ids, num_segments: int, samples: int):
        out = x.new_full((num_segments, x.shape[1]), float("-inf"))
        out = out.scatter_reduce(0, _expand(ids, x), x, "amax", include_self=False)
        ctx.save_for_backward(x, ids, out)
        ctx.samples = samples
        return out

    @staticmethod
    def backward(ctx, g):
        # autograd's scatter_reduce_backward for "amax": the gradient split
        # evenly over the rows that tie for the maximum, an empty segment
        # counting 1 (its -inf start equals its result)
        x, ids, out = ctx.saved_tensors
        ties = (x == out.index_select(0, ids)).to(x.dtype)
        count = run_sums_auto(ties, ids, out.shape[0], ctx.samples) + (out == float("-inf")).to(x.dtype)
        return ties * (g / count).index_select(0, ids), None, None, None


def gather_rows(table: torch.Tensor, ids: torch.Tensor, samples: int) -> torch.Tensor:
    """table[ids] for a (S, C) table and int64 ids (N,) in `run_sums_cuda`'s
    layout; the gradient sums each segment's rows in row order."""
    return _GatherRows.apply(table, ids, samples)


def segment_max_rows(x: torch.Tensor, ids: torch.Tensor, num_segments: int, samples: int) -> torch.Tensor:
    """The max over each segment's rows of x (N, C), -inf where a segment has
    none (`ops.segment.segment_max`), for int64 ids in `run_sums_cuda`'s
    layout; the gradient's tie counts are ordered run sums."""
    return _SegmentMaxRows.apply(x, ids, num_segments, samples)
