"""The voxelizer's per-pillar sums (`ops/voxelize.py::pillar_sums`, the
plain version of `csrc/pillar_sums.cu`) on the CPU: bitwise equal to the
`index_add_` route the port took before (both add each pillar's kept
points one by one in sorted order from +0.0), and `assign_pillars`
bitwise equal to JAX's `voxelize_batch`, whose scatter-add sums in the
same order on the CPU. The plain sums also equal JAX's `segment_sum` of
`assign_pillars` bit for bit, in float32 and float64, on the layouts the
kernel splits its work on (`ops/pillar_layouts.py`). The kernel itself
runs on the card only (tests/test_torch_kernels.py).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pixelspointspolygons_tpu.ops import voxelize as jvox
from pixelspointspolygons_tpu.ops.segment import rank_in_run as jax_rank_in_run
from pixelspointspolygons_tpu.ops.segment import segment_sum as jax_segment_sum
from pixelspointspolygons_torch.ops import voxelize
from pixelspointspolygons_torch.ops.pillar_layouts import (
    AHEAD_ROWS,
    CAPS,
    CHUNK_POINTS,
    EDGE_RUNS,
    TILE_ROWS,
    small_layouts,
)
from pixelspointspolygons_torch.ops.segment import rank_in_run, segment_sum

S, VOXEL = 32, 8.0
GRID = dict(width=float(S), height=float(S), voxel_x=VOXEL, voxel_y=VOXEL)
N_CELLS = 16


def cloud(seed: int, dtype=np.float32, B: int = 3, N: int = 400):
    """Points over [-4, S + 4) (some outside the grid) with a random
    validity mask; pillar 5 of sample 0 left empty, pillar 0 of sample 0
    given 40 points (over caps 1 and 4), sample 2 with no valid point."""
    r = np.random.RandomState(seed)
    pts = r.uniform(-4, S + 4, (B, N, 3)).astype(dtype)
    pts[:, :, 2] = r.normal(0, 50, (B, N))  # z of either sign
    valid = r.rand(B, N) < 0.8
    in_5 = (np.floor(pts[0, :, 0] / VOXEL) == 1) & (np.floor(pts[0, :, 1] / VOXEL) == 1)
    pts[0, in_5, :2] += 8.0  # pillar 5 (row 1, column 1) empty
    pts[0, :40, :2] = r.uniform(0, VOXEL, (40, 2))  # pillar 0 over its cap
    valid[0, :40] = True
    valid[2] = False
    return pts, valid


def sorted_inputs(pts, valid):
    return voxelize.sort_by_pillar(torch.from_numpy(pts), torch.from_numpy(valid), **GRID)


def index_add_sums(pts_s, pid_s, cap, n_cells):
    """The route `assign_pillars` took before: two `index_add_` calls over
    flat ids, the points not kept added as zeros to each sample's dump
    cell."""
    B, N, C = pts_s.shape
    keep = (pid_s < n_cells) & (rank_in_run(pid_s) < cap)
    flat = (torch.where(keep, pid_s, n_cells) + voxelize.cell_offsets(B, n_cells)).reshape(-1)
    w = keep.to(pts_s.dtype)[..., None]
    sums = segment_sum((pts_s * w).reshape(B * N, C), flat, B * (n_cells + 1))
    cnts = segment_sum(w.reshape(B * N, 1), flat, B * (n_cells + 1))
    return sums.reshape(B, n_cells + 1, C), cnts.reshape(B, n_cells + 1)


def bits(t: torch.Tensor) -> np.ndarray:
    a = t.numpy()
    return a.view(np.uint32 if a.dtype == np.float32 else np.uint64)


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("cap", [1, 4, 1000])  # 1000 covers every pillar
def test_pillar_sums_equal_index_add_route(cap, dtype):
    pts, valid = cloud(0, dtype)
    pts_s, pid_s, n_cells = sorted_inputs(pts, valid)
    assert n_cells == N_CELLS
    sums, counts = voxelize.pillar_sums(pts_s, pid_s, cap, n_cells)
    want_sums, want_counts = index_add_sums(pts_s, pid_s, cap, n_cells)
    assert sums.dtype == pts_s.dtype and counts.dtype == torch.int32
    np.testing.assert_array_equal(bits(sums), bits(want_sums))
    np.testing.assert_array_equal(counts.numpy(), want_counts.numpy().astype(np.int32))
    assert counts[0, 5] == 0 and float(sums[0, 5].abs().sum()) == 0.0  # the empty pillar
    assert counts[0, 0] == min(cap, int((pid_s[0] == 0).sum())) and int((pid_s[0] == 0).sum()) >= 40
    assert int(counts[2].sum()) == 0 and float(sums[2].abs().sum()) == 0.0  # no valid point
    assert int(counts[:, N_CELLS].sum()) == 0 and float(sums[:, N_CELLS].abs().sum()) == 0.0  # the dump cell
    # the points outside the grid are in no pillar
    inside = (valid & (pts[..., 0] >= 0) & (pts[..., 0] < S) & (pts[..., 1] >= 0) & (pts[..., 1] < S))
    assert int(counts.sum()) <= int(inside.sum()) and (int(counts.sum()) == int(inside.sum())) == (cap == 1000)


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("cap", [1, 4, 1000])
def test_pillar_sums_add_in_sorted_order(cap, dtype):
    """Each sum is the left-to-right sum of its run's first min(run, cap)
    points, one rounding per add (numpy adds the same way)."""
    pts, valid = cloud(1, dtype)
    pts_s, pid_s, n_cells = sorted_inputs(pts, valid)
    sums, _ = voxelize.pillar_sums(pts_s, pid_s, cap, n_cells)
    p_np, id_np = pts_s.numpy(), pid_s.numpy()
    for b in range(p_np.shape[0]):
        for cell in range(n_cells):
            acc = np.zeros(3, dtype)
            for x in p_np[b][id_np[b] == cell][:cap]:
                acc = (acc + x).astype(dtype)
            np.testing.assert_array_equal(sums[b, cell].numpy(), acc)


@pytest.mark.parametrize("cap", [1, 4, 1000])
def test_assign_pillars_features_equal_jax(cap):
    """The decorated features bit for bit: XLA's CPU scatter-add and the
    plain sums add each pillar's points in the same order."""
    pts, valid = cloud(2)
    got = voxelize.assign_pillars(torch.from_numpy(pts), torch.from_numpy(valid), max_points_per_voxel=cap, **GRID)
    want = jvox.voxelize_batch(jnp.asarray(pts), jnp.asarray(valid), max_points_per_voxel=cap, **GRID)
    np.testing.assert_array_equal(bits(got.features), np.asarray(want.features).view(np.uint32))
    np.testing.assert_array_equal(got.keep.numpy(), np.asarray(want.keep))


def test_pillar_sums_refuse_a_gradient_and_other_dtypes():
    pts, valid = cloud(3)
    pts_s, pid_s, n_cells = sorted_inputs(pts, valid)
    with pytest.raises(ValueError, match="gradient"):
        voxelize.pillar_sums(pts_s.clone().requires_grad_(), pid_s, 4, n_cells)
    with pytest.raises(ValueError, match="gradient"):
        voxelize.assign_pillars(torch.from_numpy(pts).requires_grad_(), torch.from_numpy(valid),
                                max_points_per_voxel=4, **GRID)
    for dtype in (torch.float16, torch.bfloat16, torch.int32):
        with pytest.raises(ValueError, match=str(dtype)):
            voxelize.pillar_sums(pts_s.to(dtype), pid_s, 4, n_cells)
    with pytest.raises(ValueError, match="CUDA tensors"):
        voxelize.pillar_sums_cuda(pts_s, pid_s, 4, n_cells)
    with pytest.raises(ValueError, match="int64"):
        voxelize.pillar_sums(pts_s, pid_s.to(torch.int32), 4, n_cells)
    before = voxelize.pillar_sums_cuda.launches
    voxelize.pillar_sums_auto(pts_s, pid_s, 4, n_cells)  # the CPU takes the plain version
    assert voxelize.pillar_sums_cuda.launches == before


@functools.partial(jax.jit, static_argnames="n_cells")
def _jax_sums(pts, pid, cap, n_cells):
    def one(pts, pid):
        keep = (pid < n_cells) & (jax_rank_in_run(pid) < cap)
        pid_kept = jnp.where(keep, pid, n_cells)
        w = keep.astype(pts.dtype)[:, None]
        return jax_segment_sum(pts * w, pid_kept, n_cells + 1), jax_segment_sum(w, pid_kept, n_cells + 1)[:, 0]

    return jax.vmap(one)(pts, pid)


def jax_pillar_sums(pts_s: np.ndarray, pid_s: np.ndarray, cap: int, n_cells: int):
    """The sums and counts of JAX's `assign_pillars`
    (pixelspointspolygons_tpu/ops/voxelize.py:74-82), mapped over the batch
    as `voxelize_batch` maps it, at the points' dtype."""
    with jax.enable_x64(pts_s.dtype == np.float64):
        sums, cnts = _jax_sums(jnp.asarray(pts_s), jnp.asarray(pid_s), cap, n_cells)
        return np.asarray(sums), np.asarray(cnts)


LAYOUTS = ("long_run", "run_lengths", "empty_pillars", "all_padding", "cap_above_n", "grid_5x7")


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("cap", CAPS)
@pytest.mark.parametrize("layout", LAYOUTS)
def test_pillar_sums_equal_jax_on_kernel_layouts(layout, cap, dtype):
    """Bit for bit against JAX's CPU scatter-add on every layout the kernel
    treats in its own way: runs over many chunks, runs of cap and chunk
    size +-1, empty pillars at the ends and between, a sample of padding
    only, a cap above N, a grid that leaves the kernel's pass short."""
    pts, pid, n_cells = small_layouts(dtype)[layout]
    sums, counts = voxelize.pillar_sums(torch.from_numpy(pts), torch.from_numpy(pid), cap, n_cells)
    want_sums, want_counts = jax_pillar_sums(pts, pid, cap, n_cells)
    assert sums.dtype == torch.from_numpy(pts).dtype and want_sums.dtype == dtype
    np.testing.assert_array_equal(bits(sums), want_sums.view(bits(sums).dtype))
    np.testing.assert_array_equal(counts.numpy(), want_counts.astype(np.int32))
    runs = np.stack([np.bincount(p, minlength=n_cells + 1)[:n_cells] for p in pid])
    np.testing.assert_array_equal(counts.numpy()[:, :n_cells], np.minimum(runs, cap))
    assert int(counts[:, n_cells].abs().sum()) == 0 and float(sums[:, n_cells].abs().sum()) == 0.0


def test_kernel_layouts_hold_their_edge_cases():
    """The layouts hold what they are named for (so the tests over them
    test it): a run over several chunks and cap 512, every edge length,
    empty pillars at both ends and between, a padding-only sample, N under
    caps 64 and 512, a grid of 35 pillars."""
    lay = small_layouts()
    runs = {k: np.stack([np.bincount(p, minlength=n + 1)[:n] for p in pid]) for k, (_, pid, n) in lay.items()}
    assert runs["long_run"].max() >= 600
    assert runs["long_run"].max() > max(max(CAPS), 2 * CHUNK_POINTS, TILE_ROWS + AHEAD_ROWS)
    assert set(EDGE_RUNS) <= set(runs["run_lengths"].ravel().tolist())
    assert {c + d for c in (*CAPS, CHUNK_POINTS, 2 * CHUNK_POINTS) for d in (-1, 0, 1)} <= set(EDGE_RUNS)
    empty = runs["empty_pillars"][0]
    assert empty[0] == empty[-1] == 0 and (empty[1:-1] == 0).any() and (empty > 0).sum() >= 2
    assert (runs["all_padding"][1] == 0).all() and runs["all_padding"][[0, 2]].sum() > 0
    assert lay["cap_above_n"][1].shape[1] < 64 and runs["cap_above_n"].max() > 4
    assert lay["grid_5x7"][2] == 35
    for pts, pid, n_cells in lay.values():
        assert (np.diff(pid, axis=1) >= 0).all() and pid.max() == n_cells
