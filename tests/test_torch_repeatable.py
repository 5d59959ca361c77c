"""Repeatable training: the ordered forms the port takes on the card,
against autograd's own gradients and the JAX package's, on the CPU.

On the card every entry point turns PyTorch's deterministic algorithms on
(`device.set_deterministic`), and the operations that had no ordered form
there take one: the PillarFeatureNet's gather and segment-max backwards
are ordered run sums (`ops/run_sums.py`, whose plain version runs here),
the bilinear resizes' backward is the products with the interpolation
matrices (`layers.InterpolateByProducts`), HiSup's cross-entropy is JAX's
log_softmax, one-hot and mean.

Tolerances and why:
- the run sums at float64 equal autograd's gradient of `pooled[pillar_id]`
  bit for bit (both add each segment's rows one by one in row order); at
  float32 PyTorch's CPU `index_put_` takes another order past a thousand
  rows, so the two agree within 1e-6 of each segment's sum of |rows| (the
  rows span nine orders of magnitude with either sign). The segment max's
  backward equals autograd's at every dtype (its tie count is a sum of ones
  and zeros, exact in any order);
- the PillarFeatureNet in train mode against `jax.vjp` of JAX's: the
  gradients within 1e-5 of their largest element (flax's BatchNorm takes
  the variance as E[x²] − E[x]², the port's `RowBatchNorm` from
  `torch.var_mean`: tests/test_torch_lidar.py's bound);
- HiSup's loss: value and gradient within 1e-6 (float32 log_softmax);
- the resizes against `jax.vjp` of `hrnet.resize_align_corners` and of
  `jax.image.resize`: float32 within 1e-5 of the gradient's largest
  element (the same products, summed in another order; JAX's
  align-corners weights are rounded in float32, which puts its gradient
  up to 3.7e-6 from float64's, the port's up to 2.3e-6); bfloat16 within
  2 ulps of the largest element (both round each product to bfloat16).
"""

import contextlib
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pixelspointspolygons_tpu.models import hrnet as jhrnet
from pixelspointspolygons_tpu.models import pointpillars as jpp
from pixelspointspolygons_tpu.models.hisup import model as jhisup
from pixelspointspolygons_torch import device
from pixelspointspolygons_torch.models import hrnet, layers
from pixelspointspolygons_torch.models import pointpillars as ppp
from pixelspointspolygons_torch.models.hisup.model import ce_loss_2d
from pixelspointspolygons_torch.ops import pillar_layouts, run_sums, segment
from pixelspointspolygons_torch.ops.voxelize import assign_pillars, cell_offsets
from pixelspointspolygons_torch.utils.bridge import flax_to_state_dict
from test_torch_ffl import _bridged

LAYOUTS = sorted(pillar_layouts.run_layouts())


def _flat_ids(pid: np.ndarray, n_cells: int, cap: int) -> torch.Tensor:
    """The PillarFeatureNet's flat ids of a layout at `cap`, dump cells
    included (as `PillarCanvas` flattens `assign_pillars`'s)."""
    pid = torch.from_numpy(pid)
    keep = (pid < n_cells) & (segment.rank_in_run(pid) < cap)
    return (torch.where(keep, pid, n_cells) + cell_offsets(pid.shape[0], n_cells)).reshape(-1)


def _rows(n: int, channels: int, seed: int, dtype: torch.dtype) -> torch.Tensor:
    r = np.random.RandomState(seed)
    return torch.from_numpy(r.standard_normal((n, channels)) * 10.0 ** r.uniform(-3, 6, (n, 1))).to(dtype)


@pytest.mark.parametrize("cap", [4, 64, 512])
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("layout", LAYOUTS)
def test_run_sums_plain_is_autograds_gather_gradient(layout, dtype, cap):
    """The plain version of the gather's ordered backward against autograd's
    gradient of `pooled[pillar_id]` on each layout of `ops/pillar_layouts.py`
    at 64 channels, dump cells included; and through `gather_rows`."""
    _, pid, n_cells = pillar_layouts.run_layouts()[layout]
    B = pid.shape[0]
    ids = _flat_ids(pid, n_cells, cap)
    S = B * (n_cells + 1)
    g = _rows(len(ids), 64, LAYOUTS.index(layout), dtype)
    table = torch.zeros(S, 64, dtype=dtype, requires_grad=True)
    table[ids].backward(g)
    got = run_sums.run_sums(g, ids, S)
    via = torch.zeros(S, 64, dtype=dtype, requires_grad=True)
    run_sums.gather_rows(via, ids, B).backward(g)
    assert torch.equal(via.grad, got)
    if dtype == torch.float64:
        assert torch.equal(got, table.grad)
    else:
        scale = torch.zeros(S, 64, dtype=torch.float64).index_add_(0, ids, g.double().abs())
        assert ((got.double() - table.grad.double()).abs() <= 1e-6 * scale).all()
    dump = torch.arange(B) * (n_cells + 1) + n_cells
    assert (got[dump] != 0).any() or not (ids[:, None] == dump).any()


def test_run_layouts_hold_their_edge_cases():
    """The layouts the run sums' kernel splits its work on hold what they
    are named for, at every cap, flattened as the PillarFeatureNet flattens
    them: every id but the dump cell's one contiguous run; a sample without
    a dump row, one of dump rows only, one whose dump rows come first; runs
    and dump stretches across the ring's slots and a run block's part and
    tile; rows per sample no multiple of any of the kernel's tiles; one
    sample."""
    lay = pillar_layouts.run_layouts()
    ring, part, tile = pillar_layouts.RING_ROWS, pillar_layouts.RUN_PART_ROWS, pillar_layouts.RUN_TILE_ROWS
    for cap in (4, 64, 512):
        dumps, crossed = {}, set()
        for name, (_, pid, n_cells) in lay.items():
            ids = _flat_ids(pid, n_cells, cap).reshape(pid.shape).numpy() % (n_cells + 1)
            dumps[name] = (ids == n_cells).sum(axis=1)
            for row in ids:
                starts = np.flatnonzero(np.diff(row, prepend=-1) != 0)
                ends = np.append(starts[1:], len(row))
                kept = row[starts] != n_cells
                assert len(set(row[starts[kept]])) == kept.sum(), f"{name}: a pillar in two runs"
                for a, e, k in zip(starts, ends, kept):  # stretches over a boundary of the kernel's tiles
                    crossed |= {(bool(k), step) for step in (*ring, part, tile) if a // step != (e - 1) // step}
        assert dumps["no_dump"][0] == 0 and dumps["only_dump"][0] == lay["only_dump"][1].shape[1]
        _, pid, n_cells = lay["dump_first"]
        assert (pid[:, :300] == n_cells).all() and (pid[:, 300:] < n_cells).any(axis=1).all()
        assert {(k, step) for k in (True, False) for step in ring} <= crossed, cap
        assert (True, part) in crossed and (cap < 512 or (True, tile) in crossed)
    n = lay["odd_rows"][1].shape[1]
    assert all(n % step for step in (16, *ring, part, tile))
    assert lay["one_sample"][1].shape[0] == 1


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32, torch.bfloat16])
def test_run_sums_plain_adds_in_row_order(dtype):
    """Against a loop that adds each row into its segment in row order,
    rounding each add to the dtype; ids in any order, empty segments 0."""
    r = np.random.RandomState(3)
    ids = torch.from_numpy(r.randint(0, 9, 400))
    ids[ids == 4] = 5  # segment 4 empty
    x = _rows(400, 5, 4, dtype)
    want = torch.zeros(10, 5, dtype=dtype)
    for i in range(400):
        want[ids[i]] = want[ids[i]] + x[i]
    assert torch.equal(run_sums.run_sums(x, ids, 10), want)


def test_run_sums_refuses_what_it_cannot_take():
    x, ids = torch.zeros(4, 2), torch.zeros(4, dtype=torch.int64)
    with pytest.raises(ValueError):
        run_sums.run_sums(x.half(), ids, 1)
    with pytest.raises(ValueError):
        run_sums.run_sums(x, ids.int(), 1)
    with pytest.raises(ValueError):
        run_sums.run_sums_cuda(x, ids, 1, 1)  # a CPU tensor


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32, torch.bfloat16])
def test_segment_max_rows_is_autograds(dtype):
    """`segment_max_rows` against `scatter_reduce`'s own autograd, values and
    gradient, with ties (zeros after ReLU) and empty segments."""
    _, pid, n_cells = pillar_layouts.small_layouts()["grid_5x7"]
    ids = _flat_ids(pid, n_cells, 64)
    S = pid.shape[0] * (n_cells + 1)
    r = np.random.RandomState(5)
    x = torch.from_numpy(r.standard_normal((len(ids), 16))).to(dtype)
    x[torch.from_numpy(r.rand(len(ids)) < 0.5)] = 0
    g = torch.from_numpy(r.standard_normal((S, 16))).to(dtype)
    a, b = x.clone().requires_grad_(), x.clone().requires_grad_()
    want = segment.segment_max(a, ids, S)
    got = run_sums.segment_max_rows(b, ids, S, pid.shape[0])
    want.backward(g)
    got.backward(g)
    assert torch.equal(got, want) and torch.equal(b.grad, a.grad)


def test_pfn_gradient_matches_jax_vjp():
    """The PillarFeatureNet (8 → 16 → 24) in train mode on two voxelized
    clouds, flattened as `PillarCanvas` does: the gradient of every
    parameter and of the features against `jax.vjp` of JAX's module."""
    r = np.random.RandomState(6)
    B, N, S = 2, 600, 32
    pts = r.uniform(-2, S + 2, (B, N, 3)).astype(np.float32)
    valid = r.rand(B, N) < 0.85
    a = assign_pillars(torch.from_numpy(pts), torch.from_numpy(valid), width=float(S), height=float(S),
                       voxel_x=8.0, voxel_y=8.0, max_points_per_voxel=4)
    flat = (a.pillar_id + cell_offsets(B, a.n_cells)).reshape(-1)
    feats, keep, n_seg = a.features.reshape(B * N, -1), a.keep.reshape(-1), B * (a.n_cells + 1)
    jm = jpp.PillarFeatureNet(feat_channels=(16, 24))
    shapes = jax.eval_shape(lambda k, f, i, kp: jm.init(k, f, i, kp, n_seg), jax.random.PRNGKey(0),
                            jnp.asarray(feats.numpy()), jnp.asarray(flat.numpy()), jnp.asarray(keep.numpy()))

    def draw(path, leaf):
        name = str(getattr(path[-1], "key", path[-1]))
        if name == "kernel":
            return (r.normal(size=leaf.shape) / np.sqrt(leaf.shape[0])).astype(np.float32)
        return r.uniform(0.5, 1.5, leaf.shape).astype(np.float32) if name in ("scale", "var") else (
            0.1 * r.normal(size=leaf.shape)).astype(np.float32)

    variables = jax.tree_util.tree_map_with_path(draw, shapes)
    w = r.normal(size=(n_seg, 24)).astype(np.float32)

    def forward(params, f):
        out, _ = jm.apply({"params": params, "batch_stats": variables["batch_stats"]}, f, jnp.asarray(flat.numpy()),
                          jnp.asarray(keep.numpy()), n_seg, train=True, mutable=["batch_stats"])
        return out

    want, vjp = jax.vjp(jax.jit(forward), variables["params"], jnp.asarray(feats.numpy()))
    jgrads, jfeats = vjp(jnp.asarray(w))
    port = _bridged(ppp.PillarFeatureNet((16, 24)), variables).train()
    f = feats.clone().requires_grad_()
    got = port(f, flat, keep, n_seg, B)
    (got * torch.from_numpy(w)).sum().backward()
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), rtol=0, atol=2e-5)
    want_grads = flax_to_state_dict(jax.device_get(jgrads))
    for name, p in port.named_parameters():
        g = want_grads[name].numpy()
        np.testing.assert_allclose(p.grad.numpy(), g, rtol=0, atol=1e-5 * np.abs(g).max(), err_msg=name)
    jf = np.asarray(jfeats)
    np.testing.assert_allclose(f.grad.numpy(), jf, rtol=0, atol=1e-5 * np.abs(jf).max())


def test_hisup_ce_loss_matches_jax():
    r = np.random.RandomState(7)
    logits = (3 * r.standard_normal((2, 2, 24, 24))).astype(np.float32)
    labels = r.randint(0, 2, (2, 24, 24))
    want, jgrad = jax.value_and_grad(jhisup.ce_loss_2d)(jnp.asarray(logits), jnp.asarray(labels))
    x = torch.from_numpy(logits).requires_grad_()
    got = ce_loss_2d(x, torch.from_numpy(labels))
    got.backward()
    assert abs(got.item() - float(want)) <= 1e-6
    np.testing.assert_allclose(x.grad.numpy(), np.asarray(jgrad), rtol=0, atol=1e-6)


RESIZES = [(7, 56), (28, 224), (56, 224)]


def _bf16_ulp(x: np.ndarray) -> float:
    return float(2.0 ** (np.floor(np.log2(np.abs(x).max())) - 7))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("n_in,n_out", RESIZES)
@pytest.mark.parametrize("kind", ["align_corners", "half_pixel"])
def test_resize_gradient_matches_jax_vjp(kind, n_in, n_out, dtype):
    """The gradient of HRNet's align-corners resize and of
    `layers.resize_bilinear` (NCHW) against `jax.vjp` of JAX's (NHWC)."""
    r = np.random.RandomState(n_in + n_out)
    x = r.standard_normal((2, 3, n_in, n_in)).astype(np.float32)
    g = r.standard_normal((2, 3, n_out, n_out)).astype(np.float32)
    jdt = jnp.dtype(dtype)
    if kind == "align_corners":
        fn = jax.jit(lambda t: jhrnet.resize_align_corners(t, (n_out, n_out)))
    else:
        fn = jax.jit(lambda t: jax.image.resize(t, (2, n_out, n_out, 3), "bilinear"))
    _, vjp = jax.vjp(fn, jnp.asarray(x.transpose(0, 2, 3, 1)).astype(jdt))
    (want,) = vjp(jnp.asarray(g.transpose(0, 2, 3, 1)).astype(jdt))
    want = np.asarray(want.astype(jnp.float32)).transpose(0, 3, 1, 2)
    tdt = getattr(torch, dtype)
    t = torch.from_numpy(x).to(tdt).requires_grad_()
    y = hrnet.resize_align_corners(t, (n_out, n_out)) if kind == "align_corners" else \
        layers.resize_bilinear(t, n_out)
    y.backward(torch.from_numpy(g).to(tdt))
    got = t.grad.float().numpy()
    tol = 1e-5 * np.abs(want).max() if dtype == "float32" else 2 * _bf16_ulp(want)
    np.testing.assert_allclose(got, want, rtol=0, atol=tol)


def _flags() -> tuple:
    return (torch.are_deterministic_algorithms_enabled(), torch.is_deterministic_algorithms_warn_only_enabled(),
            torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark,
            os.environ.get("CUBLAS_WORKSPACE_CONFIG"), torch.utils.deterministic.fill_uninitialized_memory)


@contextlib.contextmanager
def kept_flags():
    """The process's flags and cuBLAS setting, put back after the block:
    they are global to the process, and a worker runs many test files."""
    found = _flags()
    try:
        yield found
    finally:
        torch.use_deterministic_algorithms(found[0], warn_only=found[1])
        torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = found[2], found[3]
        torch.utils.deterministic.fill_uninitialized_memory = found[5]
        if found[4] is None:
            os.environ.pop("CUBLAS_WORKSPACE_CONFIG", None)
        else:
            os.environ["CUBLAS_WORKSPACE_CONFIG"] = found[4]


def test_set_deterministic_on_the_card_and_not_on_the_cpu():
    """For a CUDA device (no card is needed to set the flags): deterministic
    algorithms that raise (not warn), cuDNN deterministic without
    benchmarking, cuBLAS's fixed workspace, no NaN fill of new tensors; for
    the CPU nothing changes; and the test leaves the process as it found
    it."""
    with kept_flags() as found:
        device.set_deterministic("cpu")
        assert _flags() == found
        device.set_deterministic(torch.device("cuda"))
        assert _flags() == (True, False, True, False, ":4096:8", False)
    assert _flags() == found
