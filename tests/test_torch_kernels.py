"""The port's hand-written CUDA kernels against their plain PyTorch versions
on the card (the AFM, the voxelizer's pillar sums and the PillarFeatureNet's
ordered backward), and one train step of each family repeating its bits
under the entry points' deterministic set-up. This file imports
neither JAX nor the JAX package, so it runs where only the port is
installed:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_kernels.py

Without a card every test here skips: a CUDA kernel has no CPU mode.
"""

import numpy as np
import pytest
import torch

from pixelspointspolygons_torch.ops.afm import (
    afm,
    afm_cuda,
    division_mismatches,
    division_operands,
    kernel_config,
)
from pixelspointspolygons_torch.ops.pillar_layouts import (
    AHEAD_ROWS,
    CAPS,
    CHUNK_POINTS,
    TILE_ROWS,
    dense_layout,
    large_layout,
    run_layouts,
    small_layouts,
)
from pixelspointspolygons_torch.ops.segment import rank_in_run
from pixelspointspolygons_torch.ops.voxelize import pillar_sums, pillar_sums_cuda, sort_by_pillar, sums_kernel_config


@pytest.fixture()
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the port's kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _afm_inputs(seed, B, L, H, W):
    rng = np.random.RandomState(seed)
    lines = rng.uniform(0, max(H, W), (B, L, 4)).astype(np.float32)
    lines[:, ::3] = np.round(lines[:, ::3])  # endpoints on the pixel grid
    lines[:, 1::5, 2:] = lines[:, 1::5, :2]  # zero-length segments
    valid = rng.rand(B, L) < 0.7
    valid[-1] = False  # a sample with no valid segment
    return lines, valid


@pytest.mark.cuda
@pytest.mark.parametrize(
    "B,L,H,W",
    [
        (16, 256, 224, 224),  # the HiSup main path
        (3, 37, 21, 50),  # ragged last block, L not a multiple of a warp
        (2, 1, 7, 300),
        (2, 2040, 40, 24),  # staged in several chunks, the last one ragged
        (2, 4096, 40, 24),  # staged in whole chunks
        (1, 3000, 224, 224),  # a ragged last chunk at the HiSup resolution
    ],
)
def test_afm_kernel_matches_plain(cuda_device, B, L, H, W):
    """Labels exact (the same IEEE operations in the same order, compiled
    with --fmad=false); map atol 1e-5 (the kernel's logf and torch's log may
    differ by an ulp, and |map| <= 14)."""
    lines, valid = _afm_inputs(5, B, L, H, W)
    lt, vt = torch.from_numpy(lines).to(cuda_device), torch.from_numpy(valid).to(cuda_device)
    before = afm_cuda.launches
    got_map, got_lab = afm_cuda(lt, vt, H, W)
    want_map, want_lab = afm(lt, vt, H, W)
    torch.cuda.synchronize()
    assert afm_cuda.launches == before + 1
    assert got_map.shape == (B, 2, H, W) and got_lab.shape == (B, H, W)
    assert torch.equal(got_lab, want_lab)
    assert float((got_map - want_map).abs().max()) <= 1e-5
    assert float(got_map[-1].abs().sum()) == 0 and int(got_lab[-1].abs().sum()) == 0


@pytest.mark.cuda
def test_afm_kernel_refuses_what_it_cannot_take(cuda_device):
    lines, valid = _afm_inputs(0, 2, 8, 16, 16)
    lt, vt = torch.from_numpy(lines).to(cuda_device), torch.from_numpy(valid).to(cuda_device)
    before = afm_cuda.launches
    many, many_valid = (torch.from_numpy(x).to(cuda_device) for x in _afm_inputs(1, 1, 2041, 8, 8))
    got_map, got_lab = afm_cuda(many, many_valid, 8, 8)  # any number of segments is taken
    want_map, want_lab = afm(many, many_valid, 8, 8)
    assert torch.equal(got_lab, want_lab) and float((got_map - want_map).abs().max()) <= 1e-5
    assert afm_cuda.launches == before + 1
    before = afm_cuda.launches
    with pytest.raises(ValueError, match="float32"):
        afm_cuda(lt.double(), vt, 16, 16)
    with pytest.raises(ValueError, match="bool"):
        afm_cuda(lt, vt.float(), 16, 16)
    with pytest.raises(ValueError, match="contiguous"):
        afm_cuda(lt.transpose(0, 1).contiguous().transpose(0, 1), vt, 16, 16)
    with pytest.raises(ValueError, match="same device"):
        afm_cuda(lt, vt.cpu(), 16, 16)
    assert afm_cuda.launches == before


@pytest.mark.cuda
def test_afm_kernel_first_minimum_across_chunks(cuda_device):
    """Segments of equal distance in different chunks: the lowest index
    wins, as in argmin, whether the earlier one is in an earlier chunk or
    the same one. Far-away segments pad every chunk."""
    chunk = kernel_config()["chunk"]
    H = W = 32
    L = 3 * chunk + 5
    lines = np.full((1, L, 4), 1000.0, np.float32)
    lines[0, :, 2] = 1001.0
    a, b = [4.0, 4.0, 4.0, 27.0], [27.0, 4.0, 27.0, 27.0]
    for i in (7, chunk + 7, 2 * chunk + 3):  # the same segment three times
        lines[0, i] = a
    for i in (chunk + 9, chunk + 10, 3 * chunk + 1):  # another, in the middle chunk first
        lines[0, i] = b
    valid = np.ones((1, L), bool)
    valid[0, 5] = False
    lt, vt = torch.from_numpy(lines).to(cuda_device), torch.from_numpy(valid).to(cuda_device)
    got_map, got_lab = afm_cuda(lt, vt, H, W)
    want_map, want_lab = afm(lt, vt, H, W)
    torch.cuda.synchronize()
    assert torch.equal(got_lab, want_lab)
    assert float((got_map - want_map).abs().max()) <= 1e-5
    assert set(got_lab.unique().tolist()) == {7, chunk + 9}


@pytest.mark.cuda
def test_kernel_quotient_is_ieee_division(cuda_device):
    """The kernel's division-free quotient against __fdiv_rn, bit for bit,
    over 10^8 random operands (wide exponent ranges and AFM-like ones),
    edge cases, and every operand of the HiSup-shaped case above. Only the
    sign of a zero quotient may differ (num = -0)."""
    g = torch.Generator(device=cuda_device).manual_seed(3)
    n = 25_000_000
    bad = signed_zero = 0
    total = 0
    for _ in range(2):
        # wide: |num| in [2^-40, 2^40), den in [2^-20, 2^40)
        mant = 1 + torch.rand(n, device=cuda_device, generator=g)
        sign = torch.randint(0, 2, (n,), device=cuda_device, generator=g) * 2 - 1
        num = (sign * mant * torch.exp2(torch.randint(-40, 40, (n,), device=cuda_device, generator=g).float())).float()
        den = ((1 + torch.rand(n, device=cuda_device, generator=g))
               * torch.exp2(torch.randint(-20, 40, (n,), device=cuda_device, generator=g).float())).float()
        # AFM-like: pixel coordinates against segments of a 224 px tile
        c = torch.rand(4, n, device=cuda_device, generator=g) * 224
        c[:, ::3] = c[:, ::3].round()
        p = torch.randint(0, 224, (2, n), device=cuda_device, generator=g).float()
        dx, dy = c[2] - c[0], c[3] - c[1]
        num2 = (p[0] - c[0]) * dx + (p[1] - c[1]) * dy
        den2 = (dx.double() * dx.double() + (dy * dy).double()).float() + 1e-6
        for a, d in ((num, den), (num2, den2)):
            nb, nz = division_mismatches(a, d)
            bad, signed_zero, total = bad + nb, signed_zero + nz, total + a.numel()
    edge_num = torch.tensor([0.0, -0.0, 1.0, -1.0, 1e-30, 3.0, 224.0 * 224, -50176.0, 0.1], device=cuda_device)
    edge_den = torch.tensor([1e-6, 1e-6, 1e-6, 3.0, 1e-6, 3.0, 1e-6, 2.0 * 224 * 224 + 1e-6, 0.3], device=cuda_device)
    nb, nz = division_mismatches(edge_num, edge_den)
    assert nz == 1  # -0 / 1e-6
    bad, total = bad + nb, total + edge_num.numel()
    lines, valid = _afm_inputs(5, 16, 256, 224, 224)
    num, den = division_operands(torch.from_numpy(lines).to(cuda_device), torch.from_numpy(valid).to(cuda_device), 224, 224)
    nb, nz = division_mismatches(num, den)
    bad, total = bad + nb, total + num.numel()
    assert total >= 10**8 + num.numel()
    assert bad == 0, f"{bad} of {total} quotients differ from IEEE division"


def _clouds(seed, B=16, N=200_000, size=224.0):
    """Clouds as the LiDAR loader pads them: 15 to 30 % of N points of a
    tile (30,000 to 60,000 of 200,000; a few outside it), zeros after them
    (77.5 % padding at the mean)."""
    rng = np.random.RandomState(seed)
    pts = np.zeros((B, N, 3), np.float32)
    valid = np.zeros((B, N), bool)
    for b in range(B):
        n = rng.randint(N * 3 // 20, N * 3 // 10 + 1)
        pts[b, :n, :2] = rng.uniform(-2, size + 2, (n, 2))
        pts[b, :n, 2] = rng.gamma(2.0, 20.0, n)
        valid[b, :n] = True
    return pts, valid


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("cap", [4, 64, 512])
def test_pillar_sums_kernel_matches_plain(cuda_device, cap, dtype):
    """Bit for bit: the kernel and the plain version add each pillar's
    first min(run, cap) points in sorted order from +0.0; and ten calls in a
    row give the same bits."""
    pts, valid = _clouds(7)
    grid = dict(width=224.0, height=224.0, voxel_x=8.0, voxel_y=8.0)
    pts_s, pid_s, n_cells = sort_by_pillar(torch.from_numpy(pts).to(cuda_device, dtype),
                                           torch.from_numpy(valid).to(cuda_device), **grid)
    before = pillar_sums_cuda.launches
    sums, counts = pillar_sums_cuda(pts_s, pid_s, cap, n_cells)
    want_sums, want_counts = pillar_sums(pts_s, pid_s, cap, n_cells)
    torch.cuda.synchronize()
    assert pillar_sums_cuda.launches == before + 1
    assert sums.shape == (16, n_cells + 1, 3) and sums.dtype == dtype and counts.dtype == torch.int32
    ints = torch.int32 if dtype == torch.float32 else torch.int64
    assert torch.equal(sums.view(ints), want_sums.view(ints))
    assert torch.equal(counts, want_counts)
    longest = int(rank_in_run(pid_s)[pid_s < n_cells].max()) + 1
    assert int(counts.max()) == min(cap, longest) and longest > 64  # pillars over caps 4 and 64
    for _ in range(10):
        again, again_counts = pillar_sums_cuda(pts_s, pid_s, cap, n_cells)
        assert torch.equal(again.view(ints), sums.view(ints)) and torch.equal(again_counts, counts)


@pytest.mark.cuda
def test_pillar_sums_kernel_refuses_what_it_cannot_take(cuda_device):
    pts, valid = _clouds(8, B=2, N=1000)
    pts_s, pid_s, n_cells = sort_by_pillar(torch.from_numpy(pts).to(cuda_device),
                                           torch.from_numpy(valid).to(cuda_device),
                                           width=224.0, height=224.0, voxel_x=8.0, voxel_y=8.0)
    before = pillar_sums_cuda.launches
    with pytest.raises(ValueError, match="bfloat16"):
        pillar_sums_cuda(pts_s.bfloat16(), pid_s, 4, n_cells)
    with pytest.raises(ValueError, match="gradient"):
        pillar_sums_cuda(pts_s.clone().requires_grad_(), pid_s, 4, n_cells)
    with pytest.raises(ValueError, match="contiguous"):
        pillar_sums_cuda(pts_s.transpose(0, 1).contiguous().transpose(0, 1), pid_s, 4, n_cells)
    with pytest.raises(ValueError, match="one device"):
        pillar_sums_cuda(pts_s, pid_s.cpu(), 4, n_cells)
    assert pillar_sums_cuda.launches == before


def _same_bits(a: torch.Tensor, b: torch.Tensor) -> bool:
    ints = {torch.float32: torch.int32, torch.float64: torch.int64}.get(a.dtype, a.dtype)
    return a.dtype == b.dtype and a.shape == b.shape and torch.equal(a.view(ints), b.view(ints))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("layout", ["long_run", "run_lengths", "empty_pillars", "all_padding", "cap_above_n",
                                    "grid_5x7", "large", "dense"])
def test_pillar_sums_kernel_on_layouts(cuda_device, layout, dtype):
    """On every layout the kernel splits its work on (runs over many chunks
    and a tile, runs of cap and chunk size +-1, empty pillars, a sample of
    padding only, a cap above N, a grid that leaves the kernel's pass
    short; "large": all of them at 16 x 200,000 points; "dense": the dense
    encoder's 65,536 pillars), at caps 4, 64 and 512: bit for bit the
    plain version, ten calls in a row the same bits, one launch a call."""
    whole = {"large": large_layout, "dense": dense_layout}
    pts, pid, n_cells = whole[layout](dtype) if layout in whole else small_layouts(dtype)[layout]
    pts_s, pid_s = torch.from_numpy(pts).to(cuda_device), torch.from_numpy(pid).to(cuda_device)
    for cap in CAPS:
        before = pillar_sums_cuda.launches
        sums, counts = pillar_sums_cuda(pts_s, pid_s, cap, n_cells)
        want_sums, want_counts = pillar_sums(pts_s, pid_s, cap, n_cells)
        torch.cuda.synchronize()
        assert pillar_sums_cuda.launches == before + 1
        assert _same_bits(sums, want_sums) and torch.equal(counts, want_counts), f"cap {cap}"
        for _ in range(10):
            again, again_counts = pillar_sums_cuda(pts_s, pid_s, cap, n_cells)
            assert _same_bits(again, sums) and torch.equal(again_counts, counts), f"cap {cap}"
        assert pillar_sums_cuda.launches == before + 11


@pytest.mark.cuda
def test_pillar_sums_kernel_config(cuda_device):
    """The chunk and the tile the layouts are cut around are the kernel's:
    245 points of 3 float32 coordinates, tiles of 2,048 rows and a
    look-ahead of 256 (the long run is longer); 64 pillars a pass (8 warps
    of 8), so a grid of 35 (36 cells) leaves its pass short and one of 63
    (64 cells) fills it."""
    conf = sums_kernel_config()
    assert conf["stage_bytes"] // (3 * 4) == CHUNK_POINTS and conf["max_coords"] == 4
    assert 32 * conf["warps"] * conf["scan"] == TILE_ROWS and 32 * conf["warps"] == AHEAD_ROWS
    pillars = conf["warps"] * conf["per_warp"]
    assert 36 % pillars != 0 and 64 % pillars == 0
    assert conf["blocks_per_sm_float"] >= 1 and conf["blocks_per_sm_double"] >= 1


@pytest.mark.cuda
def test_pillar_sums_kernel_refuses_more_than_4_coordinates(cuda_device):
    """One lane a coordinate for each of a warp's 8 pillars: 5 coordinates
    are refused before a launch; 4 and 1 are taken, bit for bit the plain
    version."""
    pts, pid, n_cells = small_layouts()["grid_5x7"]
    pid_s = torch.from_numpy(pid).to(cuda_device)
    wide = torch.from_numpy(np.tile(pts, (1, 1, 2))[..., :5].copy()).to(cuda_device)  # 5 coordinates
    before = pillar_sums_cuda.launches
    with pytest.raises(ValueError, match="1 to 4 coordinates"):
        pillar_sums_cuda(wide, pid_s, 64, n_cells)
    assert pillar_sums_cuda.launches == before
    for pts_c in (wide[..., :4].contiguous(), wide[..., :1].contiguous()):
        sums, counts = pillar_sums_cuda(pts_c, pid_s, 64, n_cells)
        want_sums, want_counts = pillar_sums(pts_c, pid_s, 64, n_cells)
        torch.cuda.synchronize()
        assert _same_bits(sums, want_sums) and torch.equal(counts, want_counts)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_pillar_sums_kernel_searches_a_run_past_its_look_ahead(cuda_device, dtype):
    """A run longer than a tile and its look-ahead whose cap reaches past
    them (2,500 points at caps 2,400 and 3,000): its end is searched, bit
    for bit the plain version."""
    pts, pid, n_cells = small_layouts(dtype)["long_run"]
    pts_s, pid_s = torch.from_numpy(pts).to(cuda_device), torch.from_numpy(pid).to(cuda_device)
    for cap in (2400, 3000):
        sums, counts = pillar_sums_cuda(pts_s, pid_s, cap, n_cells)
        want_sums, want_counts = pillar_sums(pts_s, pid_s, cap, n_cells)
        torch.cuda.synchronize()
        assert _same_bits(sums, want_sums) and torch.equal(counts, want_counts), f"cap {cap}"
        assert int(counts.max()) == min(cap, 2500)


# --- the PillarFeatureNet's ordered backward (csrc/run_sums.cu) -------------------------


def _pfn_ids(pid: np.ndarray, n_cells: int, cap: int, device) -> torch.Tensor:
    """The PillarFeatureNet's flat ids of a layout at `cap` (`PillarCanvas`)."""
    pid_s = torch.from_numpy(pid).to(device)
    keep = (pid_s < n_cells) & (rank_in_run(pid_s) < cap)
    offsets = torch.arange(pid.shape[0], device=device)[:, None] * (n_cells + 1)
    return (torch.where(keep, pid_s, n_cells) + offsets).reshape(-1)


def _grad_rows(n: int, channels: int, seed: int, dtype, device) -> torch.Tensor:
    r = np.random.RandomState(seed)
    x = r.standard_normal((n, channels)).astype(np.float32) * (10.0 ** r.uniform(-3, 6, (n, 1))).astype(np.float32)
    return torch.from_numpy(x).to(device).to(dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64, torch.bfloat16])
@pytest.mark.parametrize("layout", ["long_run", "run_lengths", "empty_pillars", "all_padding", "cap_above_n",
                                    "grid_5x7", "no_dump", "only_dump", "ring_crossing", "odd_rows", "one_sample",
                                    "dump_first"])
def test_run_sums_kernel_on_layouts(cuda_device, layout, dtype):
    """Bitwise the plain version at 1, 33, 40, 64, 384 and 385 channels
    (rows of 16 bytes, and others that the wrapper pads; one 32-channel
    chunk, several, and a short last one) and caps 4, 64 and 512, dump
    cells included, and the same bits over three calls, on every layout of
    `run_layouts`; and from rows whose start is not 16-byte aligned."""
    from pixelspointspolygons_torch.ops.run_sums import run_sums, run_sums_cuda

    _, pid, n_cells = run_layouts()[layout]
    B = pid.shape[0]
    for cap in CAPS:
        ids = _pfn_ids(pid, n_cells, cap, cuda_device)
        for channels in (1, 33, 40, 64, 384, 385):
            x = _grad_rows(len(ids), channels, cap + channels, dtype, cuda_device)
            before = run_sums_cuda.launches
            got = run_sums_cuda(x, ids, B * (n_cells + 1), B)
            again = [run_sums_cuda(x, ids, B * (n_cells + 1), B) for _ in range(3)]
            want = run_sums(x, ids, B * (n_cells + 1))
            torch.cuda.synchronize()
            assert run_sums_cuda.launches == before + 4
            assert _same_bits(got, want), f"cap {cap}, {channels} channels"
            assert all(_same_bits(got, a) for a in again)
            shifted = torch.empty(x.numel() + 1, dtype=dtype, device=cuda_device)[1:].view_as(x).copy_(x)
            assert _same_bits(run_sums_cuda(shifted, ids, B * (n_cells + 1), B), want), "an unaligned start"


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_run_sums_kernel_at_the_main_paths_size(cuda_device, dtype):
    """16 samples of 200,000 rows (a sample of padding only, a run of
    100,000 points) at cap 64, and the dense encoder's 65,536 pillars at
    cap 4: bitwise the plain version."""
    from pixelspointspolygons_torch.ops.run_sums import run_sums, run_sums_cuda

    for (_, pid, n_cells), cap in ((large_layout(), 64), (dense_layout(), 4)):
        B = pid.shape[0]
        ids = _pfn_ids(pid, n_cells, cap, cuda_device)
        x = _grad_rows(len(ids), 64, cap, dtype, cuda_device)
        got = run_sums_cuda(x, ids, B * (n_cells + 1), B)
        want = run_sums(x, ids, B * (n_cells + 1))
        torch.cuda.synchronize()
        assert _same_bits(got, want), n_cells


@pytest.mark.cuda
def test_run_sums_kernel_refuses_what_it_cannot_take(cuda_device):
    from pixelspointspolygons_torch.ops.run_sums import run_sums_config, run_sums_cuda

    x = torch.zeros(12, 4, device=cuda_device)
    ids = torch.zeros(12, dtype=torch.int64, device=cuda_device)
    before = run_sums_cuda.launches
    for bad in (lambda: run_sums_cuda(x.half(), ids, 6, 2), lambda: run_sums_cuda(x, ids.int(), 6, 2),
                lambda: run_sums_cuda(x, ids, 6, 5), lambda: run_sums_cuda(x.t(), ids[:4], 6, 2),
                lambda: run_sums_cuda(x.cpu(), ids.cpu(), 6, 2)):
        with pytest.raises(ValueError):
            bad()
    assert run_sums_cuda.launches == before
    conf = run_sums_config()
    assert conf["warps"] == 5 and conf["tile_bytes"] == 16384 and conf["stages"] == 6 and conf["group_rows"] == 16
    assert conf["run_tile_rows"] == 1280 and 48 * 1024 < conf["smem_bytes"] <= 113 * 1024
    assert min(conf["blocks_per_sm_float"], conf["blocks_per_sm_double"], conf["blocks_per_sm_bfloat16"]) >= 1


@pytest.fixture()
def deterministic(cuda_device):
    """The entry points' set-up (`device.set_deterministic`), put back after."""
    import os

    from pixelspointspolygons_torch.device import set_deterministic

    found = (torch.are_deterministic_algorithms_enabled(), torch.is_deterministic_algorithms_warn_only_enabled(),
             torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark,
             torch.utils.deterministic.fill_uninitialized_memory)
    set_deterministic(cuda_device)
    yield cuda_device
    torch.use_deterministic_algorithms(found[0], warn_only=found[1])
    torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = found[2], found[3]
    torch.utils.deterministic.fill_uninitialized_memory = found[4]
    assert os.environ["CUBLAS_WORKSPACE_CONFIG"] == ":4096:8"


def _two_steps(make_model, make_step, batch, args=()):
    """Two runs of two train steps from one seed: losses, the first step's
    gradients and the parameters and buffers after."""
    from pixelspointspolygons_torch.train.state import TrainState, make_optimizer, make_scheduler

    runs = []
    for _ in range(2):
        torch.manual_seed(0)
        model = make_model()
        opt = make_optimizer("adamw", model.parameters(), 1e-3)
        state = TrainState(model, opt, make_scheduler(opt, lambda n: 1e-3, 1e-3))
        step = make_step()
        losses, grads = [], None
        for s in range(2):
            losses.append({k: v.detach().clone() for k, v in step(state, batch, *args).items()})
            if s == 0:
                grads = {n: p.grad.detach().clone() for n, p in model.named_parameters() if p.grad is not None}
        torch.cuda.synchronize()
        runs.append((losses, grads, {k: v.detach().clone() for k, v in model.state_dict().items()}))
    return runs


@pytest.mark.cuda
@pytest.mark.parametrize("family", ["hisup_hrnet", "hisup_vit_cnn", "pix2poly_fusion", "ffl"])
def test_train_step_repeats_under_the_flag(deterministic, family):
    """One tiny model of each family (`graft_entry_torch`'s; Pix2Poly's is
    the early-fusion ViT, with the PillarFeatureNet) takes two train steps
    on the card under `torch.use_deterministic_algorithms(True)`: nothing
    raises, and two runs from one seed give the same bits."""
    import graft_entry_torch as g
    from pixelspointspolygons_torch.config import compose
    from pixelspointspolygons_torch.models.ffl.losses import make_ffl_loss
    from pixelspointspolygons_torch.ops.run_sums import run_sums_cuda
    from pixelspointspolygons_torch.train import ffl_step, hisup_step, pix2poly_step

    dev = deterministic
    name = family.split("_")[0]
    batch = {k: torch.from_numpy(v).to(dev) for k, v in g.dryrun_batches(4)[name].items()}
    args = ()
    if name == "hisup":
        enc = family.split("_", 1)[1]
        make_model = lambda: g.tiny_hisup(enc, torch.Generator().manual_seed(3)).to(dev)  # noqa: E731
        make_step = lambda: hisup_step.make_train_step(g.HISUP_WEIGHTS, g.S)  # noqa: E731
    elif name == "pix2poly":
        make_model = lambda: g.tiny_pix2poly(torch.Generator().manual_seed(0)).to(dev)  # noqa: E731
        make_step = lambda: pix2poly_step.make_train_step(1.0, 10.0, 34)  # noqa: E731
    else:
        loss_fn, weights_for_epoch = make_ffl_loss(compose(["experiment=ffl_image", "dataset=synthetic",
                                                            "run_type=debug"]))
        make_model = lambda: g.tiny_ffl(torch.Generator().manual_seed(2)).to(dev)  # noqa: E731
        make_step = lambda: ffl_step.make_train_step(loss_fn)  # noqa: E731
        args = (weights_for_epoch(0),)
    before = run_sums_cuda.launches
    (l0, g0, s0), (l1, g1, s1) = _two_steps(make_model, make_step, batch, args)
    assert (run_sums_cuda.launches > before) == (name == "pix2poly")
    assert all(torch.isfinite(v).all() for step in l0 for v in step.values())
    assert all(_same_bits(a[k], b[k]) for a, b in zip(l0, l1) for k in a)
    assert g0.keys() == g1.keys() and all(_same_bits(g0[k], g1[k]) for k in g0)
    assert all(_same_bits(s0[k], s1[k]) for k in s0)
